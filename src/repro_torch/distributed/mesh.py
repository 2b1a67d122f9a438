"""The rank grids: the reference's pod meshes (``launch/mesh.py``) as grids
of rank ids, and the ``(worker, zero, model)`` grid of a multi-process run.

The reference's production mesh is ``(data, model)`` = (16, 16) chips, or
``(pod, data, model)`` = (2, 16, 16) over two pods; ``training_mesh``
reshapes its ``pod * data`` rows into ``(worker, zero, model)`` and
``serving_mesh`` into ``(data, model)``.  Here a mesh is a
:class:`RankMesh`: a numpy array of rank ids with the same axes and shape,
in the reference's device order (rank ``i`` is its device ``i``).
A serving rank's place in ``(data, model)`` is :func:`serving_topology`.

The reference lays its devices out as ``(worker, zero, model)``: each worker
group ``w`` holds ``W / worker`` of the W workers, replicated over its
``zero`` ranks; each of those is a model-parallel group of ``model`` ranks,
every one holding its block of each leaf by the placement rules
(``distributed/sharding.py``).  The global buffers x0 / m of each model
index are split into ``worker * zero`` contiguous shards.  Here every rank
is one process; rank ``r = (w * Z + z) * M + m`` holds worker group ``w``,
owns shard ``w * Z + z`` of its model index's buffers, and holds model
block ``m`` (the reference's reshape of the rows; with ``model`` = 1 that
is ``r = w * Z + z``, the reference's chunk order,
``distributed/zero.py:225-226``).

FSDP (``fsdp="zero"``, the reference's ``param_pspecs(..., zero=Z)`` on the
worker params and base state) cuts each model block once more over the
rank's **zero group** (the ``zero`` ranks of its worker group and model
index, :attr:`Topology.zp`, ``<name>@zero``): the rank then holds its zero
block of its workers' params, gradients and AdamW moments, and its x0 and m
are its chunk of that block over its **worker peers** (the ``worker`` ranks
with its zero and model index), which the worker mean, the global step and
the re-sync run over (:attr:`Topology.dp`).  That chunk is the default, the
reference dry-run's x0 and m over ``(worker, zero)``.  With the global
buffers not sharded (``DSMConfig.zero_sharded`` off, the reference's
``--no-zero-global-buffers``: x0 and m over ``("zero",)`` only) the rank
holds its whole zero block of x0 and m, every worker peer the same copy, and
the replicated global step runs on it.  A serving rank's FSDP group
(``fsdp="data"``) is its data group (:attr:`Topology.data`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.distributed.comm import CommStats

MODEL_PAR = 16  # chips along the model axis (both meshes)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A grid of rank ids over named axes (the reference's ``Mesh``, with
    rank ids for its devices)."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return RankMesh(np.arange(int(np.prod(shape))).reshape(shape), axes)


def training_mesh(base_mesh: RankMesh, n_workers: int) -> RankMesh:
    """Reshape the production mesh into (worker, zero, model): the paper's
    worker i is one group of model-parallel rows; ``zero`` is the FSDP
    shard inside a worker.  pod x data rows are split into ``n_workers``
    groups of ``zero`` rows each."""
    devices = np.asarray(base_mesh.devices)
    model = devices.shape[-1]
    rows = devices.reshape(-1, model)          # (pod*data, model)
    n_rows = rows.shape[0]
    if n_rows % n_workers != 0:
        raise ValueError(
            f"n_workers={n_workers} does not divide the {n_rows} model-parallel "
            f"groups of the production mesh {tuple(devices.shape)}; pick a "
            f"worker count from the divisors of {n_rows}"
        )
    zero = n_rows // n_workers
    return RankMesh(rows.reshape(n_workers, zero, model), ("worker", "zero", "model"))


def serving_mesh(base_mesh: RankMesh) -> RankMesh:
    """Reshape into (data, model) with pod folded into data."""
    devices = np.asarray(base_mesh.devices)
    model = devices.shape[-1]
    return RankMesh(devices.reshape(-1, model), ("data", "model"))


def mesh_dims(mesh: RankMesh) -> dict:
    return dict(zip(mesh.axis_names, (int(n) for n in mesh.devices.shape)))


@dataclasses.dataclass(frozen=True)
class Topology:
    """One rank's place in the ``(worker, zero, model)`` grid.

    ``group`` spans every rank of the grid.  With ``model`` > 1,
    ``dp_group`` spans the ``worker * zero`` ranks of this rank's model
    index (the worker mean, the global step and the re-sync run over it:
    :attr:`dp`) and ``model_group`` the ``model`` ranks of this rank's
    worker/zero row (the tensor-parallel collectives: :attr:`mp`).

    ``fsdp``: ``""`` (each zero rank holds its worker's blocks whole),
    ``"zero"`` (a training rank's blocks cut over its zero group,
    ``zero_group``, :attr:`zp`; the global step over its worker peers,
    ``peer_group``) or ``"data"`` (a serving rank's blocks cut over its data
    group, :attr:`data`).  A group of one rank is None."""

    n_workers: int          # W, all workers of the run
    worker: int             # worker groups (the reference's "worker" axis)
    zero: int               # ranks per worker group (its "zero" axis)
    rank: int
    group: Any = None       # the torch.distributed process group; None: world of 1
    backend: str = "gloo"
    stats: CommStats = dataclasses.field(default_factory=CommStats, compare=False)
    model: int = 1          # ranks per model-parallel group (its "model" axis)
    dp_group: Any = None
    model_group: Any = None
    axis: str = ""          # "model": the view of the model group (CommStats keys)
    fsdp: str = ""          # "", "zero" (training) or "data" (serving)
    zero_group: Any = None
    peer_group: Any = None

    @property
    def world(self) -> int:
        return self.worker * self.zero * self.model

    @property
    def worker_index(self) -> int:
        return self.rank // (self.zero * self.model)

    @property
    def zero_index(self) -> int:
        return (self.rank // self.model) % self.zero

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def local_workers(self) -> int:
        return self.n_workers // self.worker

    @property
    def worker_slice(self) -> slice:
        """This rank's workers, ``[w * W/worker, (w + 1) * W/worker)``."""
        n = self.local_workers
        return slice(self.worker_index * n, (self.worker_index + 1) * n)

    @property
    def wz(self) -> "Topology":
        """The ``(worker, zero)`` grid of this rank's model index, with
        ``model`` = 1 (the topology itself when ``model`` = 1)."""
        if self.model == 1:
            return self
        dp_world = self.worker * self.zero
        return Topology(self.n_workers, self.worker, self.zero, self.rank // self.model,
                        self.dp_group if dp_world > 1 else None, self.backend, self.stats)

    @property
    def dp(self) -> "Topology":
        """What the worker mean, the ZeRO shards and the global step run
        over: the ``(worker, zero)`` grid of this rank's model index
        (:attr:`wz`), or under ``fsdp="zero"`` its worker peers, one rank per
        worker group (``zero`` = 1)."""
        if self.fsdp != "zero":
            return self.wz
        return Topology(self.n_workers, self.worker, 1, self.worker_index,
                        self.peer_group if self.worker > 1 else None, self.backend,
                        self.stats)

    @property
    def zp(self) -> "Topology":
        """The zero group as a topology of ``zero`` ranks (one worker group,
        one model rank): its collectives count under ``<name>@zero``."""
        return Topology(self.n_workers, 1, self.zero, self.zero_index,
                        self.zero_group if self.zero > 1 else None, self.backend,
                        self.stats, axis="zero")

    @property
    def data(self) -> "Topology":
        """A serving rank's data group (:func:`serving_topology`: the D ranks
        of its model index) as a topology whose collectives count under
        ``<name>@data``."""
        return dataclasses.replace(self.wz, axis="data")

    @property
    def mp(self) -> "Topology":
        """The model group as a topology of ``model`` ranks (one worker
        group, one zero rank): its collectives count under ``<name>@model``."""
        return Topology(self.n_workers, 1, 1, self.model_index,
                        self.model_group if self.model > 1 else None, self.backend,
                        self.stats, model=self.model, axis="model")


def serving_topology(group: Optional[Any] = None, model: int = 1,
                     timed: bool = False, fsdp: bool = False) -> Topology:
    """This process's rank of the reference's ``(data, model)`` serving grid
    (``serving_mesh``) over the ranks of ``group``: rank ``r = d * model +
    m``, D = world / model data rows.  It is a :class:`Topology` whose
    worker axis is the data axis (``worker`` = D, ``zero`` = 1):
    ``model_group`` spans the M ranks of its data row (:attr:`Topology.mp`,
    ``<name>@model``), ``dp_group`` the D ranks of its model index
    (:attr:`Topology.data`, ``<name>@data``); both built once, on every rank,
    in the same order (:func:`topology`).  ``fsdp``: the rank holds its
    data block of every leaf the serving placement cuts over ``data``
    (``fsdp="data"``) and gathers it at use."""
    if group is None:
        return topology(1, None, timed, model)
    import torch.distributed as dist

    world = dist.get_world_size(group)
    if world % model:
        raise ValueError(f"model={model} does not divide the {world} ranks")
    topo = topology(world // model, group, timed, model)
    return dataclasses.replace(topo, fsdp="data") if fsdp else topo


def grid(n_workers: int, world: int, model: int = 1) -> tuple[int, int]:
    """``(worker, zero)`` for ``world`` ranks of which every ``model`` form
    one model-parallel group, by the reference's ``host_training_mesh``
    rules: the worker axis is ``n_workers`` when it divides the
    ``world / model`` rows; one row degrades to worker = 1; anything else
    raises."""
    rows = world // model
    if rows < 1:
        raise ValueError(f"host_training_mesh needs at least model={model} devices, "
                         f"have {world}")
    if world % model != 0:
        raise ValueError(f"model={model} does not divide the {world} ranks")
    if rows % n_workers == 0:
        worker = n_workers
    elif rows == 1:
        worker = 1  # single-row degenerate grid
    else:
        raise ValueError(
            f"n_workers={n_workers} does not divide the host device grid "
            f"({world} devices / model={model} -> {rows} rows); pick "
            f"a worker count from the divisors of {rows}"
        )
    return worker, rows // worker


def topology(n_workers: int, group: Optional[Any] = None, timed: bool = False,
             model: int = 1, fsdp: bool = False) -> Topology:
    """The topology of this process in ``group`` (None: a world of one, the
    reference's degenerate mesh on one device).  ``timed``: its collectives
    record their seconds (see ``comm``).  ``model`` > 1 builds the
    model-group and worker/zero-group subgroups, once, on every rank (each
    rank must call this with the same arguments); ``fsdp`` (``fsdp="zero"``)
    then the zero groups (with ``zero`` > 1) and the worker-peer groups
    (with ``worker`` > 1 and ``zero`` > 1; with ``zero`` = 1 the peers are
    the ``(worker, zero)`` ranks), the same way."""
    if group is None:
        if model != 1:
            raise ValueError("a model axis needs a process group of model ranks or more")
        return Topology(n_workers, 1, 1, 0, stats=CommStats(timed), fsdp="zero" if fsdp else "")
    import torch.distributed as dist

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    worker, zero = grid(n_workers, world, model)
    backend = dist.get_backend(group)
    topo = Topology(n_workers, worker, zero, rank, group, backend, CommStats(timed), model,
                    fsdp="zero" if fsdp else "")
    ranks = dist.get_process_group_ranks(group)

    def subgroups(members):
        """One group per member list, made on every rank in the same order;
        returns the one that holds this rank (None where it is alone)."""
        mine = None
        for m in members:
            g = dist.new_group([ranks[r] for r in m], backend=backend) if len(m) > 1 else None
            if rank in m:
                mine = g
        return mine

    at = [[[(w * zero + z) * model + m for m in range(model)] for z in range(zero)]
          for w in range(worker)]
    if model > 1:
        topo = dataclasses.replace(
            topo, dp_group=subgroups([[at[w][z][m] for w in range(worker) for z in range(zero)]
                                      for m in range(model)]),
            model_group=subgroups([at[w][z] for w in range(worker) for z in range(zero)]))
    if fsdp and zero > 1:
        topo = dataclasses.replace(
            topo, zero_group=subgroups([[at[w][z][m] for z in range(zero)]
                                        for w in range(worker) for m in range(model)]),
            peer_group=subgroups([[at[w][z][m] for w in range(worker)]
                                  for z in range(zero) for m in range(model)])
            if worker > 1 else None)
    elif fsdp:
        topo = dataclasses.replace(topo, peer_group=topo.wz.group)
    return topo
