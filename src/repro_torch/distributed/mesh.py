"""The rank grid of a multi-process run: the reference's
``host_training_mesh`` (``launch/mesh.py``) over the ranks of a process
group, with ``model`` = 1.

The reference lays its devices out as ``(worker, zero)``: each worker group
``w`` holds ``W / worker`` of the W workers, replicated over its ``zero``
ranks, and the global buffers x0 / m are split into ``R = worker * zero``
contiguous shards.  Here every rank is one process; rank ``r = w * Z + z``
holds worker group ``w`` and owns shard ``r`` (the reference's chunk order,
``distributed/zero.py:225-226``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.distributed.comm import CommStats


@dataclasses.dataclass(frozen=True)
class Topology:
    """One rank's place in the ``(worker, zero)`` grid."""

    n_workers: int          # W, all workers of the run
    worker: int             # worker groups (the reference's "worker" axis)
    zero: int               # ranks per worker group (its "zero" axis)
    rank: int
    group: Any = None       # the torch.distributed process group; None: world of 1
    backend: str = "gloo"
    stats: CommStats = dataclasses.field(default_factory=CommStats, compare=False)

    @property
    def world(self) -> int:
        return self.worker * self.zero

    @property
    def worker_index(self) -> int:
        return self.rank // self.zero

    @property
    def zero_index(self) -> int:
        return self.rank % self.zero

    @property
    def local_workers(self) -> int:
        return self.n_workers // self.worker

    @property
    def worker_slice(self) -> slice:
        """This rank's workers, ``[w * W/worker, (w + 1) * W/worker)``."""
        n = self.local_workers
        return slice(self.worker_index * n, (self.worker_index + 1) * n)


def grid(n_workers: int, world: int) -> tuple[int, int]:
    """``(worker, zero)`` for ``world`` ranks, by the reference's rules: the
    worker axis is ``n_workers`` when it divides the world; a world of one
    degrades to worker = 1; anything else raises."""
    if world < 1:
        raise ValueError(f"host_training_mesh needs at least model=1 devices, have {world}")
    if world % n_workers == 0:
        worker = n_workers
    elif world == 1:
        worker = 1  # single-rank degenerate grid
    else:
        raise ValueError(
            f"n_workers={n_workers} does not divide the host device grid "
            f"({world} devices / model=1 -> {world} rows); pick "
            f"a worker count from the divisors of {world}"
        )
    return worker, world // worker


def topology(n_workers: int, group: Optional[Any] = None, timed: bool = False) -> Topology:
    """The topology of this process in ``group`` (None: a world of one, the
    reference's degenerate mesh on one device).  ``timed``: its collectives
    record their seconds (see ``comm``)."""
    if group is None:
        return Topology(n_workers, 1, 1, 0, stats=CommStats(timed))
    import torch.distributed as dist

    world, rank = dist.get_world_size(group), dist.get_rank(group)
    worker, zero = grid(n_workers, world)
    return Topology(n_workers, worker, zero, rank, group, dist.get_backend(group),
                    CommStats(timed))
