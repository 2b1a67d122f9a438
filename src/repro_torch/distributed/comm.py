"""Every collective of the multi-process training path, over the explicit
process group of a :class:`~repro_torch.distributed.mesh.Topology`.

The collectives that only move data (the scatter of worker chunks, the
gathers) move raw bytes (``uint8`` views), so every backend takes every
dtype, bf16 included, and no value is rounded on the way.  Chunks are of
equal size; a shorter last shard is padded in the send buffer only.

``gloo`` runs its collectives on host buffers: with the ``gloo`` backend a
CUDA tensor is staged through a host copy every time, before the
collective and never after a failure.  ``nccl`` takes the CUDA tensors as
they are.  Those host copies synchronise the stream by design, so they are
the one place exempt from the sanitizer's ban on host syncs
(``repro_torch.analysis.sanitize.no_implicit_host_sync``): ``_counted``
lifts it for a staged collective only.  With no process group (a world of one) every collective is the
identity.

A mixed-dtype model (``repro_torch.groups``) sends each dtype group
through its own calls of :func:`scatter_rows` and
:func:`all_gather_shards`, in its own dtype: no byte buffer packs the
groups together, as the reference's collectives run leaf by leaf, and a
reinterpret across dtypes would hide a dtype bug.  So a DSM round of a
two-group model makes 2 scatters and 2 all-gathers (under ZeRO: a sharded
group's scatter and its all-gather of x_{t+1,0}; a group kept whole
gathers its mean after its scatter and nothing at line 11; without ZeRO
each group's mean is scattered and gathered), one gather of the losses,
and under ZeRO one all-reduce of the stat sums; a one-group round makes
one scatter and one all-gather.

The tensor-parallel collectives of a model group
(``repro_torch.distributed.tensor_parallel``: :func:`all_reduce` with
``"max"`` too, :func:`all_gather_dim`, :func:`reduce_scatter_dim`) take the
group's view ``Topology.mp`` and count as ``<name>@model``; FSDP's, over a
rank's zero group (``Topology.zp``) or a serving rank's data group
(``Topology.data``), as ``<name>@zero`` / ``<name>@data``.

Each collective adds its calls and bytes sent to ``topo.stats``.  Only a
timed ``CommStats`` (``timed=True``, which ``run_training(...,
time_collectives=True)`` asks for) adds seconds too: host clock, with the
device synchronised before and after each call, syncs the untimed path
never makes.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0
U8 = torch.uint8


@dataclasses.dataclass
class CommStats:
    """Per collective: calls, bytes this rank sent, and with ``timed`` the
    seconds."""

    timed: bool = False
    calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    seconds: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, nbytes: int, seconds: Optional[float]) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0) + nbytes
        if seconds is not None:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def as_dict(self) -> dict:
        return {k: {"calls": self.calls[k], "bytes": self.bytes[k],
                    **({"seconds": self.seconds[k]} if self.timed else {})}
                for k in self.calls}

    def reset(self) -> None:
        """Forget every count (in place: the topology's views share it)."""
        self.calls.clear()
        self.bytes.clear()
        self.seconds.clear()


def scaled_sum(*parts) -> dict:
    """``sum_i n_i * comm_i`` of ``(n_i, comm_i)`` pairs of
    :meth:`CommStats.as_dict` counts (calls and bytes)."""
    out: dict = {}
    for n, stats in parts:
        for k, v in stats.items():
            rec = out.setdefault(k, {"calls": 0, "bytes": 0})
            rec["calls"] += n * v["calls"]
            rec["bytes"] += n * v["bytes"]
    return out


def init_group(backend: str, init_method: str, rank: int, world: int,
               timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the default process group with an explicit timeout (the
    library's 10-30 min default would let one hung collective take a whole
    run's time).  Returns the group."""
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextmanager
def _counted(topo, name: str, t: torch.Tensor, nbytes: int):
    # a model, zero or data group's collectives count apart: "<name>@model"
    axis = getattr(topo, "axis", "")
    name = f"{name}@{axis}" if axis else name
    with _host_staging_allowed(_staged(topo, t)):
        if not topo.stats.timed:
            yield
            topo.stats.add(name, nbytes, None)
            return
        _sync(t)
        t0 = time.perf_counter()
        yield
        _sync(t)
        topo.stats.add(name, nbytes, time.perf_counter() - t0)


@contextmanager
def _host_staging_allowed(staged: bool):
    """gloo's host copies of CUDA tensors pass the sanitizer's sync ban."""
    if not staged:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _staged(topo, t: torch.Tensor) -> bool:
    return topo.backend == "gloo" and t.is_cuda


def _host_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat ``uint8`` view."""
    return t.contiguous().reshape(-1).view(U8)


def _all_gather(topo, name: str, t: torch.Tensor) -> torch.Tensor:
    """``(R, *t.shape)``: every rank's ``t``, in rank order."""
    out = t.new_empty((topo.world, *t.shape))
    send = _bytes(t)
    with _counted(topo, name, t, send.numel()):
        stage = _staged(topo, t)
        host = _host_like(out) if stage else out
        dist.all_gather(list(host.view(topo.world, -1).view(U8).unbind(0)),
                        send.cpu() if stage else send, group=topo.group)
        if stage:
            out.copy_(host)
    return out


def gather_workers(t: torch.Tensor, topo, dim: int = 0) -> torch.Tensor:
    """Every worker group's block of ``t`` concatenated along ``dim`` in
    worker order: the (tau, W_local) losses to (tau, W), the (W_local,)
    finiteness masks to (W,).  One rank of each worker group contributes."""
    if topo.group is None:
        return t
    blocks = _all_gather(topo, "gather_workers", t)[::topo.zero]
    return torch.cat(list(blocks.unbind(0)), dim=dim)


def scatter_rows(rows: torch.Tensor, topo, chunk: int) -> torch.Tensor:
    """The reduce-scatter's data movement: ``rows`` is this rank's
    ``(W_local, N)`` worker rows; returns ``(W, chunk)`` holding column chunk
    ``rank`` of every worker, in worker order (zero-padded past N).

    Rank ``(w, z)`` sends its rows' chunk ``j`` to every rank ``j`` with
    ``j % Z == z``, so each rank receives each worker group's chunk once."""
    n_local, n = rows.shape
    if topo.group is None:
        return rows
    R, Z, z = topo.world, topo.zero, topo.zero_index
    padded = rows.new_zeros(n_local, R * chunk)
    padded[:, :n] = rows
    send = padded.view(n_local, R, chunk).transpose(0, 1)[z::Z].contiguous()
    block = n_local * chunk * rows.element_size()
    splits = [block if j % Z == z else 0 for j in range(R)]
    out = rows.new_empty(topo.worker * n_local, chunk)
    send_b = _bytes(send)
    with _counted(topo, "scatter_rows", rows, send_b.numel()):
        stage = _staged(topo, rows)
        host = _host_like(out) if stage else out
        dist.all_to_all_single(_bytes(host) if stage else out.view(-1).view(U8),
                               send_b.cpu() if stage else send_b,
                               output_split_sizes=splits, input_split_sizes=splits,
                               group=topo.group)
        if stage:
            out.copy_(host)
    return out


def all_gather_shards(shard: torch.Tensor, topo, chunk: int, n: int) -> torch.Tensor:
    """The flat ``(n,)`` buffer from every rank's contiguous shard (rank
    order; each shard padded to ``chunk`` in the send buffer)."""
    if topo.group is None:
        return shard
    send = shard.new_zeros(chunk)
    send[:shard.numel()] = shard
    return _all_gather(topo, "all_gather_shards", send).view(-1)[:n]


def all_reduce(t: torch.Tensor, topo, op: str = "sum") -> torch.Tensor:
    """In place: the elementwise sum (``op="sum"``), minimum (``"min"``) or
    maximum (``"max"``) over the ranks of ``topo``'s group (the model
    group's for :attr:`~repro_torch.distributed.mesh.Topology.mp`)."""
    if topo.group is None:
        return t
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
    with _counted(topo, f"all_reduce_{op}", t, t.numel() * t.element_size()):
        if _staged(topo, t):
            host = t.cpu()
            dist.all_reduce(host, op=red, group=topo.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=red, group=topo.group)
    return t


def all_gather_dim(t: torch.Tensor, topo, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (bytes
    moved as they are, no rounding): a leaf's blocks back to the leaf."""
    if topo.group is None:
        return t
    blocks = _all_gather(topo, "all_gather", t)
    return torch.cat(list(blocks.unbind(0)), dim=dim)


def reduce_scatter_dim(t: torch.Tensor, topo, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``t``, cut into ``world`` equal blocks
    along ``dim``; returns block ``rank`` (each rank sends the whole of
    ``t``).  The sum is in ``t``'s dtype: ``tensor_parallel.gather`` widens
    a bf16 gradient to f32 first and rounds the rank's block once."""
    if topo.group is None:
        return t
    blocks = [b.contiguous() for b in torch.chunk(t, topo.world, dim=dim)]
    out = torch.empty_like(blocks[0])
    with _counted(topo, "reduce_scatter", t, t.numel() * t.element_size()):
        if _staged(topo, t):
            host = _host_like(out)
            dist.reduce_scatter(host, [b.cpu() for b in blocks], group=topo.group)
            out.copy_(host)
        else:
            dist.reduce_scatter(out, blocks, group=topo.group)
    return out


def gather_to_root(t: torch.Tensor, topo) -> Optional[torch.Tensor]:
    """``(R, *t.shape)`` of every rank's ``t`` on group rank 0; None on the
    others."""
    if topo.group is None:
        return t.unsqueeze(0)
    root = topo.rank == 0
    out = t.new_empty((topo.world, *t.shape)) if root else None
    send = _bytes(t)
    with _counted(topo, "gather_to_root", t, send.numel()):
        stage = _staged(topo, t)
        host = (_host_like(out) if stage else out) if root else None
        dist.gather(send.cpu() if stage else send,
                    list(host.view(topo.world, -1).view(U8).unbind(0)) if root else None,
                    dst=dist.get_global_rank(topo.group, 0), group=topo.group)
        if root and stage:
            out.copy_(host)
    return out


def barrier(topo, device) -> None:
    """Every rank waits here for the others (an all-reduce of one element on
    ``device``, which every backend runs)."""
    if topo.group is not None:
        all_reduce(torch.zeros(1, device=device), topo)
