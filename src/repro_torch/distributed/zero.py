"""ZeRO-sharded DSM global step (``DSMConfig.zero_sharded``), ported from the
reference's ``distributed/zero.py``.

The replicated global step keeps full copies of x0 and m on every rank and
repeats the same update everywhere.  Here each of the R ranks keeps only
its contiguous shard of x0 and m, and the global step of an outer round is

    scatter of the worker iterates -> worker mean of the shard
        -> shard-local sign-momentum update (the DSM kernel) -> all-gather(x_{t+1,0})

Shards are contiguous ranges of the flat ``(N,)`` buffer; every start is a
multiple of 128 elements (the reference's lane-aligned slab rows), so each
shard's pointers stay 16-byte aligned for the kernel, and the last shard is
the shorter one.

A mixed-dtype model (``repro_torch.groups``) keeps one buffer per dtype
group, and every function here takes a tensor or such a Groups: each group
is sharded, scattered, updated and gathered on its own, in the layout's
group order, in its own dtype, as the reference works leaf by leaf.  A group
too small to give every rank a shard of whole rows is kept whole on every
rank (:func:`whole`) and takes the replicated global step.

The reference warns (``zero.py:16-26``) that a ring reduce-scatter fixes a
summation order different from the replicated mean's, and ``sign()``
amplifies the few-ulp difference in x_tau by 1/gamma into visible
divergence.  So no rank sums partial means: each worker's column chunk moves
whole to the chunk's owner, which takes the same f32 mean over the W
workers, in worker order, that the dense path takes over all columns.  The
scattered mean is then bit-equal to the dense one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.distributed import comm
from repro_torch.groups import Groups, each, parts
from repro_torch.kernels.dsm_update import dsm_update
from repro_torch.models.convert import state_fields
from repro_torch.obs import metrics as OM

F32 = torch.float32
LANES = 128


def num_shards(topo) -> int:
    """R = worker * zero: the shard count of the global buffers."""
    return topo.world


def chunk_size(n: int, shards: int) -> int:
    """Elements per shard: the ``ceil(n / 128)`` rows of 128 split evenly
    over the shards, rounded up (the reference's ``_to_slab`` rows)."""
    rows = -(-n // LANES)
    return -(-rows // shards) * LANES


def whole(n: int, shards: int) -> bool:
    """The tiny-group rule: a group of ``n`` elements is kept whole on every
    rank when its 128-element rows cannot give each of the ``shards`` ranks
    a non-empty shard: fewer rows than ranks (the one-row f32 group of a
    bf16 recurrentgemma or mamba2 SMOKE), or a split that leaves the last
    rank nothing (5 rows on 4 ranks), as the reference's ``param_pspecs``
    leaves a leaf with no divisible dim replicated.  Such a group takes the
    replicated global step on every rank: the worker mean of
    :func:`replicated_worker_mean`, then one DSM launch over the group."""
    return (shards - 1) * chunk_size(n, shards) >= n


def shard_bounds(n: int, shards: int) -> list:
    """``[(start, stop)]`` of every shard of an ``(n,)`` buffer, in rank
    order; every shard is non-empty, so a group that :func:`whole` keeps
    whole raises."""
    if shards > 1 and whole(n, shards):
        raise ValueError(f"{n} elements are too few for {shards} shards of "
                         f"{LANES}-element rows")
    c = chunk_size(n, shards)
    return [(r * c, min((r + 1) * c, n)) for r in range(shards)]


def my_bounds(n: int, topo) -> tuple:
    """This rank's ``(start, stop)`` in a group of ``n`` elements: its shard,
    or ``(0, n)`` for a group kept :func:`whole`."""
    shards = num_shards(topo)
    return (0, n) if whole(n, shards) else shard_bounds(n, shards)[topo.rank]


def shard_dsm_state(state, topo, global_sharded: bool = True):
    """The rank keeps only its shard of each group of x0 and m (a group kept
    whole stays whole) with ``global_sharded``; else they stay whole (the
    device-parallel local phase with a replicated global step).  The state
    already holds only the rank's worker rows.  On an FSDP rank (``topo``
    its worker peers, ``Topology.dp``) whole is its whole zero block of
    every model block: with ``global_sharded`` it keeps that block's chunk
    over the peers (x0 and m over ``(worker, zero)``), without it every
    peer holds the same whole block (over ``("zero",)`` only, the reference
    dry-run's ``--no-zero-global-buffers``)."""
    if not global_sharded:
        return state

    def mine(t):
        a, b = my_bounds(t.numel(), topo)
        return t[a:b].clone()

    return dataclasses.replace(state, x0=each(mine, state.x0), m=each(mine, state.m))


# ---------------------------------------------------------------------------
# The outer round's global step, group by group
# ---------------------------------------------------------------------------

def _chunk_mean(rows: torch.Tensor, topo, weights) -> tuple:
    """``(x, chunk)``: the worker mean of the column chunk this rank owns of
    one group's ``(W_local, n)`` rows, zero-padded past n, and the chunk
    size.  The dense path's function on the ``(W, chunk)`` columns."""
    from repro_torch.core.dsm import masked_worker_mean, worker_mean

    c = chunk_size(rows.shape[1], num_shards(topo))
    cols = comm.scatter_rows(rows, topo, c)
    return (worker_mean(cols) if weights is None else masked_worker_mean(cols, weights)), c


def _replicated_mean(rows: torch.Tensor, topo, weights) -> torch.Tensor:
    x, c = _chunk_mean(rows, topo, weights)
    return comm.all_gather_shards(x, topo, c, rows.shape[1])


def _scattered_mean(rows: torch.Tensor, topo, weights) -> torch.Tensor:
    n = rows.shape[1]
    if whole(n, num_shards(topo)):
        return _replicated_mean(rows, topo, weights)
    x, _ = _chunk_mean(rows, topo, weights)
    a, b = my_bounds(n, topo)
    return x[: b - a]


def scattered_worker_mean(params_local, topo, weights: Optional[torch.Tensor] = None):
    """x_tau = mean_i x^{(i)}_{t,tau} on this rank's shard of each group:
    the reduce-scatter of the outer step (reference ``:137-157``); the whole
    group's mean for a group kept :func:`whole`.

    ``params_local``: the rank's ``(W_local, N)`` rows, a tensor or Groups.
    ``weights`` (optional ``(W,)`` f32, every worker's): the survivor-aware
    masked mean.  Both are the dense path's functions on the ``(W, chunk)``
    columns that the rank owns, so each shard equals the dense mean's slice
    bit for bit."""
    return each(lambda p: _scattered_mean(p, topo, weights), params_local)


def gather_shards(t, topo, numels):
    """Each whole ``(n,)`` group from every rank's shard of it (line 11's
    all-gather of x_{t+1,0}, one call per sharded group); a group held whole
    is returned as it is.  ``numels``: each group's element count
    (``FlatLayout.group_numels``)."""
    R = num_shards(topo)

    def gather(x, n):
        return x if x.numel() == n else comm.all_gather_shards(x, topo, chunk_size(n, R), n)

    if isinstance(t, Groups):
        return Groups(gather(x, n) for x, n in zip(t, numels, strict=True))
    (n,) = numels
    return gather(t, n)


def replicated_worker_mean(params_local, topo, weights: Optional[torch.Tensor] = None):
    """The whole ``(N,)`` worker mean of each group on every rank (a scatter
    and an all-gather per group: the replicated global step under the
    device-parallel local phase), bit-equal to the dense mean."""
    return each(lambda p: _replicated_mean(p, topo, weights), params_local)


def dsm_update_shard(x0_l, m_l, xt_l, gamma, cfg):
    """The fused DSM kernel on one rank's contiguous shard of x0 / m / x_tau
    (reference ``:191-203``), in place, one launch per group (over the whole
    group where it is kept whole): the global step's memory traffic per rank
    is 1/R of the replicated update's."""
    for x, m, xt in zip(parts(x0_l), parts(m_l), parts(xt_l), strict=True):
        dsm_update(x, m, xt, gamma, eta=cfg.global_lr, beta1=cfg.beta1, beta2=cfg.beta2,
                   lam=cfg.weight_decay)
    return x0_l, m_l


def sharded_global_sign_momentum_step(x0_l, m_l, xt_l, gamma, cfg, topo, numels,
                                      rng: Optional[torch.Generator] = None, where=None):
    """Eqs. (6)-(8) on the rank's shards, in place (reference ``:257-292``).

    The reference's version takes the worker iterates and computes the
    scattered mean inside; the port updates x0 / m in place, so the caller
    takes :func:`scattered_worker_mean` first and reads the pre-update shard
    for the metric pack between the two.  The deterministic sign is the DSM
    kernel, one launch per group; the randomized signs
    (``core.dsm.randomized_step``) draw each group's full dense f32
    uniforms from ``rng`` on every rank, in group order as the dense step
    draws them, and take the rank's elements, so the draws do not depend on
    the layout (reference ``:281-283``).  ``where``: those elements' dense
    indices per group (``FlatLayout.dense_index`` of a model or FSDP rank's
    shard); by default the rank's slice of each dense group of ``numels``
    elements."""
    from repro_torch.core.dsm import randomized_step

    if cfg.sign_mode == "sign":
        return dsm_update_shard(x0_l, m_l, xt_l, gamma, cfg)
    if where is None:
        where = tuple((n, slice(*my_bounds(n, topo))) for n in numels)
    return randomized_step(x0_l, m_l, xt_l, gamma, cfg, rng, where)


def stat_sums_less(x0, m, xt, gamma, beta1: float, start: int = 0, drop=()) -> torch.Tensor:
    """``OM.stat_sums`` of one group's buffers (elements ``start`` on of
    the group) less its sums over the ``drop`` ranges (group coordinates):
    the leaves that another rank of a model-parallel group counts."""
    s = OM.stat_sums(x0, m, xt, gamma, beta1)
    for lo, hi in drop:
        a, b = max(lo - start, 0), min(hi - start, x0.numel())
        if a < b:
            s = s - OM.stat_sums(x0[a:b], m[a:b], xt[a:b], gamma, beta1)
    return s


def sharded_stat_sums(x0_l, m_l, xt_l, gamma, beta1: float, topo, numels,
                      drop=None, over=None) -> torch.Tensor:
    """The metric pack's ``(N_STAT_SUMS,)`` sums over the sharded buffers:
    each rank sums each of its group shards and adds the groups in group
    order (a group kept whole on rank 0 only, so that it counts once), then
    ONE all-reduce of the stacked vector (reference ``:306-344``), over
    ``topo`` or ``over`` (an FSDP rank's ``(worker, zero)`` ranks, whose zero
    blocks ``topo``'s shards cut).  ``drop``: per group, ranges left out of
    the sums (:func:`stat_sums_less`)."""
    R = num_shards(topo)
    sums = [stat_sums_less(x, m, xt, gamma, beta1, my_bounds(n, topo)[0], drop[g])
            if drop else OM.stat_sums(x, m, xt, gamma, beta1)
            for g, (x, m, xt, n) in enumerate(zip(parts(x0_l), parts(m_l), parts(xt_l), numels,
                                                  strict=True))
            if topo.rank == 0 or not whole(n, R)]
    total = (functools.reduce(torch.add, sums) if sums else
             torch.zeros(OM.N_STAT_SUMS, dtype=F32, device=parts(x0_l)[0].device))
    return comm.all_reduce(total, topo if over is None else over, "sum")


# ---------------------------------------------------------------------------
# Whole states in the dense layout (checkpoints)
# ---------------------------------------------------------------------------

def map_state(state, fn: Callable, numels=None):
    """A copy of a training state with ``fn`` applied to each of its tensors
    (scratch buffers are kept as they are).  With ``numels`` (each dtype
    group's element count) ``fn(t, n)`` also takes the count of t's group:
    the i-th tensor of a Groups is group i's; a plain tensor is the one
    group's in a one-group layout, else outside the layout (``n`` None)."""
    if numels is None:
        return _map(state, lambda t, n: fn(t), None)
    return _map(state, fn, tuple(numels))


def _map(state, fn: Callable, numels):
    if isinstance(state, Groups) and numels is not None:
        return Groups(fn(t, n) for t, n in zip(state, numels, strict=True))
    if isinstance(state, torch.Tensor):
        return fn(state, numels[0] if numels is not None and len(numels) == 1 else None)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{k: _map(v, fn, numels)
                                             for k, v in state_fields(state)})
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_map(v, fn, numels) for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(_map(v, fn, numels) for v in state)
    return state


def _is_rows(t: torch.Tensor, topo) -> bool:
    return t.dim() == 2 and t.shape[0] != topo.n_workers


def _is_shard(t: torch.Tensor, n: Optional[int]) -> bool:
    return n is not None and t.dim() == 1 and t.numel() != n


def gather_state(state, topo, numels):
    """The state in the dense layout on group rank 0 (every worker's rows,
    every group of x0 / m whole), None on the other ranks; every rank must
    call it.  ``numels``: each dtype group's element count
    (``FlatLayout.group_numels``)."""
    R = num_shards(topo)

    def dense(t, n):
        if _is_rows(t, topo):
            g = comm.gather_to_root(t, topo)
            return None if g is None else g[::topo.zero].reshape(topo.n_workers, -1)
        if _is_shard(t, n):
            send = t.new_zeros(chunk_size(n, R))
            send[:t.numel()] = t
            g = comm.gather_to_root(send, topo)
            return None if g is None else g.reshape(-1)[:n]
        return t

    out = map_state(state, dense, numels)
    return out if topo.rank == 0 else None


def dense_host(state, topo, numels):
    """A copy of a rank's state in the dense layout, with empty host tensors
    of its dtypes: the template that a checkpoint is read into.
    ``numels``: each dtype group's element count."""
    def host(t, n):
        shape = ((topo.n_workers, n) if n is not None and t.dim() == 2
                 else (n,) if n is not None and t.dim() == 1 else tuple(t.shape))
        return torch.empty(shape, dtype=t.dtype)

    return map_state(state, host, numels)


def local_part(dense: torch.Tensor, like: torch.Tensor, topo) -> torch.Tensor:
    """This rank's part of a dense-layout tensor (one group's), shaped as its
    own ``like``: its worker rows, its shard of the group, or the whole
    tensor."""
    if tuple(dense.shape) == tuple(like.shape):
        return dense
    if like.dim() == 2:
        return dense[topo.worker_slice]
    a, b = my_bounds(dense.numel(), topo)
    return dense[a:b]


def load_local_part(state, dense, topo) -> None:
    """Copy this rank's part of ``dense`` (:func:`dense_host`'s form) into
    ``state`` in place, group by group; integer counters are set."""
    for (name, v), (_, d) in zip(state_fields(state), state_fields(dense)):
        if isinstance(v, torch.Tensor):
            v.copy_(local_part(d, v, topo))
        elif isinstance(v, int):
            setattr(state, name, d)
        else:
            load_local_part(v, d, topo)
