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
from typing import Callable, Optional

import torch

from repro_torch.distributed import comm
from repro_torch.groups import Groups
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


def shard_bounds(n: int, shards: int) -> list:
    """``[(start, stop)]`` of every shard of an ``(n,)`` buffer, in rank
    order; every shard is non-empty."""
    c = chunk_size(n, shards)
    bounds = [(r * c, min((r + 1) * c, n)) for r in range(shards)]
    if bounds[-1][0] >= n:
        raise ValueError(f"{n} elements are too few for {shards} shards of "
                         f"{LANES}-element rows")
    return bounds


def my_bounds(n: int, topo) -> tuple:
    return shard_bounds(n, num_shards(topo))[topo.rank]


def check_one_group(x0) -> None:
    """The ranks split one flat buffer: a mixed-dtype model's Groups raise."""
    if isinstance(x0, Groups):
        raise NotImplementedError(
            f"a model of {len(x0)} dtype groups runs on the dense path only; the ZeRO-sharded "
            "and device-parallel ranks split one flat buffer (ROADMAP.md)")


def shard_dsm_state(state, topo, global_sharded: bool = True):
    """The rank keeps only its shard of x0 and m (``global_sharded``; else
    they stay whole: the device-parallel local phase with a replicated
    global step).  The state already holds only the rank's worker rows."""
    if not global_sharded:
        return state
    a, b = my_bounds(state.x0.numel(), topo)
    return dataclasses.replace(state, x0=state.x0[a:b].clone(), m=state.m[a:b].clone())


# ---------------------------------------------------------------------------
# The outer round's global step
# ---------------------------------------------------------------------------

def scattered_worker_mean(params_local: torch.Tensor, topo,
                          weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_tau = mean_i x^{(i)}_{t,tau} on this rank's shard: the
    reduce-scatter of the outer step (reference ``:137-157``).

    ``params_local``: the rank's ``(W_local, N)`` rows.  ``weights``
    (optional ``(W,)`` f32, every worker's): the survivor-aware masked mean.
    Both are the dense path's functions on the ``(W, chunk)`` columns that
    the rank owns, so the shard equals the dense mean's slice bit for bit."""
    from repro_torch.core.dsm import masked_worker_mean, worker_mean

    n = params_local.shape[1]
    a, b = my_bounds(n, topo)
    cols = comm.scatter_rows(params_local, topo, chunk_size(n, num_shards(topo)))
    x_tau = worker_mean(cols) if weights is None else masked_worker_mean(cols, weights)
    return x_tau[: b - a]


def gather_shards(t: torch.Tensor, topo, n: int) -> torch.Tensor:
    """The whole ``(n,)`` buffer from every rank's shard ``t`` (line 11's
    all-gather of x_{t+1,0}); ``t`` itself when it is whole."""
    if t.numel() == n:
        return t
    return comm.all_gather_shards(t, topo, chunk_size(n, num_shards(topo)), n)


def replicated_worker_mean(params_local: torch.Tensor, topo,
                           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole ``(N,)`` worker mean on every rank (a reduce-scatter and an
    all-gather: the replicated global step under the device-parallel local
    phase), bit-equal to the dense mean."""
    return gather_shards(scattered_worker_mean(params_local, topo, weights), topo,
                         params_local.shape[1])


def dsm_update_shard(x0_l, m_l, xt_l, gamma, cfg):
    """The fused DSM kernel on one rank's contiguous shard of x0 / m / x_tau
    (reference ``:191-203``), in place: the global step's memory traffic
    per rank is 1/R of the replicated update's."""
    return dsm_update(x0_l, m_l, xt_l, gamma, eta=cfg.global_lr, beta1=cfg.beta1,
                      beta2=cfg.beta2, lam=cfg.weight_decay)


def sharded_global_sign_momentum_step(x0_l, m_l, xt_l, gamma, cfg, topo, n: int,
                                      rng: Optional[torch.Generator] = None):
    """Eqs. (6)-(8) on the rank's shards, in place (reference ``:257-292``).

    The reference's version takes the worker iterates and computes the
    scattered mean inside; the port updates x0 / m in place, so the caller
    takes :func:`scattered_worker_mean` first and reads the pre-update shard
    for the metric pack between the two.  The deterministic sign is the DSM
    kernel; the randomized signs draw the full ``(n,)`` f32 uniforms from
    ``rng`` on every rank and take the shard's slice, so the draws do not
    depend on the layout (reference ``:281-283``)."""
    from repro_torch.core.dsm import global_sign_momentum_step

    if cfg.sign_mode == "sign":
        return dsm_update_shard(x0_l, m_l, xt_l, gamma, cfg)
    a, b = my_bounds(n, topo)
    u = torch.rand((n,), generator=rng, dtype=F32, device=x0_l.device)[a:b]
    return global_sign_momentum_step(x0_l, m_l, xt_l, gamma, cfg, uniform=u)


def sharded_stat_sums(x0_l, m_l, xt_l, gamma, beta1: float, topo) -> torch.Tensor:
    """The metric pack's ``(N_STAT_SUMS,)`` sums over the sharded buffers:
    each rank sums its shard, then ONE all-reduce of the stacked vector
    (reference ``:306-344``)."""
    return comm.all_reduce(OM.stat_sums(x0_l, m_l, xt_l, gamma, beta1), topo, "sum")


# ---------------------------------------------------------------------------
# Whole states in the dense layout (checkpoints)
# ---------------------------------------------------------------------------

def map_state(state, fn: Callable):
    """A copy of a training state with ``fn`` applied to each of its tensors
    (scratch buffers are kept as they are)."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{k: map_state(v, fn) for k, v in state_fields(state)})
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(map_state(v, fn) for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(map_state(v, fn) for v in state)
    return state


def _is_rows(t: torch.Tensor, topo) -> bool:
    return t.dim() == 2 and t.shape[0] != topo.n_workers


def _is_shard(t: torch.Tensor, n: int) -> bool:
    return t.dim() == 1 and t.numel() != n


def gather_state(state, topo, n: int):
    """The state in the dense layout on group rank 0 (every worker's rows,
    whole x0 / m), None on the other ranks; every rank must call it."""
    R = num_shards(topo)

    def dense(t):
        if _is_rows(t, topo):
            g = comm.gather_to_root(t, topo)
            return None if g is None else g[::topo.zero].reshape(topo.n_workers, -1)
        if _is_shard(t, n):
            send = t.new_zeros(chunk_size(n, R))
            send[:t.numel()] = t
            g = comm.gather_to_root(send, topo)
            return None if g is None else g.reshape(-1)[:n]
        return t

    out = map_state(state, dense)
    return out if topo.rank == 0 else None


def dense_host(state, topo, n: int):
    """A copy of a rank's state in the dense layout, with empty host tensors
    of its dtypes: the template that a checkpoint is read into."""
    def host(t):
        shape = ((topo.n_workers, n) if t.dim() == 2 else (n,) if t.dim() == 1
                 else tuple(t.shape))
        return torch.empty(shape, dtype=t.dtype)

    return map_state(state, host)


def local_part(dense: torch.Tensor, like: torch.Tensor, topo) -> torch.Tensor:
    """This rank's part of a dense-layout tensor, shaped as its own ``like``:
    its worker rows, its shard of a flat buffer, or the whole tensor."""
    if tuple(dense.shape) == tuple(like.shape):
        return dense
    if like.dim() == 2:
        return dense[topo.worker_slice]
    a, b = my_bounds(dense.numel(), topo)
    return dense[a:b]


def load_local_part(state, dense, topo) -> None:
    """Copy this rank's part of ``dense`` (:func:`dense_host`'s form) into
    ``state`` in place; integer counters are set."""
    for (name, v), (_, d) in zip(state_fields(state), state_fields(dense)):
        if isinstance(v, torch.Tensor):
            v.copy_(local_part(d, v, topo))
        elif isinstance(v, int):
            setattr(state, name, d)
        else:
            load_local_part(v, d, topo)
