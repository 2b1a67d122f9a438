"""Distributed Sign Momentum with local steps — the paper's Algorithm 1, on
flat ``(W, N)`` buffers.

One outer step t:

  1. every worker i runs tau local steps of the base optimizer (AdamW):
         x^{(i)}_{t,k+1} = x^{(i)}_{t,k} - gamma_t * d^{(i)}_{t,k}
  2. the worker mean  x_{t,tau} = mean_i x^{(i)}_{t,tau}  (f32, cast back)
  3. the global sign-momentum step on Delta_t = (x_{t,0} - x_{t,tau}) / gamma_t
     (eqs. 6-8), then every worker restarts from x_{t+1,0}.

A process runs its workers one after another: a Python loop runs each
worker's forward and backward, and the base optimizer then updates all of
them at once (with AdamW, one launch of the AdamW kernel).  A batch is the
reference's dict of leaves shaped (W, tau, accum, B_micro, ...): ``tokens``
and, for the vlm / encdec families, ``patches`` or ``frames``; every leaf is
indexed alike by worker, local step and microbatch (:func:`take`), as the
reference maps over its batch pytree.  The global step
is the DSM kernel on the card for the deterministic sign; the randomized
signs of eqs. 9/10 (``sign_mode`` ``rand_pm`` / ``rand_zero``) run in plain
PyTorch.

Without a topology one process holds all W workers.  With a
``repro_torch.distributed.mesh.Topology`` (one process per rank) a rank
holds only its own workers, and its local phase runs with zero collectives
(``device_parallel_local``); the worker mean is a scatter of each worker's
column chunks to their owners.  ``zero_sharded`` then keeps only the rank's
shard of x0 and m and runs the DSM kernel on it
(``repro_torch.distributed.zero``); without it every rank runs the
replicated global step on the whole mean.  Both are bit-equal to the dense
path.

A mixed-dtype model (``repro_torch.groups``) keeps one buffer per dtype
group for params, gradients, x0, m and the base-optimizer state: the local
updates, the worker mean and the global step run group by group, one DSM
launch per group per round; ``stat_sums`` adds the groups' sums.  Over a
topology each group is scattered, sharded and gathered on its own, in its
dtype, a group too small to shard kept whole on every rank
(``repro_torch.distributed.zero.whole``), bit-equal to the dense path.

Over a model axis (a topology with ``model`` > 1) each rank holds its
block of every leaf (``repro_torch.distributed.tensor_parallel``): the
local phase runs its workers' steps on its blocks, the model computing over
its model group, and the worker mean, the global step and the re-sync run
over the ``(worker, zero)`` ranks of its model index (``Topology.dp``), the
code above on the block buffers; the stat sums add over the model group.

Under FSDP (``Topology.fsdp == "zero"``) a rank holds its zero block of each
model block (``tensor_parallel.topology_layout``): its workers' params,
gradients and AdamW moments are ``(W_local, N_rank)`` rows of its zero
blocks, and the model gathers each block at use over the zero group.  Where
the reference's ``train_batch_pspecs`` puts ``B_micro`` on ``zero`` the rank
computes its ``B_micro / Z`` rows of each microbatch, its gradients are
reduce-scattered over the zero group and divided by Z after it (the
gradient of the whole microbatch's mean), and a worker's loss is the mean
of its zero ranks' (one all-reduce of the round's losses over the zero
group); else every zero rank computes the whole microbatch and keeps its
slice of the gradient.  x0 and m are the rank's chunk of its zero block
over its worker peers (``Topology.dp``), which the worker mean, the global
step and the re-sync run over; the stat sums add over the ``(worker,
zero)`` ranks of its model index, and a worker's finiteness mask is the
minimum over its zero group.  Without ``zero_sharded`` (x0 and m over
``("zero",)`` only, the reference dry-run's ``--no-zero-global-buffers``)
every peer holds the whole zero block of x0 and m: the worker mean is the
replicated one over the peers, the stat sums add over the zero group and
then the model group, the DSM kernel runs once per group over the whole
block, and nothing is gathered after it.

The outer step takes an optional ``FaultRound`` (``repro_torch.robustness``)
and then makes line 7's mean survivor-aware; ``DSMConfig.mask_nonfinite``
masks non-finite workers without injected faults.

Instances (paper §2 "Algorithm instances"):
  * tau=1, beta1=beta2=beta, lam=0    -> signSGD with momentum (eq. 3)
  * n=1 (W=1)                         -> signed Lookahead (+ decoupled wd)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, ClassVar, Optional

import torch
from torch.profiler import record_function

from repro_torch.core.base_opt import BaseOptimizer
from repro_torch.distributed import comm
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed import zero as Z
from repro_torch.groups import Groups, each, parts
from repro_torch.kernels.dsm_update import dsm_update, dsm_update_plain, sign_like_jnp
from repro_torch.models.convert import FlatLayout
from repro_torch.obs import metrics as OM
from repro_torch.robustness.faults import apply_faults

F32 = torch.float32


# ---------------------------------------------------------------------------
# Randomized sign operators (paper §3.1, eqs. 9/10)
# ---------------------------------------------------------------------------

def _uniform(u: torch.Tensor, rng: Optional[torch.Generator], uniform):
    """U[0, 1) draws of u's shape in f32: ``uniform`` when the caller gives
    them, else drawn from the generator ``rng`` on u's device."""
    if uniform is not None:
        return uniform
    return torch.rand(u.shape, generator=rng, dtype=F32, device=u.device)


def _on(c: float, u: torch.Tensor) -> torch.Tensor:
    # divide by a tensor on the data's device: torch turns division by a
    # host scalar into a product with its reciprocal on the card (filled in
    # there: a copy from the host would synchronise the stream)
    return torch.full((), c, dtype=F32, device=u.device)


def randomized_sign_pm(u: torch.Tensor, rng: Optional[torch.Generator], bound: float,
                       uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. (9): +-sign(u_j), P[sign(u_j)] = 1/2 + |u_j|/(2B).  E[.] = u/B."""
    p_keep = 0.5 + u.abs() / _on(2.0 * bound, u)
    s = sign_like_jnp(u)
    return torch.where(_uniform(u, rng, uniform) < p_keep, s, -s)


def randomized_sign_zero(u: torch.Tensor, rng: Optional[torch.Generator], bound: float,
                         uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. (10): sign(u_j) w.p. |u_j|/B else 0.  E[.] = u/B."""
    keep = _uniform(u, rng, uniform) < u.abs() / _on(bound, u)
    return torch.where(keep, sign_like_jnp(u), torch.zeros_like(u))


RANDOMIZED_SIGNS = {"rand_pm": randomized_sign_pm, "rand_zero": randomized_sign_zero}
SIGN_MODES = ("sign",) + tuple(RANDOMIZED_SIGNS)


def layout_uniforms(rng: Optional[torch.Generator], where, device):
    """The randomized signs' f32 U[0, 1) draws of a rank's elements, one
    group at a time in group order (a generator: a group's draw is made as
    it is taken).  Each is the dense group's whole ``(n,)`` draw from
    ``rng`` on ``device``, what the dense step draws, taken at the rank's
    dense indices ``where`` (``FlatLayout.dense_index``).  So every layout
    draws the same number at the same dense element, and each copy of a
    leaf held whole on several ranks draws alike.  The draw is never cut in
    chunks: on the card, Philox draws in chunks do not join into one draw.
    It holds 4 n bytes while its group's step runs."""
    for n, at in where:
        u = torch.rand((n,), generator=rng, dtype=F32, device=device)
        yield u[at] if isinstance(at, slice) else u.index_select(0, at)


def randomized_step(x0, m, x_tau_mean, gamma, cfg: "DSMConfig",
                    rng: Optional[torch.Generator], where):
    """Eqs. (6)-(8) with ``cfg.sign_mode``'s randomized sign, in place on a
    rank's buffers (tensors or Groups: the dense ones, its blocks, or its
    shard of either), group by group on :func:`layout_uniforms`' draws at
    ``where``; returns (x0, m).  Given the same x_tau, x0, m and generator
    state, every element comes out as the dense step's, bit for bit."""
    draws = layout_uniforms(rng, where, parts(x0)[0].device)
    for x, mm, xt, u in zip(parts(x0), parts(m), parts(x_tau_mean), draws, strict=True):
        global_sign_momentum_step(x, mm, xt, gamma, cfg, uniform=u)
    return x0, m


@dataclasses.dataclass(frozen=True)
class DSMConfig:
    """Hyper-parameters of Algorithm 1 (the reference's fields, less
    ``use_kernel``: the port's deterministic global step is always the DSM
    kernel's wrapper).

    Defaults are the paper's recommended Lion parameters for the global step
    (beta1=0.95, beta2=0.98, lambda=0.1; §4 Implementations).
    """

    tau: int = 12                 # communication interval (local steps)
    global_lr: float = 1.0        # eta
    beta1: float = 0.95           # u_{t+1} interpolation (eq. 6)
    beta2: float = 0.98           # m_{t+1} interpolation (eq. 8)
    weight_decay: float = 0.1     # decoupled lambda (eq. 7)
    sign_mode: str = "sign"       # "sign" | "rand_pm" | "rand_zero"
    sign_bound: float = 1.0       # B for randomized sign (theory uses tau*R)
    zero_sharded: bool = False
    device_parallel_local: bool = False
    mask_nonfinite: bool = False  # survivor-aware mean masks NaN/inf workers

    def __post_init__(self):
        if self.sign_mode not in SIGN_MODES:
            raise ValueError(f"sign_mode must be one of {SIGN_MODES}")
        if not (0.0 <= self.beta1 <= 1.0 and 0.0 <= self.beta2 <= 1.0):
            raise ValueError("momentum coefficients must lie in [0, 1]")
        if self.tau < 1:
            raise ValueError("tau must be >= 1")


@dataclasses.dataclass
class DSMState:
    """Algorithm 1 state; the outer step updates it IN PLACE."""

    params: torch.Tensor      # (W, N) per-worker params, param dtype
    grads: torch.Tensor       # (W, N) gradient buffer, param dtype (scratch)
    x0: torch.Tensor          # (N,) global model x_{t,0}
    m: torch.Tensor           # (N,) global sign momentum m_t, f32
    base_state: object        # per-worker base-optimizer state, (W, N) leaves
    # a mixed-dtype model holds each buffer as Groups, one tensor per group
    # under a topology W is the rank's own workers, and with zero_sharded
    # x0 and m hold the rank's shard
    t: int = 0                # outer step counter
    inner: int = 0            # total local-step counter (AdamW bias correction)

    # buffers that hold nothing between outer steps: not checkpointed, not
    # guarded (the reference's state has no such buffer)
    SCRATCH: ClassVar[tuple] = ("grads",)


def dsm_init(x0, base_opt: BaseOptimizer, n_workers: int, topo=None,
             global_sharded: bool = False) -> DSMState:
    """State from the flat global params ``x0`` (N,) (a tensor, or the
    Groups of a mixed-dtype model): every worker's, or under ``topo`` the
    rank's workers and, with ``global_sharded``, the rank's shard of each
    group of x0 and m (``repro_torch.distributed.zero.shard_dsm_state``)."""
    rows = n_workers if topo is None else topo.local_workers
    params = each(lambda x: x.unsqueeze(0).repeat(rows, 1), x0)
    state = DSMState(
        params=params,
        grads=each(torch.zeros_like, params),
        x0=each(torch.clone, x0),
        m=each(lambda x: torch.zeros_like(x, dtype=torch.float32), x0),
        base_state=base_opt.init(params),
    )
    return state if topo is None else Z.shard_dsm_state(state, topo.dp, global_sharded)


# ---------------------------------------------------------------------------
# Survivor-aware aggregation (reference ``core/dsm.py:116-160``): dropped
# workers are excluded by the announced survivor mask, non-finite
# contributions are detected on the device and masked, and a round with no
# usable contribution leaves x0 / m bit-untouched (skip-round).
# ---------------------------------------------------------------------------

def worker_finite_mask(params_w) -> torch.Tensor:
    """``(W,)`` bool: worker i's contribution is finite everywhere (in
    every group)."""
    ok = [torch.isfinite(p).all(dim=1) for p in parts(params_w)]
    return functools.reduce(torch.logical_and, ok)


def _row_sum(rows: torch.Tensor) -> torch.Tensor:
    """The f32 sum of the W rows of ``(W, N)``: from +0, row after row in
    worker order, as a sequential reduction adds them.  The order is fixed
    whatever N: a reduction kernel over the rows may split them otherwise
    at another N (on the card, a dense (4, 368,640) f32 buffer and a rank's
    (4, 92,160) chunk of it), so the ranks' chunks would not reproduce the
    dense mean bit for bit."""
    acc = torch.zeros(rows.shape[1:], dtype=F32, device=rows.device)
    for row in rows:
        acc.add_(row)
    return acc


def worker_mean(params_w):
    """Line 7's mean of ``(W, N)`` in f32, cast back (as ``jnp.mean`` of
    bf16); group by group."""
    return each(lambda p: (_row_sum(p) / _on(p.shape[0], p)).to(p.dtype), params_w)


def masked_worker_mean(params_w, weights: torch.Tensor):
    """:func:`_masked_mean` group by group."""
    return each(lambda p: _masked_mean(p, weights), params_w)


def _masked_mean(params_w: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted worker mean of ``(W, N)`` in the param dtype, in the
    reference's order: zero-weight workers are zeroed BEFORE the product (NaN
    * 0 is NaN), the product is summed in f32 and rounded (``jnp.sum``
    upcasts bf16), then divided by max(sum of weights, 1) in the param dtype.
    All-zero weights give 0; the caller applies the skip-round."""
    dt = params_w.dtype
    wsum = torch.clamp(weights.to(F32).sum(), min=1.0)
    w = weights.to(dt)[:, None]
    contrib = torch.where(w > 0, params_w, torch.zeros((), dtype=dt, device=params_w.device))
    return _row_sum(w * contrib).to(dt) / wsum.to(dt)


def _contribution_weights(contrib: torch.Tensor, cfg: "DSMConfig", faults,
                          topo=None) -> Optional[torch.Tensor]:
    """(W,) f32 weights: the announced survivors times the finiteness mask,
    or None for the dense path.  Under ``topo`` each rank checks its own
    workers and the masks are gathered to every worker's."""
    weights = None
    if faults is not None:
        weights = faults.survivors.to(F32)
    if cfg.mask_nonfinite or faults is not None:
        finite = worker_finite_mask(contrib).to(F32)
        if topo is not None:
            if topo.model > 1:
                # a worker is finite when every model rank's block of it is
                finite = comm.all_reduce(finite, topo.mp, "min")
            if topo.fsdp == "zero" and topo.zero > 1:
                # and every zero rank's block of that
                finite = comm.all_reduce(finite, topo.zp, "min")
            finite = comm.gather_workers(finite, topo.dp)
        weights = finite if weights is None else weights * finite
    return weights


def global_sign_momentum_step(x0, m, x_tau_mean, gamma, cfg: DSMConfig,
                              rng: Optional[torch.Generator] = None,
                              uniform: Optional[torch.Tensor] = None):
    """Eqs. (6)-(8) in place on the flat buffers; returns (x0, m).

    ``sign_mode="sign"``: the DSM kernel on the card, its plain version on
    the CPU; Groups buffers (and ``uniform``) run group by group, one launch
    each.  With f32 momentum the reference's jnp path and its kernel do
    the same f32 arithmetic in the same order, so this one path stands for
    both.  The randomized signs draw their f32 uniforms over the flat (N,)
    buffer from ``rng`` (or take ``uniform``).
    """
    if isinstance(x0, Groups):
        us = uniform if uniform is not None else (None,) * len(x0)
        for x, mm, xt, u in zip(x0, m, x_tau_mean, us, strict=True):
            global_sign_momentum_step(x, mm, xt, gamma, cfg, rng, u)
        return x0, m
    hp = dict(eta=cfg.global_lr, beta1=cfg.beta1, beta2=cfg.beta2, lam=cfg.weight_decay)
    if cfg.sign_mode == "sign":
        return dsm_update(x0, m, x_tau_mean, gamma, **hp)
    # The configured sign_mode, not a failed launch, picks this path: the
    # kernel computes only the deterministic sign, so the randomized modes
    # run the same eqs. (6)-(8) in plain PyTorch on every device, as the
    # reference routes them past its kernel.
    op = RANDOMIZED_SIGNS[cfg.sign_mode]
    return dsm_update_plain(x0, m, x_tau_mean, gamma, **hp,
                            sign=lambda u: op(u, rng, cfg.sign_bound, uniform))


def take(batch: dict, *index) -> dict:
    """Every leaf of the batch dict indexed alike: ``take(batch, w, a)`` is
    worker w's microbatch a, ``take(batch, slice(None), k)`` every worker's
    local step k."""
    return {name: leaf[index] for name, leaf in batch.items()}


def lead_dims(batch: dict) -> torch.Size:
    """The leading dims every leaf shares, read off the first leaf in
    ``jax.tree.leaves`` order (sorted keys)."""
    return batch[min(batch)].shape


def worker_grads(loss_fn: Callable, layout: FlatLayout, params, grads, batch: dict,
                 losses: torch.Tensor) -> None:
    """Every worker's forward and backward, in place into ``grads[w]`` of the
    ``(W, N)`` buffers (zeroed first): worker w at ``params[w]``, or at the
    one ``(N,)`` params, on its microbatches ``take(batch, w)`` (leaves
    (accum, B_micro, ...)), gradients summed then divided by accum; its
    mean loss into ``losses[w]``.  The buffers are tensors or Groups."""
    for g in parts(grads):
        g.zero_()
    accum, b_micro = lead_dims(batch)[1:3]
    split = TP.zero_split(layout, b_micro)
    rows = TP.zero_rows(layout, b_micro)
    for w in range(parts(grads)[0].shape[0]):
        leaves = layout.autograd_leaves(each(lambda p: p if p.dim() == 1 else p[w], params),
                                        each(lambda g: g[w], grads))
        if layout.zero > 1:
            leaves.zero_mode = "sum" if split else "slice"
        loss_sum = torch.zeros((), dtype=F32, device=losses.device)
        for a in range(accum):
            loss = loss_fn(leaves, take(batch, w, a, rows))
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        if accum > 1:
            for g in parts(grads):
                g[w].div_(accum)
        if split:
            # the zero ranks' gradients of their rows' means, summed by the
            # reduce-scatters: the whole microbatch's mean is their mean
            for g in parts(grads):
                g[w].div_(layout.zero)
        losses[w] = loss_sum / accum


def make_local_phase(loss_fn: Callable, base_opt: BaseOptimizer, layout: FlatLayout):
    """``local_phase(state, batch, gamma) -> losses (tau, W)``: tau local
    steps of every worker the state holds (all W, or a rank's own), in place
    on ``state.params`` / ``state.base_state``, with no collective.

    ``batch``: a dict of leaves (W, tau, accum, B_micro, ...), the state's
    workers' rows.  Each local step runs every worker's forward and backward
    (:func:`worker_grads`), then one base-optimizer update over all of them
    at step index ``state.inner + k``.  On an FSDP rank whose zero ranks
    compute their own rows, the losses are then averaged over the zero group
    (one all-reduce, ``<name>@zero``), the only collective besides the
    model's own.
    """

    def local_phase(state, batch: dict, gamma: float) -> torch.Tensor:
        n_workers, tau = lead_dims(batch)[:2]
        losses = torch.empty(tau, n_workers, dtype=F32, device=parts(state.params)[0].device)
        for k in range(tau):
            worker_grads(loss_fn, layout, state.params, state.grads,
                         take(batch, slice(None), k), losses[k])
            base_opt.update(state.params, state.grads, state.base_state, gamma,
                            state.inner + k)
        if TP.zero_split(layout, lead_dims(batch)[3]):
            comm.all_reduce(losses, layout.zero_axis, "sum").div_(_on(layout.zero, losses))
        return losses

    return local_phase


def check_rank_layout(layout: FlatLayout, topo) -> tuple:
    """``(model, zero)`` of ``topo`` (a topology's model axis and its FSDP
    zero group; ``(1, 1)`` without one); a layout that is not its rank's
    raises."""
    model = 1 if topo is None else topo.model
    zero = 1 if topo is None or topo.fsdp != "zero" else topo.zero
    if layout.model != model or layout.zero != zero:
        raise ValueError(f"a topology with model={model} and FSDP over zero={zero} needs its "
                         f"rank's layout (distributed.tensor_parallel.topology_layout), got "
                         f"model={layout.model}, zero={layout.zero}")
    return model, zero


def make_dsm_step(loss_fn: Callable, base_opt: BaseOptimizer, cfg: DSMConfig,
                  schedule: Callable, layout: FlatLayout, topo=None):
    """Build ``outer_step(state, batch[, rng[, faults]]) -> (state, metrics)``.

    ``batch``: the reference's dict of leaves (W, tau, accum, B_micro, ...)
    on the state's device, the state's workers' rows: int64 ``tokens`` (...,
    S), with ``patches`` or ``frames`` for the vlm / encdec families.
    ``loss_fn(params, microbatch)`` takes a ``{path: tensor}`` params dict
    and one microbatch, the dict of (B_micro, ...) leaves.  ``rng``: the
    ``torch.Generator`` on the state's device that the randomized signs draw
    from (unused by ``sign_mode="sign"``).  ``metrics`` holds 0-d tensors
    ``loss``, ``last_loss``, ``gamma`` and the ``(N_METRICS,)`` ``pack``,
    plus ``survivors`` (the sum of the weights) on a survivor-aware round.

    ``topo`` (a ``repro_torch.distributed.mesh.Topology``) runs the round
    over the ranks of a process group, as the reference's mesh branches do
    (``core/dsm.py:432-482``): the losses and finiteness masks are gathered
    in worker order, the worker mean is scattered to the shards' owners, and
    with ``cfg.zero_sharded`` the DSM kernel updates the rank's shard (one
    all-reduce for the pack's sums, one all-gather of x_{t+1,0}); without it
    every rank gathers the whole mean and runs the replicated global step.
    A mixed-dtype model's groups go through each collective and launch one
    by one (``repro_torch.distributed.comm`` counts the calls).
    ``cfg.device_parallel_local`` needs a topology, as the reference's needs
    a mesh.  A topology with ``model`` > 1 needs its rank's ``layout``
    (``tensor_parallel.topology_layout``); the global step then runs over
    ``topo.dp`` on the rank's blocks, the finiteness masks take the minimum
    over the model group, and the stat sums add over it (a leaf every model
    rank holds whole counted once).  So does an FSDP topology
    (``fsdp="zero"``), whose layout cuts the blocks over ``zero`` too: the
    global step runs over the worker peers on the rank's zero blocks, the
    masks take the minimum over the zero group as well, and the stat sums
    add over the ``(worker, zero)`` ranks (a leaf held whole over zero
    counted once).  The randomized signs run on every layout from one
    draw: each rank draws every dense group whole from ``rng`` and takes
    its elements (:func:`layout_uniforms`), so with every rank's generator
    seeded as the dense run's, its x0 and m come out as the dense step's
    at its elements, bit for bit, a leaf's copies on every rank alike.

    ``faults`` (a ``repro_torch.robustness.FaultRound`` of all W workers)
    makes the round survivor-aware: stale and corrupt contributions are
    injected, dropped ones excluded from the mean, non-finite ones detected
    and masked.  A round with no usable contribution still runs the global
    step (one DSM launch) and then restores x0 and m (or their shards) from
    copies with a device-side select, so they stay bit-untouched with no
    host read; the workers re-sync from x0, and ``t`` and ``inner`` advance.
    ``cfg.mask_nonfinite`` turns on the detection without injection.
    """
    if cfg.device_parallel_local and topo is None:
        raise ValueError("device_parallel local phase needs a topology with a 'worker' axis "
                         "(repro_torch.distributed.mesh.topology)")
    model, zero = check_rank_layout(layout, topo)
    local_phase = make_local_phase(loss_fn, base_opt, layout)
    sharded = cfg.zero_sharded and topo is not None
    numels = layout.group_numels
    # the worker mean, the global step and the re-sync run over the
    # (worker, zero) ranks of this rank's model index (under FSDP its worker
    # peers), on its blocks; a leaf every model (zero) rank holds whole
    # counts in the stat sums once
    dtopo = None if topo is None else topo.dp
    blocks = model > 1 or zero > 1
    drop = layout.uncounted_spans() if blocks else ((),) * layout.n_groups
    # the randomized signs' map of the rank's x0 elements into the dense
    # groups, built once per device
    maps = {}

    def dense_index(device):
        if device not in maps:
            chunks = [Z.my_bounds(n, dtopo) for n in numels] if sharded else None
            maps[device] = layout.dense_index(chunks, device)
        return maps[device]

    def outer_step(state: DSMState, batch: dict,
                   rng: Optional[torch.Generator] = None, faults=None):
        gamma_t = schedule(state.t)          # fixed for the whole outer step
        gamma = float(gamma_t)  # noqa: RPR002 schedules return 0-d CPU tensors: no device sync
        # the reference's jax.named_scope ranges, seen in a profiler trace
        with record_function("dsm_local_phase"):
            losses = local_phase(state, batch, gamma)
        with record_function("dsm_global_step"):
            return global_phase(state, losses, gamma_t, gamma, rng, faults)

    def global_phase(state, losses, gamma_t, gamma, rng, faults):
        if topo is not None:
            losses = comm.gather_workers(losses, dtopo, dim=1)

        contrib = state.params
        if faults is not None:
            own = faults if topo is None else type(faults)(
                *(mask[topo.worker_slice] for mask in faults))
            contrib = apply_faults(state.params, Z.gather_shards(state.x0, dtopo, numels)
                                   if sharded else state.x0, own)
        weights = _contribution_weights(contrib, cfg, faults, topo)
        if topo is None:
            # line 7: the worker mean, in f32 and cast back (as jnp.mean of bf16)
            x_tau = worker_mean(contrib) if weights is None else masked_worker_mean(
                contrib, weights)
        elif sharded:
            x_tau = Z.scattered_worker_mean(contrib, dtopo, weights)
        else:
            x_tau = Z.replicated_worker_mean(contrib, dtopo, weights)
        if weights is not None:
            del contrib     # frees the faulted (W, N) copy before the x0 / m copies
            kept = parts(state.x0) + parts(state.m)
            kept = [t.clone() for t in kept]
        if sharded:
            stat = Z.sharded_stat_sums(state.x0, state.m, x_tau, gamma, cfg.beta1, dtopo,
                                       numels, drop if blocks else None,
                                       topo.wz if zero > 1 else None)
            Z.sharded_global_sign_momentum_step(
                state.x0, state.m, x_tau, gamma, cfg, dtopo, numels, rng,
                None if cfg.sign_mode == "sign" else dense_index(parts(state.x0)[0].device))
        else:
            stat = (OM.stat_sums(state.x0, state.m, x_tau, gamma, cfg.beta1) if not blocks
                    else functools.reduce(torch.add, [
                        Z.stat_sums_less(x, m, xt, gamma, cfg.beta1, 0, d) for x, m, xt, d in
                        zip(parts(state.x0), parts(state.m), parts(x_tau), drop)]))
            if zero > 1:
                stat = comm.all_reduce(stat, topo.zp, "sum")
            if cfg.sign_mode == "sign":
                global_sign_momentum_step(state.x0, state.m, x_tau, gamma, cfg)
            else:
                randomized_step(state.x0, state.m, x_tau, gamma, cfg, rng,
                                dense_index(parts(state.x0)[0].device))
        if model > 1:
            stat = comm.all_reduce(stat, topo.mp, "sum")
        wsum = None
        if weights is not None:
            # skip-round: no usable contribution -> x0 / m bit-untouched
            wsum = weights.sum()
            ok = wsum > 0
            for buf, old in zip(parts(state.x0) + parts(state.m), kept):
                torch.where(ok, buf, old, out=buf)

        # line 11: every worker restarts from x_{t+1,0} (the all-gather of
        # each sharded group); AdamW state carries on
        x0 = Z.gather_shards(state.x0, dtopo, numels) if sharded else state.x0
        each(lambda p, x: p.copy_(x.expand_as(p)), state.params, x0)
        state.t += 1
        state.inner += cfg.tau

        loss_mean, last_loss, spread = OM.loss_stats(losses)
        pack = OM.finish_pack(loss=loss_mean, last_loss=last_loss, gamma=gamma_t,
                              worker_spread=spread, stat_sums=stat,
                              n_elems=layout.dense_numel,
                              survivor_frac=None if wsum is None else wsum / losses.shape[1])
        metrics = {"loss": loss_mean, "gamma": gamma_t, "last_loss": last_loss, "pack": pack}
        if wsum is not None:
            metrics["survivors"] = wsum
        return state, metrics

    return outer_step


# ---------------------------------------------------------------------------
# Convenience instances
# ---------------------------------------------------------------------------

def signsgd_momentum_config(beta: float) -> DSMConfig:
    """tau=1, beta1=beta2=beta, lam=0: exactly eq. (3) signSGD w/ momentum."""
    return DSMConfig(tau=1, beta1=beta, beta2=beta, weight_decay=0.0)


def signed_lookahead_config(tau: int, beta: float, weight_decay: float = 0.0) -> DSMConfig:
    """n=1 instance (§4.1 ablation): signed Lookahead with decoupled wd."""
    return DSMConfig(tau=tau, beta1=beta, beta2=beta, weight_decay=weight_decay)
