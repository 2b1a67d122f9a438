"""Baselines the paper compares against, on the flat ``(W, N)`` buffers.

  * SlowMo (Alg. 5, Wang et al. 2019)          -> ``slowmo``
  * signed SlowMo (§4.1 ablation)              -> ``signed_slowmo``
  * Lookahead (Zhang et al. 2019; §4.1)        -> ``lookahead``
  * Global AdamW with local steps (Alg. 7)     -> ``global_adamw``
  * Local averaging (local AdamW; App. C.2)    -> ``local_avg``
  * per-step data parallel (the paper's upper baseline) -> ``make_perstep_dp_step``
  * Federated MV-sto-signSGD-SIM (Alg. 6, Sun et al. 2023) -> ``make_mv_signsgd_step``

The local-step methods share ``make_local_step_method``: DSM's local phase
(``repro_torch.core.dsm.make_local_phase``, so with AdamW the AdamW kernel
does every local update) followed by a global update on
``(x0, aux, x_tau_mean, gamma, t)``.  The global updates are plain PyTorch,
as the reference's are plain jnp, and update ``x0`` and ``aux`` in place.
Under a topology (the device-parallel local phase, reference
``baselines.py:40-110``) a rank runs its own workers, the worker mean is
the dense one on every rank, and the global update runs replicated; on a
model axis or under FSDP on the rank's blocks, over the ranks that hold
the same blocks.
``perstep`` and ``mv_signsgd`` take no topology, as the reference's read
no mesh flag: each rank runs them whole.

A mixed-dtype model's buffers are Groups (``repro_torch.groups``): the
global updates run group by group, each on its group's x0 and aux, and
under a topology the worker mean is gathered group by group.

Batches are dicts of leaves ``(W, tau, 1, B_micro, ...)`` (``tokens``, and
``patches`` or ``frames`` for the vlm / encdec families): the trainer's
layout with an accumulation axis of 1, which is numerically the reference's
batch without that axis (0 + g = g, g / 1 = g).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.base_opt import BaseOptimizer, weak_scalar
from repro_torch.core.dsm import (check_rank_layout, lead_dims, make_local_phase,
                                  randomized_sign_pm, take, worker_grads, worker_mean)
from repro_torch.distributed import comm
from repro_torch.distributed import zero as Z
from repro_torch.groups import Groups, each, join, parts, pick
from repro_torch.kernels.dsm_update import sign_like_jnp
from repro_torch.models.convert import FlatLayout

F32 = torch.float32


@dataclasses.dataclass
class LocalMethodState:
    """State of a local-step method; the outer step updates it IN PLACE."""

    params: torch.Tensor      # (W, N) per-worker params, param dtype
    grads: torch.Tensor       # (W, N) gradient buffer, param dtype (scratch)
    x0: torch.Tensor          # (N,) global model
    aux: object               # method-specific global state (momentum etc.)
    base_state: object        # per-worker base-optimizer state, (W, N) leaves
    t: int = 0
    inner: int = 0

    SCRATCH: ClassVar[tuple] = ("grads",)   # not checkpointed, not guarded


def make_local_step_method(loss_fn: Callable, base_opt: BaseOptimizer, tau: int,
                           schedule: Callable, init_aux: Callable, global_update: Callable,
                           layout: FlatLayout, topo=None):
    """Generic: tau local steps -> worker mean -> ``global_update`` -> sync.

    ``global_update(x0, aux, x_tau_mean, gamma, t)`` updates x0 and aux in
    place.  Returns ``(init(x0, n_workers) -> state,
    outer_step(state, batch) -> (state, metrics))``.  Under ``topo`` the
    state and ``batch`` hold the rank's own workers, and the losses and the
    worker mean are gathered over ``topo.dp``.  On a model axis or under
    FSDP (a topology with ``model`` > 1 or ``fsdp="zero"``, with its rank's
    ``layout``, ``tensor_parallel.topology_layout``) x0 and aux hold the
    rank's blocks (its layout's elements: under FSDP its zero blocks, as
    the reference has no sharded global step for the baselines); the local
    phase computes over its model and zero groups as DSM's does, and
    ``topo.dp`` is the ranks that hold the same blocks, so the mean, a
    worker's loss and each element of the global update are the dense
    ones, a leaf's copies on every rank alike.
    """
    check_rank_layout(layout, topo)
    local_phase = make_local_phase(loss_fn, base_opt, layout)
    dtopo = None if topo is None else topo.dp

    def init(x0, n_workers: int) -> LocalMethodState:
        rows = n_workers if topo is None else topo.local_workers
        params = each(lambda x: x.unsqueeze(0).repeat(rows, 1), x0)
        aux = join([init_aux(x) for x in x0]) if isinstance(x0, Groups) else init_aux(x0)
        return LocalMethodState(params=params, grads=each(torch.zeros_like, params),
                                x0=each(torch.clone, x0), aux=aux,
                                base_state=base_opt.init(params))

    def outer_step(state: LocalMethodState, batch: dict):
        gamma_t = schedule(state.t)
        gamma = float(gamma_t)
        losses = local_phase(state, batch, gamma)
        if topo is None:
            x_tau = worker_mean(state.params)
        else:
            losses = comm.gather_workers(losses, dtopo, dim=1)
            x_tau = Z.replicated_worker_mean(state.params, dtopo)
        for i, x0 in enumerate(parts(state.x0)):
            global_update(x0, pick(state.aux, i), pick(x_tau, i), gamma, state.t)
        each(lambda p, x: p.copy_(x.expand_as(p)), state.params, state.x0)
        state.t += 1
        state.inner += tau
        return state, {"loss": losses.mean(), "gamma": gamma_t}

    return init, outer_step


# ---------------------------------------------------------------------------
# Global updates
# ---------------------------------------------------------------------------

def _f32(c) -> float:
    return float(np.float32(c))


def _delta(x0: torch.Tensor, x_tau: torch.Tensor, gamma: float) -> torch.Tensor:
    """The pseudo-gradient (x0 - x_tau) / gamma in f32.  It divides by a
    tensor on the data's device: torch turns division by a host scalar into
    a product with its reciprocal on the card.  The tensor is filled in
    there: a copy from the host would synchronise the stream."""
    g = torch.full((), gamma, dtype=F32, device=x0.device)
    return (x0.to(F32) - x_tau.to(F32)) / g


def _zeros_f32(x0: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x0, dtype=F32)


def _step_from(x0: torch.Tensor, scale: float, gamma: float, u: torch.Tensor) -> None:
    """x0 <- x0 - scale * gamma * u in f32, rounded to x0's dtype."""
    x0.copy_(x0.to(F32) - _f32(np.float32(scale) * np.float32(gamma)) * u)


def slowmo_update(beta: float = 0.5, alpha: float = 1.0):
    """SlowMo (Alg. 5): u <- beta*u + Delta ; x <- x0 - alpha*gamma*u."""

    def global_update(x0, u, x_tau, gamma, t):
        u.mul_(beta).add_(_delta(x0, x_tau, gamma))
        _step_from(x0, alpha, gamma, u)

    return _zeros_f32, global_update


def signed_slowmo_update(beta: float = 0.5, eta: float = 1.0):
    """§4.1, the printed form (sign taken before momentum):
    m <- beta*m + ((1-beta)/gamma)*sign(x0 - x_tau); x <- x0 - eta*gamma*m."""

    def global_update(x0, m, x_tau, gamma, t):
        c = _f32(np.float32(1.0 - beta) / np.float32(gamma))   # an f32 division
        m.mul_(beta).add_(c * sign_like_jnp(x0.to(F32) - x_tau.to(F32)))
        _step_from(x0, eta, gamma, m)

    return _zeros_f32, global_update


def lookahead_update(beta: float = 0.2, eta: float = 1.0):
    """Lookahead (§4.1): DSM with (7) replaced by x <- x0 - eta*gamma*u (no sign)."""

    def global_update(x0, m, x_tau, gamma, t):
        m.mul_(beta).add_((1.0 - beta) * _delta(x0, x_tau, gamma))
        _step_from(x0, eta, gamma, m)

    return _zeros_f32, global_update


def local_avg_update():
    """Local AdamW / FedAvg-style: x <- mean_i x^{(i)}_{t,tau} (App. C.2)."""

    def global_update(x0, aux, x_tau, gamma, t):
        x0.copy_(x_tau)

    return (lambda x0: ()), global_update


class GlobalAdamWAux(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def global_adamw_update(eta: float = 1.0, b1: float = 0.9, b2: float = 0.95,
                        weight_decay: float = 0.0, eps: float = 1e-8):
    """Alg. 7: AdamW on the pseudo-gradient g = (x0 - x_tau)/gamma."""

    def init_aux(x0):
        return GlobalAdamWAux(_zeros_f32(x0), _zeros_f32(x0))

    def global_update(x0, aux, x_tau, gamma, t):
        g = _delta(x0, x_tau, gamma)
        aux.m.mul_(b1).add_((1 - b1) * g)
        aux.v.mul_(b2).add_((1 - b2) * g * g)
        # bias corrections: f32 constants on the host, divided by on the device
        tc = np.float32(t + 1)
        bc1, bc2 = (torch.full((), float(np.float32(1) - np.float32(b) ** tc), dtype=F32,
                               device=x0.device) for b in (b1, b2))
        x0f = x0.to(F32)
        step = (aux.m / bc1) / (torch.sqrt(aux.v / bc2) + eps) + weight_decay * x0f
        x0.copy_(x0f - _f32(np.float32(eta) * np.float32(gamma)) * step)

    return init_aux, global_update


# each local-step method's ``(init_aux, global_update)`` from its global
# step's keyword arguments: ``GLOBAL_UPDATES[name](**kw)``
GLOBAL_UPDATES = {"slowmo": slowmo_update, "signed_slowmo": signed_slowmo_update,
                  "lookahead": lookahead_update, "global_adamw": global_adamw_update,
                  "local_avg": local_avg_update}


def slowmo(loss_fn, base_opt, tau, schedule, layout, beta: float = 0.5, alpha: float = 1.0,
           topo=None):
    """SlowMo (:func:`slowmo_update`) with DSM's local phase."""
    return make_local_step_method(loss_fn, base_opt, tau, schedule,
                                  *slowmo_update(beta, alpha), layout, topo)


def signed_slowmo(loss_fn, base_opt, tau, schedule, layout, beta: float = 0.5,
                  eta: float = 1.0, topo=None):
    """Signed SlowMo (:func:`signed_slowmo_update`) with DSM's local phase."""
    return make_local_step_method(loss_fn, base_opt, tau, schedule,
                                  *signed_slowmo_update(beta, eta), layout, topo)


def lookahead(loss_fn, base_opt, tau, schedule, layout, beta: float = 0.2, eta: float = 1.0,
              topo=None):
    """Lookahead (:func:`lookahead_update`) with DSM's local phase."""
    return make_local_step_method(loss_fn, base_opt, tau, schedule,
                                  *lookahead_update(beta, eta), layout, topo)


def local_avg(loss_fn, base_opt, tau, schedule, layout, topo=None):
    """Local averaging (:func:`local_avg_update`) with DSM's local phase."""
    return make_local_step_method(loss_fn, base_opt, tau, schedule, *local_avg_update(),
                                  layout, topo)


def global_adamw(loss_fn, base_opt, tau, schedule, layout, eta: float = 1.0, b1: float = 0.9,
                 b2: float = 0.95, weight_decay: float = 0.0, eps: float = 1e-8, topo=None):
    """Global AdamW (:func:`global_adamw_update`) with DSM's local phase."""
    return make_local_step_method(loss_fn, base_opt, tau, schedule,
                                  *global_adamw_update(eta, b1, b2, weight_decay, eps),
                                  layout, topo)


LOCAL_METHODS = {"slowmo": slowmo, "signed_slowmo": signed_slowmo, "lookahead": lookahead,
                 "global_adamw": global_adamw, "local_avg": local_avg}


# ---------------------------------------------------------------------------
# Per-step data parallel: the gradient mean EVERY round (the paper's
# communication-heavy upper baseline)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PerStepDPState:
    params: torch.Tensor      # (N,) the one global copy
    grads: torch.Tensor       # (W, N) per-worker gradients (scratch)
    base_state: object
    t: int = 0

    SCRATCH: ClassVar[tuple] = ("grads",)   # not checkpointed, not guarded


def make_perstep_dp_step(loss_fn: Callable, base_opt: BaseOptimizer, tau: int,
                         schedule: Callable, layout: FlatLayout):
    """tau rounds per call, each: W forward+backward passes on the one
    parameter copy, the gradient mean, one base-optimizer update (with AdamW,
    the AdamW kernel on (N,)).  One call consumes the tokens of one DSM outer
    step and communicates tau times as often.

    The update is the training path's local step, cast back to the param
    dtype; the reference's ``x - gamma * d`` promotes bf16 params to f32.
    """

    def init(x0, n_workers: int) -> PerStepDPState:
        return PerStepDPState(params=each(torch.clone, x0),
                              grads=each(lambda x: x.new_zeros(n_workers, x.numel()), x0),
                              base_state=base_opt.init(x0))

    def outer_step(state: PerStepDPState, batch: dict):
        gamma_t = schedule(state.t)   # indexed by the outer-equivalent step
        gamma = float(gamma_t)
        losses = torch.empty(tau, lead_dims(batch)[0], dtype=F32,
                             device=parts(state.params)[0].device)
        for k in range(tau):
            worker_grads(loss_fn, layout, state.params, state.grads,
                         take(batch, slice(None), k), losses[k])
            g = worker_mean(state.grads)                                     # all-reduce
            base_opt.update(state.params, g, state.base_state, gamma, state.t * tau + k)
        state.t += 1
        return state, {"loss": losses.mean(), "gamma": gamma_t}

    return init, outer_step


# ---------------------------------------------------------------------------
# Federated MV-sto-signSGD-SIM (Alg. 6, Sun et al. 2023)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MVState:
    x: torch.Tensor           # (N,) global model
    x_prev: torch.Tensor      # (N,) the previous global model
    m: torch.Tensor           # (W, N) per-worker momentum, f32
    params: torch.Tensor      # (W, N) local iterates z (scratch)
    grads: torch.Tensor       # (W, N) gradient buffer (scratch)
    t: int = 0

    SCRATCH: ClassVar[tuple] = ("params", "grads")   # not checkpointed, not guarded


def make_mv_signsgd_step(loss_fn: Callable, tau: int, gamma: float, eta: float,
                         layout: FlatLayout, beta: float = 0.9, alpha: float = 0.5,
                         bound: float = 1.0):
    """Alg. 6: local SGD from the extrapolated point, randomized-sign majority
    vote.  The local SGD steps and the extrapolation run in the param dtype,
    as the reference's do; momentum and vote in f32."""

    def init(x0, n_workers: int) -> MVState:
        params = each(lambda x: x.unsqueeze(0).repeat(n_workers, 1), x0)
        return MVState(x=each(torch.clone, x0), x_prev=each(torch.clone, x0),
                       m=each(lambda p: torch.zeros_like(p, dtype=F32), params),
                       params=params, grads=each(torch.zeros_like, params))

    def outer_step(state: MVState, batch: dict, rng: Optional[torch.Generator] = None,
                   uniform=None):
        """``uniform``: the (W, N) f32 draws of the signs (Groups of them for
        Groups buffers), else drawn from ``rng``."""
        n_workers = lead_dims(batch)[0]
        dev = parts(state.x)[0].device

        def start(p, x, x_prev):
            # y_t = x_t + alpha (x_t - x_{t-1}), every worker starts from it
            y = x + weak_scalar(alpha, x.dtype) * (x - x_prev)
            p.copy_(y.expand_as(p))

        each(start, state.params, state.x, state.x_prev)
        losses = torch.empty(tau, n_workers, dtype=F32, device=dev)
        for k in range(tau):
            worker_grads(loss_fn, layout, state.params, state.grads,
                         take(batch, slice(None), k), losses[k])
            each(lambda p, g: p.sub_(weak_scalar(gamma, p.dtype) * g), state.params, state.grads)

        # local momentum from a fresh gradient at z_tau on the last microbatch
        worker_grads(loss_fn, layout, state.params, state.grads, take(batch, slice(None), -1),
                     torch.empty(n_workers, device=dev))
        each(lambda m, g: m.mul_(beta).add_((1 - beta) * g.to(F32)), state.m, state.grads)

        # randomized sign per worker, sum, majority vote
        for i, (x, x_prev, m) in enumerate(zip(parts(state.x), parts(state.x_prev),
                                               parts(state.m))):
            votes = randomized_sign_pm(m, rng, bound, pick(uniform, i)).sum(dim=0)
            x_new = x.to(F32) - eta * sign_like_jnp(votes)
            x_prev.copy_(x)
            x.copy_(x_new)
        state.t += 1
        return state, {"loss": losses.mean()}

    return init, outer_step
