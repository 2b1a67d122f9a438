"""Base optimizers of the local steps (paper Algorithm 1 accepts any).

A :class:`BaseOptimizer` has

    state = opt.init(params)                          # flat (W, N) or (N,) buffers
    direction, state = opt.direction(grads, state, params, step)
    opt.update(params, grads, state, gamma, step)     # in place

``direction`` is the plain PyTorch form of the reference's, with its
arithmetic in the same order (returns the paper's d, eq. 4, in p.dtype; the
local update is ``x <- x - gamma * d``).  ``update`` is the local step the
training path runs, ``x <- (x - gamma * d)`` in f32 rounded to p.dtype, with
the base-optimizer state updated in place.  For AdamW it is the AdamW kernel
on the card (its plain version on the CPU) with the training path's rounding
(``round_direction=True``); the other optimizers have no TPU kernel and
update in plain PyTorch.

``init`` and ``update`` take a mixed-dtype model's :class:`Groups` buffers
too: the state then holds Groups, and ``update`` runs group by group (with
AdamW one kernel launch per group, in the group's dtype).

A Python float meets a reference array as a weakly typed constant, which
takes the array's dtype: against f32 tensors PyTorch rounds it the same way,
against bf16 tensors :func:`weak_scalar` rounds it first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.groups import Groups, join, parts, pick
from repro_torch.kernels.adamw_update import adamw_consts, adamw_update, moments_and_direction
from repro_torch.kernels.dsm_update import sign_like_jnp

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class BaseOptimizer:
    name: str
    init: Callable
    direction: Callable
    update: Callable


def _over_groups(name: str, init: Callable, direction: Callable,
                 update: Callable) -> BaseOptimizer:
    """The optimizer whose ``init`` and ``update`` also take :class:`Groups`
    buffers, group by group; ``direction`` stays per tensor."""

    def grouped_init(params):
        if isinstance(params, Groups):
            return join([init(p) for p in params])
        return init(params)

    def grouped_update(params, grads, state, gamma, step):
        for i, (p, g) in enumerate(zip(parts(params), parts(grads), strict=True)):
            update(p, g, pick(state, i), gamma, step)

    return BaseOptimizer(name, grouped_init, direction, grouped_update)


def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """The Python float ``c`` as JAX uses it against an array of ``dtype``."""
    return float(torch.tensor(c, dtype=dtype))  # noqa: RPR002 a CPU tensor made here from c


def _buffers(state) -> tuple:
    return (state,) if isinstance(state, torch.Tensor) else tuple(state)


def _plain_update(direction: Callable) -> Callable:
    """The training path's local step around ``direction``, in place."""

    def update(params, grads, state, gamma, step):
        d, new_state = direction(grads, state, params, step)
        for buf, new in zip(_buffers(state), _buffers(new_state)):
            buf.copy_(new)
        params.copy_(params.to(F32) - gamma * d.to(F32))

    return update


# ---------------------------------------------------------------------------
# SGD family
# ---------------------------------------------------------------------------

def sgd() -> BaseOptimizer:
    """Plain mini-batch SGD: d = g (paper eq. 5)."""

    def init(params):
        return ()

    def direction(grads, state, params, step):
        return grads, state

    return _over_groups("sgd", init, direction, _plain_update(direction))


def momentum(beta: float = 0.9, nesterov: bool = False) -> BaseOptimizer:
    """Polyak momentum (paper Alg. 3): m <- beta*m + g, d = m (or Nesterov).
    The buffer keeps the param dtype, as the reference's does."""

    def init(params):
        return torch.zeros_like(params)

    def direction(grads, state, params, step):
        b = weak_scalar(beta, state.dtype)
        new_m = b * state + grads
        d = b * new_m + grads if nesterov else new_m
        return d, new_m

    return _over_groups("momentum", init, direction, _plain_update(direction))


# ---------------------------------------------------------------------------
# AdamW (paper Alg. 2) — the paper's main base optimizer
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> BaseOptimizer:
    """AdamW with decoupled weight decay; moments in f32.

    Defaults follow the paper's GPT-2 pre-training setup.
    """
    hp = dict(beta1=b1, beta2=b2, eps=eps, wd=weight_decay)

    def init(params):
        return AdamWState(m=torch.zeros_like(params, dtype=F32),
                          v=torch.zeros_like(params, dtype=F32))

    def direction(grads, state, params, step):
        # count = step + 1 (1-indexed bias correction); gamma plays no part
        k = adamw_consts(0.0, step, **hp)
        m, v, d = moments_and_direction(params, grads, state.m, state.v, k,
                                        round_direction=True)
        return d.to(params.dtype), AdamWState(m, v)

    def update(params, grads, state, gamma, step):
        adamw_update(params, grads, state.m, state.v, gamma, step, round_direction=True, **hp)

    return _over_groups("adamw", init, direction, update)


# ---------------------------------------------------------------------------
# Lion (paper Alg. 4)
# ---------------------------------------------------------------------------

def lion(b1: float = 0.95, b2: float = 0.98, weight_decay: float = 0.1) -> BaseOptimizer:
    """Lion: d = sign(b1*m + (1-b1)*g) + wd*x ; m <- b2*m + (1-b2)*g; m in f32."""

    def init(params):
        return torch.zeros_like(params, dtype=F32)

    def direction(grads, state, params, step):
        g = grads.to(F32)
        u = b1 * state + (1.0 - b1) * g
        d = (sign_like_jnp(u) + weight_decay * params.to(F32)).to(params.dtype)
        return d, b2 * state + (1.0 - b2) * g

    return _over_groups("lion", init, direction, _plain_update(direction))


# ---------------------------------------------------------------------------
# Sophia (Liu et al. 2024b) — diagonal-Hessian clipped second-order method.
# ---------------------------------------------------------------------------

class SophiaState(NamedTuple):
    m: torch.Tensor
    h: torch.Tensor   # EMA of the diagonal Hessian estimate


def sophia(
    b1: float = 0.96,
    b2: float = 0.99,
    rho: float = 0.04,
    weight_decay: float = 0.1,
    eps: float = 1e-12,
) -> BaseOptimizer:
    """Sophia-G: d = clip(m / max(rho*h, eps), -1, 1) + wd*x; m and h in f32.

    ``direction`` takes an optional ``hess`` estimate (f32, the params'
    shape); without one it uses the squared gradient, the cheap proxy.
    """

    def init(params):
        return SophiaState(m=torch.zeros_like(params, dtype=F32),
                           h=torch.zeros_like(params, dtype=F32))

    def direction(grads, state, params, step, hess: Optional[torch.Tensor] = None):
        g = grads.to(F32)
        new_m = b1 * state.m + (1.0 - b1) * g
        new_h = b2 * state.h + (1.0 - b2) * (g * g if hess is None else hess)
        d = torch.clamp(new_m / torch.clamp(rho * new_h, min=eps), -1.0, 1.0)
        d = (d + weight_decay * params.to(F32)).to(params.dtype)
        return d, SophiaState(new_m, new_h)

    return _over_groups("sophia", init, direction, _plain_update(direction))


REGISTRY: dict[str, Callable[..., BaseOptimizer]] = {
    "sgd": sgd,
    "momentum": momentum,
    "adamw": adamw,
    "lion": lion,
    "sophia": sophia,
}


def get_base_optimizer(name: str, **kwargs) -> BaseOptimizer:
    if name not in REGISTRY:
        raise ValueError(f"unknown base optimizer {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
