"""Base optimizers of the local steps (paper Algorithm 1 accepts any).

The port has AdamW, the paper's main base optimizer.  A
:class:`BaseOptimizer` has

    state = opt.init(params)                          # flat (W, N) buffers
    direction, state = opt.direction(grads, state, params, step)
    opt.update(params, grads, state, gamma, step)     # in place

``direction`` is the plain PyTorch form of the reference's (returns the
paper's d, eq. 4, in p.dtype; the local update is ``x <- x - gamma * d``).
``update`` is the fused local step the training path runs: the AdamW kernel
on the card, its plain version on the CPU, with the training path's
rounding (``round_direction=True``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.adamw_update import adamw_consts, adamw_update, moments_and_direction


@dataclasses.dataclass(frozen=True)
class BaseOptimizer:
    name: str
    init: Callable
    direction: Callable
    update: Callable


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
        return AdamWState(m=torch.zeros_like(params, dtype=torch.float32),
                          v=torch.zeros_like(params, dtype=torch.float32))

    def direction(grads, state, params, step):
        # count = step + 1 (1-indexed bias correction); gamma plays no part
        k = adamw_consts(0.0, step, **hp)
        m, v, d = moments_and_direction(params, grads, state.m, state.v, k,
                                        round_direction=True)
        return d.to(params.dtype), AdamWState(m, v)

    def update(params, grads, state, gamma, step):
        adamw_update(params, grads, state.m, state.v, gamma, step, round_direction=True, **hp)

    return BaseOptimizer("adamw", init, direction, update)


REGISTRY = {"adamw": adamw}


def get_base_optimizer(name: str, **kwargs) -> BaseOptimizer:
    if name not in REGISTRY:
        raise NotImplementedError(
            f"base optimizer {name!r} is not ported yet (ROADMAP.md); have {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
