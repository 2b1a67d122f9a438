"""Distributed Sign Momentum with local steps — the paper's Algorithm 1, on
flat ``(W, N)`` buffers.

One outer step t:

  1. every worker i runs tau local steps of the base optimizer (AdamW):
         x^{(i)}_{t,k+1} = x^{(i)}_{t,k} - gamma_t * d^{(i)}_{t,k}
  2. the worker mean  x_{t,tau} = mean_i x^{(i)}_{t,tau}  (f32, cast back)
  3. the global sign-momentum step on Delta_t = (x_{t,0} - x_{t,tau}) / gamma_t
     (eqs. 6-8), then every worker restarts from x_{t+1,0}.

The W workers are simulated on one device: a Python loop runs each worker's
forward and backward, and the AdamW kernel then updates all workers in one
launch.  The global step is the DSM kernel on the card.

The port covers the dense, fault-free case with ``sign_mode="sign"``; the
randomized signs, fault masks, ZeRO sharding and the device-parallel local
phase raise ``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.base_opt import BaseOptimizer
from repro_torch.kernels.dsm_update import dsm_update
from repro_torch.models.convert import FlatLayout
from repro_torch.obs import metrics as OM

SIGN_MODES = ("sign", "rand_pm", "rand_zero")


@dataclasses.dataclass(frozen=True)
class DSMConfig:
    """Hyper-parameters of Algorithm 1 (the reference's fields, less
    ``sign_bound``, read only by the randomized signs, and ``use_kernel``:
    the port's global step is always the DSM kernel's wrapper).

    Defaults are the paper's recommended Lion parameters for the global step
    (beta1=0.95, beta2=0.98, lambda=0.1; §4 Implementations).
    """

    tau: int = 12                 # communication interval (local steps)
    global_lr: float = 1.0        # eta
    beta1: float = 0.95           # u_{t+1} interpolation (eq. 6)
    beta2: float = 0.98           # m_{t+1} interpolation (eq. 8)
    weight_decay: float = 0.1     # decoupled lambda (eq. 7)
    sign_mode: str = "sign"       # "sign" | "rand_pm" | "rand_zero"
    zero_sharded: bool = False
    device_parallel_local: bool = False
    mask_nonfinite: bool = False

    def __post_init__(self):
        if self.sign_mode not in SIGN_MODES:
            raise ValueError(f"sign_mode must be one of {SIGN_MODES}")
        if not (0.0 <= self.beta1 <= 1.0 and 0.0 <= self.beta2 <= 1.0):
            raise ValueError("momentum coefficients must lie in [0, 1]")
        if self.tau < 1:
            raise ValueError("tau must be >= 1")


def check_ported(cfg: DSMConfig) -> None:
    missing = [name for name, on in (
        (f"sign_mode={cfg.sign_mode!r}", cfg.sign_mode != "sign"),
        ("zero_sharded", cfg.zero_sharded),
        ("device_parallel_local", cfg.device_parallel_local),
        ("mask_nonfinite", cfg.mask_nonfinite),
    ) if on]
    if missing:
        raise NotImplementedError(f"DSM options not ported yet (ROADMAP.md): {missing}")


@dataclasses.dataclass
class DSMState:
    """Algorithm 1 state; the outer step updates it IN PLACE."""

    params: torch.Tensor      # (W, N) per-worker params, param dtype
    grads: torch.Tensor       # (W, N) gradient buffer, param dtype (scratch)
    x0: torch.Tensor          # (N,) global model x_{t,0}
    m: torch.Tensor           # (N,) global sign momentum m_t, f32
    base_state: object        # per-worker base-optimizer state, (W, N) leaves
    t: int = 0                # outer step counter
    inner: int = 0            # total local-step counter (AdamW bias correction)


def dsm_init(x0: torch.Tensor, base_opt: BaseOptimizer, n_workers: int) -> DSMState:
    """State from the flat global params ``x0`` (N,)."""
    params = x0.unsqueeze(0).repeat(n_workers, 1)
    return DSMState(
        params=params,
        grads=torch.zeros_like(params),
        x0=x0.clone(),
        m=torch.zeros_like(x0, dtype=torch.float32),
        base_state=base_opt.init(params),
    )


def global_sign_momentum_step(x0, m, x_tau_mean, gamma, cfg: DSMConfig):
    """Eqs. (6)-(8) in place on the flat buffers; returns (x0, m).

    The DSM kernel on the card, its plain version on the CPU.  With f32
    momentum the reference's jnp path and its kernel do the same f32
    arithmetic in the same order, so this one path stands for both.
    """
    if cfg.sign_mode != "sign":
        raise NotImplementedError(f"sign_mode={cfg.sign_mode!r} is not ported yet (ROADMAP.md)")
    return dsm_update(x0, m, x_tau_mean, gamma, eta=cfg.global_lr, beta1=cfg.beta1,
                      beta2=cfg.beta2, lam=cfg.weight_decay)


def make_local_phase(loss_fn: Callable, base_opt: BaseOptimizer, layout: FlatLayout):
    """``local_phase(state, tokens, gamma) -> losses (tau, W)``: tau local
    steps of every worker, in place on ``state.params`` / ``state.base_state``.

    ``tokens``: (W, tau, accum, B_micro, S).  Each local step runs every
    worker's forward and backward (gradients accumulated over ``accum``
    microbatches, then divided by ``accum``), then one base-optimizer update
    over all workers at step index ``state.inner + k``.
    """

    def local_phase(state: DSMState, tokens: torch.Tensor, gamma: float) -> torch.Tensor:
        W, tau, accum = tokens.shape[:3]
        losses = torch.empty(tau, W, dtype=torch.float32, device=state.params.device)
        for k in range(tau):
            state.grads.zero_()
            for w in range(W):
                leaves = layout.autograd_leaves(state.params[w], state.grads[w])
                loss_sum = torch.zeros((), dtype=torch.float32, device=losses.device)
                for a in range(accum):
                    loss = loss_fn(leaves, tokens[w, k, a])
                    loss.backward()
                    loss_sum = loss_sum + loss.detach()
                if accum > 1:
                    state.grads[w].div_(accum)
                losses[k, w] = loss_sum / accum
            base_opt.update(state.params, state.grads, state.base_state, gamma,
                            state.inner + k)
        return losses

    return local_phase


def make_dsm_step(loss_fn: Callable, base_opt: BaseOptimizer, cfg: DSMConfig,
                  schedule: Callable, layout: FlatLayout):
    """Build ``outer_step(state, tokens) -> (state, metrics)``.

    ``tokens``: (W, tau, accum, B_micro, S) int64 on the state's device.
    ``loss_fn(params, microbatch)`` takes a ``{path: tensor}`` params dict and
    one (B_micro, S) microbatch.  ``metrics`` holds 0-d tensors ``loss``,
    ``last_loss``, ``gamma`` and the ``(N_METRICS,)`` ``pack``.
    """
    check_ported(cfg)
    local_phase = make_local_phase(loss_fn, base_opt, layout)

    def outer_step(state: DSMState, tokens: torch.Tensor):
        gamma_t = schedule(state.t)          # fixed for the whole outer step
        gamma = float(gamma_t)
        losses = local_phase(state, tokens, gamma)

        # line 7: the worker mean, in f32 and cast back (as jnp.mean of bf16)
        x_tau = state.params.mean(dim=0, dtype=torch.float32).to(state.params.dtype)
        stat = OM.stat_sums(state.x0, state.m, x_tau, gamma, cfg.beta1)
        global_sign_momentum_step(state.x0, state.m, x_tau, gamma, cfg)

        # line 11: every worker restarts from x_{t+1,0}; AdamW state carries on
        state.params.copy_(state.x0.expand_as(state.params))
        state.t += 1
        state.inner += cfg.tau

        loss_mean, last_loss, spread = OM.loss_stats(losses)
        pack = OM.finish_pack(loss=loss_mean, last_loss=last_loss, gamma=gamma_t,
                              worker_spread=spread, stat_sums=stat,
                              n_elems=state.x0.numel())
        return state, {"loss": loss_mean, "gamma": gamma_t, "last_loss": last_loss,
                       "pack": pack}

    return outer_step
