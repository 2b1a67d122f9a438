"""Distributed Sign Momentum with local steps — the paper's Algorithm 1, on
flat ``(W, N)`` buffers.

One outer step t:

  1. every worker i runs tau local steps of the base optimizer (AdamW):
         x^{(i)}_{t,k+1} = x^{(i)}_{t,k} - gamma_t * d^{(i)}_{t,k}
  2. the worker mean  x_{t,tau} = mean_i x^{(i)}_{t,tau}  (f32, cast back)
  3. the global sign-momentum step on Delta_t = (x_{t,0} - x_{t,tau}) / gamma_t
     (eqs. 6-8), then every worker restarts from x_{t+1,0}.

The W workers are simulated on one device: a Python loop runs each worker's
forward and backward, and the base optimizer then updates all workers at
once (with AdamW, one launch of the AdamW kernel).  The global step is the
DSM kernel on the card for the deterministic sign; the randomized signs of
eqs. 9/10 (``sign_mode`` ``rand_pm`` / ``rand_zero``) run in plain PyTorch.

The port covers the dense, fault-free case; fault masks, ZeRO sharding and
the device-parallel local phase raise ``NotImplementedError`` (ROADMAP.md).

Instances (paper §2 "Algorithm instances"):
  * tau=1, beta1=beta2=beta, lam=0    -> signSGD with momentum (eq. 3)
  * n=1 (W=1)                         -> signed Lookahead (+ decoupled wd)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.base_opt import BaseOptimizer
from repro_torch.kernels.dsm_update import dsm_update, dsm_update_plain, sign_like_jnp
from repro_torch.models.convert import FlatLayout
from repro_torch.obs import metrics as OM

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
    # host scalar into a product with its reciprocal on the card
    return torch.tensor(c, dtype=F32, device=u.device)


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


def global_sign_momentum_step(x0, m, x_tau_mean, gamma, cfg: DSMConfig,
                              rng: Optional[torch.Generator] = None,
                              uniform: Optional[torch.Tensor] = None):
    """Eqs. (6)-(8) in place on the flat buffers; returns (x0, m).

    ``sign_mode="sign"``: the DSM kernel on the card, its plain version on
    the CPU.  With f32 momentum the reference's jnp path and its kernel do
    the same f32 arithmetic in the same order, so this one path stands for
    both.  The randomized signs draw their f32 uniforms over the flat (N,)
    buffer from ``rng`` (or take ``uniform``).
    """
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


def worker_grads(loss_fn: Callable, layout: FlatLayout, params: torch.Tensor,
                 grads: torch.Tensor, tokens: torch.Tensor, losses: torch.Tensor) -> None:
    """Every worker's forward and backward, in place into ``grads[w]`` of the
    ``(W, N)`` buffer (zeroed first): worker w at ``params[w]``, or at the
    one ``(N,)`` params, on its microbatches ``tokens[w]`` (accum, B_micro,
    S), gradients summed then divided by accum; its mean loss into
    ``losses[w]``."""
    grads.zero_()
    accum = tokens.shape[1]
    for w in range(grads.shape[0]):
        leaves = layout.autograd_leaves(params if params.dim() == 1 else params[w], grads[w])
        loss_sum = torch.zeros((), dtype=F32, device=losses.device)
        for a in range(accum):
            loss = loss_fn(leaves, tokens[w, a])
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        if accum > 1:
            grads[w].div_(accum)
        losses[w] = loss_sum / accum


def make_local_phase(loss_fn: Callable, base_opt: BaseOptimizer, layout: FlatLayout):
    """``local_phase(state, tokens, gamma) -> losses (tau, W)``: tau local
    steps of every worker, in place on ``state.params`` / ``state.base_state``.

    ``tokens``: (W, tau, accum, B_micro, S).  Each local step runs every
    worker's forward and backward (:func:`worker_grads`), then one
    base-optimizer update over all workers at step index ``state.inner + k``.
    """

    def local_phase(state, tokens: torch.Tensor, gamma: float) -> torch.Tensor:
        tau, n_workers = tokens.shape[1], tokens.shape[0]
        losses = torch.empty(tau, n_workers, dtype=F32, device=state.params.device)
        for k in range(tau):
            worker_grads(loss_fn, layout, state.params, state.grads, tokens[:, k], losses[k])
            base_opt.update(state.params, state.grads, state.base_state, gamma,
                            state.inner + k)
        return losses

    return local_phase


def make_dsm_step(loss_fn: Callable, base_opt: BaseOptimizer, cfg: DSMConfig,
                  schedule: Callable, layout: FlatLayout):
    """Build ``outer_step(state, tokens[, rng]) -> (state, metrics)``.

    ``tokens``: (W, tau, accum, B_micro, S) int64 on the state's device.
    ``loss_fn(params, microbatch)`` takes a ``{path: tensor}`` params dict and
    one (B_micro, S) microbatch.  ``rng``: the ``torch.Generator`` on the
    state's device that the randomized signs draw from (unused by
    ``sign_mode="sign"``).  ``metrics`` holds 0-d tensors ``loss``,
    ``last_loss``, ``gamma`` and the ``(N_METRICS,)`` ``pack``.
    """
    check_ported(cfg)
    local_phase = make_local_phase(loss_fn, base_opt, layout)

    def outer_step(state: DSMState, tokens: torch.Tensor,
                   rng: Optional[torch.Generator] = None):
        gamma_t = schedule(state.t)          # fixed for the whole outer step
        gamma = float(gamma_t)
        losses = local_phase(state, tokens, gamma)

        # line 7: the worker mean, in f32 and cast back (as jnp.mean of bf16)
        x_tau = state.params.mean(dim=0, dtype=torch.float32).to(state.params.dtype)
        stat = OM.stat_sums(state.x0, state.m, x_tau, gamma, cfg.beta1)
        global_sign_momentum_step(state.x0, state.m, x_tau, gamma, cfg, rng)

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


# ---------------------------------------------------------------------------
# Convenience instances
# ---------------------------------------------------------------------------

def signsgd_momentum_config(beta: float) -> DSMConfig:
    """tau=1, beta1=beta2=beta, lam=0: exactly eq. (3) signSGD w/ momentum."""
    return DSMConfig(tau=1, beta1=beta, beta2=beta, weight_decay=0.0)


def signed_lookahead_config(tau: int, beta: float, weight_decay: float = 0.0) -> DSMConfig:
    """n=1 instance (§4.1 ablation): signed Lookahead with decoupled wd."""
    return DSMConfig(tau=tau, beta1=beta, beta2=beta, weight_decay=weight_decay)
