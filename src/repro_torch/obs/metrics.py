"""Metric pack of the DSM outer step: the reference's 12-slot f32 pack
(``repro.obs.metrics``), computed with plain PyTorch on the flat buffers.

Pack layout (d = number of global parameters):
  loss, last_loss, gamma, pg_l1 = ||Delta||_1, pg_l2 = ||Delta||_2,
  pg_density = ||Delta||_1^2 / (d ||Delta||_2^2), sign_agree = fraction of
  coordinates where sign(m) * sign(Delta) > 0, m_l1 = ||m||_1,
  update_cos = cos(u, m), worker_spread = std over workers of the per-worker
  mean loss, survivor_frac (sum of the survivor weights / W; 1.0 dense),
  guard_ok (the guard's verdict; 1.0 unguarded),
with Delta = (x_0 - x_tau) / gamma and u = beta1 m + (1 - beta1) Delta.
"""

from __future__ import annotations

import torch

F32 = torch.float32

METRIC_NAMES = (
    "loss", "last_loss", "gamma", "pg_l1", "pg_l2", "pg_density", "sign_agree",
    "m_l1", "update_cos", "worker_spread", "survivor_frac", "guard_ok",
)
IDX = {name: i for i, name in enumerate(METRIC_NAMES)}
N_METRICS = len(METRIC_NAMES)

STAT_SUMS = ("pg_l1", "pg_sq", "m_l1", "sign_agree_count", "u_dot_m", "u_sq", "m_sq")
N_STAT_SUMS = len(STAT_SUMS)

_EPS = 1e-12


def loss_stats(losses: torch.Tensor):
    """``(loss, last_loss, worker_spread)`` from the ``(tau, W)`` loss matrix."""
    per_worker = losses.mean(dim=0)
    s = torch.stack([per_worker, losses[-1], per_worker * per_worker]).mean(dim=1)
    spread = torch.sqrt(torch.clamp(s[2] - s[0] * s[0], min=0.0))
    return s[0], s[1], spread


def stat_sums(x0: torch.Tensor, m: torch.Tensor, x_tau: torch.Tensor, gamma,
              beta1: float) -> torch.Tensor:
    """``(N_STAT_SUMS,)`` f32 sums over the flat global buffers."""
    g = torch.tensor(float(gamma), dtype=F32, device=x0.device)
    b1 = torch.tensor(beta1, dtype=F32)
    omb1 = float(1.0 - b1)            # the reference folds 1 - beta1 in f32 here
    mf = m.to(F32)
    delta = (x0.to(F32) - x_tau.to(F32)) / g
    u = float(b1) * mf + omb1 * delta
    agree = ((mf > 0) & (delta > 0)) | ((mf < 0) & (delta < 0))
    return torch.stack([
        delta.abs().sum(),
        (delta * delta).sum(),
        mf.abs().sum(),
        agree.sum().to(F32),
        (u * mf).sum(),
        (u * u).sum(),
        (mf * mf).sum(),
    ])


def finish_pack(*, loss, last_loss, gamma, worker_spread, stat_sums: torch.Tensor,
                n_elems: int, survivor_frac=None) -> torch.Tensor:
    """Assemble the ``(N_METRICS,)`` f32 pack from the raw sums."""
    l1, sq, m_l1, agree, u_dot_m, u_sq, m_sq = stat_sums.unbind(0)
    dev = stat_sums.device
    n = torch.tensor(float(n_elems), dtype=F32, device=dev)
    density = (l1 * l1) / (n * sq + _EPS)
    cos = u_dot_m / (torch.sqrt(u_sq) * torch.sqrt(m_sq) + _EPS)

    def f32(x):
        return torch.as_tensor(x, dtype=F32).to(dev)

    one = torch.ones((), dtype=F32, device=dev)
    sf = one if survivor_frac is None else f32(survivor_frac)
    return torch.stack([
        f32(loss), f32(last_loss), f32(gamma), l1, torch.sqrt(sq), density, agree / n,
        m_l1, cos, f32(worker_spread), sf, one,
    ])


def set_guard_flag(pack: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """The pack with the guard's verdict in its ``guard_ok`` slot (a new
    tensor; a device-side write, no host read)."""
    out = pack.clone()
    out[IDX["guard_ok"]] = ok.to(F32)
    return out
