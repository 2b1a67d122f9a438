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

The step keeps its metrics on the device; :func:`fetch_metrics` copies the
rounds since the last sync point to the host in one copy, and
:func:`decode_metrics_row` turns one round's into a ``scalars.csv`` row
(``repro_torch.obs.sinks``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.groups import Groups

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


def stat_sums(x0, m, x_tau, gamma, beta1: float) -> torch.Tensor:
    """``(N_STAT_SUMS,)`` f32 sums over the flat global buffers (over every
    group of Groups buffers, each group's sums added in group order)."""
    if isinstance(x0, Groups):
        sums = [stat_sums(*g, gamma, beta1) for g in zip(x0, m, x_tau, strict=True)]
        return functools.reduce(torch.add, sums)
    g = torch.full((), float(gamma), dtype=F32, device=x0.device)
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
    n = torch.full((), float(n_elems), dtype=F32, device=dev)
    density = (l1 * l1) / (n * sq + _EPS)
    cos = u_dot_m / (torch.sqrt(u_sq) * torch.sqrt(m_sq) + _EPS)

    one = torch.ones((), dtype=F32, device=dev)
    sf = one if survivor_frac is None else _f32(survivor_frac, dev)
    return torch.stack([
        _f32(loss, dev), _f32(last_loss, dev), _f32(gamma, dev), l1, torch.sqrt(sq), density,
        agree / n, m_l1, cos, _f32(worker_spread, dev), sf, one,
    ])


def _f32(x, dev) -> torch.Tensor:
    """0-d f32 on ``dev``; a host value is filled in on the device, since a
    copy from the host would synchronise the stream."""
    if isinstance(x, torch.Tensor) and x.device.type == dev.type:
        return x.to(F32)
    return torch.full((), float(x), dtype=F32, device=dev)


def minimal_pack(loss, gamma=None) -> torch.Tensor:
    """Pack for algorithms without global-state instrumentation (the
    baselines): loss (+ gamma when known), NaN for the DSM-only entries."""
    dev = loss.device if isinstance(loss, torch.Tensor) else torch.device("cpu")
    vals = [torch.full((), math.nan, dtype=F32, device=dev)] * N_METRICS
    vals[IDX["loss"]] = _f32(loss, dev)
    if gamma is not None:
        vals[IDX["gamma"]] = _f32(gamma, dev)
    vals[IDX["survivor_frac"]] = vals[IDX["guard_ok"]] = torch.ones((), dtype=F32, device=dev)
    return torch.stack(vals)


def set_guard_flag(pack: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """The pack with the guard's verdict in its ``guard_ok`` slot (a new
    tensor; a device-side write, no host read)."""
    out = pack.clone()
    out[IDX["guard_ok"]] = ok.to(F32)
    return out


# what decode_metrics_row reads of a round's metrics dict without a pack
_ROW_KEYS = ("loss", "last_loss", "gamma", "guard_ok")


def fetch_metrics(rounds: list) -> list:
    """Host copies (numpy) of what :func:`decode_metrics_row` reads of each
    round's metrics dict: the pack of a DSM-family round, else its
    ``_ROW_KEYS``.  The entries on the card are cast to f32 there and
    concatenated, so every round since the last sync point comes over in
    ONE device-to-host copy; host values and CPU tensors are read as they
    are."""
    want = [("pack",) if "pack" in m else tuple(k for k in _ROW_KEYS if k in m)
            for m in rounds]
    on_card = [m[k].reshape(-1).to(F32) for m, keys in zip(rounds, want) for k in keys
               if isinstance(m[k], torch.Tensor) and m[k].is_cuda]
    host = torch.cat(on_card).cpu().numpy() if on_card else None
    pos, out = 0, []
    for m, keys in zip(rounds, want):
        row = {}
        for k in keys:
            v = m[k]
            if isinstance(v, torch.Tensor) and v.is_cuda:
                row[k] = host[pos:pos + v.numel()].reshape(v.shape)
                pos += v.numel()
            else:
                row[k] = np.asarray(v)
        out.append(row)
    return out


def decode_metrics_row(fetched: dict) -> np.ndarray:
    """Host-side: one scalars.csv row (float64) from a fetched round.

    DSM-family steps carry the full pack; baseline algorithms get the loss /
    last_loss / gamma (+ guard verdict) slots with NaN elsewhere."""
    if "pack" in fetched:
        return np.asarray(fetched["pack"], np.float64).reshape(-1)
    row = np.full((N_METRICS,), np.nan)
    for name in _ROW_KEYS:
        if name in fetched:
            row[IDX[name]] = float(np.asarray(fetched[name], np.float64))
    return row
