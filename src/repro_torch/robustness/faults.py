"""Deterministic, seeded fault injection for the DSM outer loop (a copy of
the reference's ``robustness/faults.py`` on torch tensors).

A :class:`FaultPlan` pre-draws, from one numpy seed, which workers fail in
which outer round and *how*:

  * **drop**     — the worker's contribution never arrives; the survivor-
    aware global step excludes it from the x_tau mean and the worker
    re-syncs from x_{t+1,0} at the next round (Algorithm 1's broadcast).
  * **straggle** — the worker misses the deadline and delivers a stale
    iterate (its round-start x_{t,0}: a zero pseudo-gradient contribution
    that dilutes the mean but never poisons it).
  * **corrupt**  — the delivered contribution is NaN; the global step must
    detect it (per-worker finiteness mask): corruption is never announced.

The masks are numpy draws seeded by ``(seed, t)`` per round, exactly the
reference's, so a faulty run of the port sees the reference's faults
element for element, and a resumed run sees the uninterrupted run's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.groups import each


class FaultRound(NamedTuple):
    """One outer round's faults as ``(W,)`` bool tensors on the state's device."""

    survivors: torch.Tensor  # True where the contribution arrives at all
    stale: torch.Tensor      # True where the contribution is the stale x_{t,0}
    corrupt: torch.Tensor    # True where the contribution is NaN-poisoned


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-round, per-worker fault probabilities + the plan seed."""

    p_drop: float = 0.0
    p_straggle: float = 0.0
    p_corrupt: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for name in ("p_drop", "p_straggle", "p_corrupt"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} must lie in [0, 1]")

    _KEYS = {"drop": "p_drop", "straggle": "p_straggle", "nan": "p_corrupt",
             "corrupt": "p_corrupt", "seed": "seed"}

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        """Parse the CLI form ``"drop=0.25,straggle=0.1,nan=0.05,seed=3"``."""
        kw = {}
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"bad fault spec item {item!r} in {spec!r}")
            k, v = item.split("=", 1)
            k = k.strip().lower()
            if k not in cls._KEYS:
                raise ValueError(f"unknown fault key {k!r}; have {sorted(cls._KEYS)}")
            field = cls._KEYS[k]
            kw[field] = int(v) if field == "seed" else float(v)
        return cls(**kw)


class FaultPlan:
    """Pre-drawn ``(steps, W)`` fault masks; ``round(t, device)`` yields the
    round's :class:`FaultRound`.  Rounds beyond ``steps`` are fault-free.

    Each round's draws are seeded by ``(spec.seed, t)``, not consumed from
    one stream, so round t's faults do not depend on the plan's horizon."""

    def __init__(self, n_workers: int, steps: int, spec: FaultSpec):
        if n_workers < 1 or steps < 0:
            raise ValueError("need n_workers >= 1 and steps >= 0")
        self.n_workers = n_workers
        self.steps = steps
        self.spec = spec
        self.drop = np.zeros((steps, n_workers), bool)
        self.stale = np.zeros((steps, n_workers), bool)
        self.corrupt = np.zeros((steps, n_workers), bool)
        for t in range(steps):
            rng = np.random.default_rng((spec.seed, t))
            self.drop[t] = rng.random(n_workers) < spec.p_drop
            self.stale[t] = rng.random(n_workers) < spec.p_straggle
            self.corrupt[t] = rng.random(n_workers) < spec.p_corrupt

    @classmethod
    def from_spec(cls, spec: Union[str, FaultSpec], n_workers: int, steps: int) -> "FaultPlan":
        if isinstance(spec, str):
            spec = FaultSpec.parse(spec)
        return cls(n_workers, steps, spec)

    def round(self, t: int, device=None) -> FaultRound:
        if 0 <= t < self.steps:
            drop, stale, corrupt = self.drop[t], self.stale[t], self.corrupt[t]
        else:
            drop = stale = corrupt = np.zeros((self.n_workers,), bool)
        return FaultRound(*(torch.from_numpy(np.array(a)).to(device)
                            for a in (~drop, stale, corrupt)))

    def dropped_frac(self) -> float:
        """Fraction of (round, worker) contributions dropped."""
        return float(self.drop.mean()) if self.drop.size else 0.0


def apply_faults(params_w, x0, faults: FaultRound):
    """The delivered ``(W, N)`` iterates under the round's faults (a new
    tensor, or Groups of them for Groups buffers): stale workers deliver the
    round-start ``x0`` (N,), corrupt workers NaN.  Dropped workers are left
    as they are: excluding them is the aggregator's job (the survivor
    weights of the masked mean)."""
    return each(lambda p, x: _apply_faults(p, x, faults), params_w, x0)


def _apply_faults(params_w: torch.Tensor, x0: torch.Tensor, faults: FaultRound) -> torch.Tensor:
    out = torch.where(faults.stale[:, None], x0[None], params_w)
    return torch.where(faults.corrupt[:, None], torch.full((), float("nan"), dtype=out.dtype,
                                                           device=out.device), out)
