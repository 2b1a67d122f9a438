"""Training guards: skip-round protection around any outer step (the
reference's ``robustness/guards.py`` for the port's in-place states).

``make_guarded_step`` wraps an outer step ``f(state, *args) -> (state',
metrics)`` with device-side acceptance checks:

  * **non-finite update** — any NaN/inf in the candidate state (x0,
    momentum, per-worker params, base-optimizer state) rejects the round;
  * **loss spike** — a round loss above ``spike_factor`` x the running EMA of
    accepted-round losses rejects the round.

A rejected round is *skipped*: the previous state, the sign momentum ``m``
and the outer counter ``t`` included, is kept bit-intact and the trainer
moves on to the next batch.  The port's steps update their state in place,
so the wrapper snapshots the state's tensors before the step and selects
between the two with ``torch.where`` on the device.  A state's integer
counters (``t``, ``inner``) live on the host, so a state that has them costs
one host read of the verdict per round: :func:`settle_counters`, which the
trainer calls after the step, outside its sanitizer, as the reference reads
its rollback streak outside its transfer guard.

Over the ranks of a topology each rank checks the part of the state it
holds (its shard of each dtype group of x0 and m, or the whole group where
it is kept whole), and one all-reduce (MIN) of the verdict makes every rank
accept or reject the round together; each rank's snapshot and select stay
local, tensor by tensor of each group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.distributed import comm
from repro_torch.models.convert import state_fields
from repro_torch.obs.metrics import set_guard_flag

F32, I32 = torch.float32, torch.int32


class GuardState(NamedTuple):
    ema: torch.Tensor         # f32 EMA of accepted-round losses
    seen: torch.Tensor        # i32 accepted rounds (0 -> EMA uninitialized)
    bad_streak: torch.Tensor  # i32 consecutive rejected rounds
    skipped: torch.Tensor     # i32 total rejected rounds


def init_guard(device=None) -> GuardState:
    return GuardState(
        ema=torch.zeros((), dtype=F32, device=device),
        seen=torch.zeros((), dtype=I32, device=device),
        bad_streak=torch.zeros((), dtype=I32, device=device),
        skipped=torch.zeros((), dtype=I32, device=device),
    )


def state_tensors(state) -> list:
    """Every tensor of a training state in a fixed order, less scratch."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for _, v in state_fields(state) for t in state_tensors(v)]


def _counters(state) -> dict:
    """The host integer fields of a dataclass state (``t``, ``inner``)."""
    if not dataclasses.is_dataclass(state):
        return {}
    return {k: v for k, v in state_fields(state) if isinstance(v, int)}


def tree_all_finite(state) -> torch.Tensor:
    """0-d bool: every element of every floating tensor is finite."""
    oks = [torch.isfinite(t).all() for t in state_tensors(state) if t.is_floating_point()]
    return torch.stack(oks).all() if oks else torch.ones((), dtype=torch.bool)


def make_guarded_step(step_fn: Callable, **kw) -> Callable:
    """Wrap ``step_fn(state, *args)`` into
    ``guarded(state, guard, *args) -> (state', guard', metrics)``: the
    device step of :func:`make_guarded_device_step` (same keywords), then
    :func:`settle_counters`."""
    device_step = make_guarded_device_step(step_fn, **kw)

    def guarded(state, guard: GuardState, *args):
        new_state, new_guard, metrics, counters = device_step(state, guard, *args)
        settle_counters(new_state, metrics, counters)
        return new_state, new_guard, metrics

    return guarded


def settle_counters(state, metrics: dict, counters: dict) -> None:
    """Put back the host counters of a rejected round: the one host read of
    the verdict, and none when the state has no host counters."""
    if counters and not bool(metrics["guard_ok"]):
        for name, value in counters.items():
            setattr(state, name, value)


def make_guarded_device_step(step_fn: Callable, *, nonfinite: bool = True,
                             spike_factor: float = 0.0, ema_beta: float = 0.9,
                             topo=None) -> Callable:
    """``device_step(state, guard, *args) -> (state', guard', metrics,
    counters)``: the guarded round with no host read.  A rejected round's
    tensors are restored on the device; its host counters stay advanced
    until :func:`settle_counters` puts back ``counters``, the values from
    before the step.

    ``spike_factor <= 0`` disables spike detection; ``nonfinite=False``
    disables the full-state finiteness check (a non-finite loss always
    rejects).  The first accepted round seeds the EMA with its loss.
    ``topo``: the state is one rank's part, and the ranks agree on one
    verdict (the loss is the gathered one, equal on every rank).
    """
    if spike_factor < 0:
        raise ValueError("spike_factor must be >= 0 (0 disables)")

    def device_step(state, guard: GuardState, *args):
        kept = [t.clone() for t in state_tensors(state)]
        counters = _counters(state)
        new_state, metrics = step_fn(state, *args)
        loss = torch.as_tensor(metrics["loss"], dtype=F32, device=guard.ema.device)
        ok = torch.isfinite(loss)
        if nonfinite:
            ok = ok & tree_all_finite(new_state)
            if topo is not None:
                ok = comm.all_reduce(ok.to(I32), topo, "min").to(torch.bool)
        if spike_factor > 0:
            spike = (guard.seen > 0) & (loss > spike_factor * guard.ema)
            ok = ok & ~spike

        ema_next = torch.where(guard.seen == 0, loss,
                               ema_beta * guard.ema + (1.0 - ema_beta) * loss)
        new_guard = GuardState(
            ema=torch.where(ok, ema_next, guard.ema),
            seen=guard.seen + ok.to(I32),
            bad_streak=torch.where(ok, torch.zeros_like(guard.bad_streak),
                                   guard.bad_streak + 1),
            skipped=guard.skipped + (~ok).to(I32),
        )
        for buf, old in zip(state_tensors(new_state), kept):
            torch.where(ok, buf, old, out=buf)
        metrics = dict(metrics, guard_ok=ok, bad_streak=new_guard.bad_streak,
                       skipped_rounds=new_guard.skipped)
        if "pack" in metrics:
            metrics["pack"] = set_guard_flag(metrics["pack"], ok)
        return new_state, new_guard, metrics, counters

    return device_step
