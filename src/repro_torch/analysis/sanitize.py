"""Runtime sanitizers for the training hot loop (opt-in: ``--sanitize``,
``--sanitize-nans``), the reference's ``repro.analysis.sanitize`` for the
port's eager step.

  * ``no_implicit_host_sync(device)`` — ``torch.cuda.set_sync_debug_mode
    ("error")`` around the step call: any operation that synchronises the
    stream with the host (a stray ``float()`` or ``.item()`` on a device
    tensor, a copy from or to pageable host memory) raises
    :class:`SanitizeError` instead of silently stalling the card.  A no-op
    on the CPU, as the reference's transfer guard is on its CPU backend.
    The collectives' host copies under ``gloo`` are exempt, in one place
    (``distributed/comm.py``): that backend runs on host buffers by design.
  * ``debug_nans(step, **trees)`` — the counterpart of ``jax_debug_nans``,
    the chaos tier: every floating tensor the step returned, in its state
    and its metrics, must be finite; with faults injected, the survivor
    mask must keep them so.  One device-side reduction per tensor and one
    host read per round, made only when the sanitizer is on.

The reference's ``RecompilationCounter`` has no counterpart: an eager step
compiles nothing, so ``run_training`` reports ``step_compiles: None``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import torch

from repro_torch.models.convert import state_fields


class SanitizeError(RuntimeError):
    """A runtime sanitizer tripped (host sync, NaN)."""


@contextlib.contextmanager
def no_implicit_host_sync(device: Any = "cpu", enabled: bool = True) -> Iterator[None]:
    """Disallow operations that synchronise ``device``'s stream with the
    host inside the block (the previous mode is restored on exit)."""
    if not enabled or torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        if "synchronizing CUDA operation" not in str(e):
            raise
        raise SanitizeError(f"implicit host sync inside the outer step: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def named_float_tensors(obj: Any, prefix: str) -> list:
    """``[(dotted name, tensor)]`` of every floating tensor in a training
    state, guard state or metrics dict (a state's scratch buffers left out)."""
    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)] if obj.is_floating_point() else []
    return [pair for name, v in state_fields(obj)
            for pair in named_float_tensors(v, f"{prefix}.{name}")]


def debug_nans(step: int, **trees: Any) -> None:
    """Raise :class:`SanitizeError` naming the first non-finite tensor of
    ``trees`` (for example ``state=..., metrics=...``) after outer step
    ``step``."""
    named = [pair for key, tree in trees.items() for pair in named_float_tensors(tree, key)]
    if not named:
        return
    flags = [torch.isfinite(t).all() for _, t in named]
    on_card = [f for f in flags if f.is_cuda]
    read = iter(torch.stack(on_card).cpu().tolist() if on_card else ())
    finite = [next(read) if f.is_cuda else bool(f) for f in flags]
    if not all(finite):
        bad = named[finite.index(False)][0]
        raise SanitizeError(f"non-finite values in {bad} after outer step {step}: a NaN "
                            "escaped the survivor mask")
