"""Fault tolerance for DSM training: seeded fault injection (``faults``) and
skip-round guards (``guards``).  The survivor-aware global step itself lives
in ``repro_torch.core.dsm`` (:func:`masked_worker_mean`)."""

from repro_torch.robustness.faults import FaultPlan, FaultRound, FaultSpec, apply_faults
from repro_torch.robustness.guards import (
    GuardState,
    init_guard,
    make_guarded_step,
    state_tensors,
    tree_all_finite,
)

__all__ = [
    "FaultPlan", "FaultRound", "FaultSpec", "apply_faults", "GuardState", "init_guard",
    "make_guarded_step", "state_tensors", "tree_all_finite",
]
