"""Static analysis and sanitizers of the port, the reference's
``repro.analysis`` for eager PyTorch over c10d process groups.

Three layers:

  * ``collective_audit`` — run each outer step once under a dispatch mode
    that records every c10d op it issues, with its bytes and the line that
    issued it, and check them against the per-phase budgets of the
    analytic model (``obs.comm_model.phase_collective_budget``): one
    reduction round per tau local steps, none inside them.  The
    counterpart of the reference's ``hlo_audit``.
  * ``lint`` — RPR0xx AST rules for the eager bug classes nothing else
    catches statically: draws from the global generator, host syncs and
    Python branches on tensors in step-reachable code, mutable defaults.
    No torch import — runs anywhere, fast.
  * ``sanitize`` — opt-in runtime guards for the hot loop: no implicit host
    sync inside the step on the card, every returned tensor finite.

CLI: ``python -m repro_torch.analysis {audit,lint} [--json]``.

The package does NOT import torch at package level, so the lint layer stays
usable where torch is not installed.
"""

from repro_torch.analysis.lint import Finding, lint_paths, lint_source  # noqa: F401
