"""Runtime sanitizers of the port's training loop (``sanitize``), the
reference's ``repro.analysis.sanitize`` for eager PyTorch.  The reference's
static layers (the HLO auditor, the RPR lint) have no counterpart yet."""
