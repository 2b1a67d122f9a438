"""The analytic communication model that the comm ledger predicts from and
the collective audit (``repro_torch.analysis.collective_audit``) takes its
budgets from: the port's own copy of the round model of the reference's
``benchmarks/comm.py`` (``wire_bytes_for_payload``, ``LOCAL_STEP_ALGOS``,
the collective classes and phases and ``phase_collective_budget``), which
the port may not import.
"""

from __future__ import annotations

LOCAL_STEP_ALGOS = ("dsm", "slowmo", "signed_slowmo", "lookahead",
                    "global_adamw", "local_avg")


def wire_bytes_for_payload(payload_bytes: int, algo: str, tau: int,
                           param_bytes: int = 2) -> tuple:
    """``(wire_bytes_per_outer, comm_rounds_per_outer)`` for a raw payload:
    one all-reduce ~ 2x payload on the ring, per logical round."""
    if algo in LOCAL_STEP_ALGOS:
        return 2 * payload_bytes, 1        # one model all-reduce / outer step
    if algo == "perstep":
        return 2 * payload_bytes * tau, tau  # gradient all-reduce every step
    if algo == "mv_signsgd":
        return payload_bytes // (8 * param_bytes) * 2, 1  # 1-bit signs each way
    raise ValueError(algo)


# A logical worker reduction is a reduce-scatter or an all-reduce; the
# gather of x_{t+1,0} is an all-gather.
REDUCE_CLASS = ("all-reduce", "reduce-scatter")
GATHER_CLASS = ("all-gather",)

PHASES = ("local", "global_dense", "global_zero")


def phase_collective_budget(phase: str, *, n_param_leaves: int, payload_bytes: int,
                            n_metric_reductions: int = 2,
                            payload_slack: float = 1.5) -> dict:
    """LOGICAL per-phase budget, derived from the round model above (the
    reference's ``benchmarks/comm.py:124``, line for line).

    One model-payload reduction round per outer step for every local-step
    algorithm and none inside the tau local steps: the paper's
    communication claim.  The reference's XLA lowers a round leaf by leaf,
    so its op ceilings multiply the rounds by ``n_param_leaves`` (+
    ``n_metric_reductions`` scalar reductions of the loss metrics); the
    payload ceilings multiply the payload by ``payload_slack``, with a
    1 KiB floor that absorbs the metric scalars.

      * ``local``        — the tau local steps: ZERO collectives of any kind.
      * ``global_dense`` — replicated global step: one reduction round.
      * ``global_zero``  — ZeRO-sharded global step: one reduction round
        plus one gather round (x_{t+1,0}).
    """
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    reduce_rounds = 0 if phase == "local" else 1
    gather_rounds = 1 if phase == "global_zero" else 0
    pay = int(payload_slack * payload_bytes) + 1024
    return {
        "phase": phase,
        "reduce_rounds": reduce_rounds,
        "gather_rounds": gather_rounds,
        "max_reduce_ops": reduce_rounds * (n_param_leaves + n_metric_reductions),
        "max_gather_ops": gather_rounds * (n_param_leaves + n_metric_reductions),
        "max_reduce_bytes": reduce_rounds * pay,
        "max_gather_bytes": gather_rounds * pay,
        "reduce_class": list(REDUCE_CLASS),
        "gather_class": list(GATHER_CLASS),
    }
