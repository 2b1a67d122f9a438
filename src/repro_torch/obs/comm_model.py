"""The analytic communication model that the comm ledger predicts from: the
port's own copy of the round model of the reference's ``benchmarks/comm.py``
(``wire_bytes_for_payload``, ``LOCAL_STEP_ALGOS``, and the collective classes
and phases of its per-phase budgets), which the port may not import.
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
