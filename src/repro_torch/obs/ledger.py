"""Comm ledger: observed vs predicted collective bytes of one outer step
(the reference's ``repro.obs.ledger`` for the port's eager step).

The reference lowers its jitted step at startup and parses the collectives
out of the compiled HLO.  The port's step is eager: there is no compiled
program to read before it runs.  So the **observed** side is what
``distributed/comm.py``'s ``CommStats`` counted while the run's first outer
step ran, by call kind: every collective the port actually issued.  The
trainer takes the delta of the rank's stats over that round and emits the
record after it, where the reference emits it before the first step.

Classes: the scatter of worker chunks (``scatter_rows``, the
``all_to_all`` that replaced the reduce-scatter so that every owner sums
the dense mean in worker order) and the all-reduces are the reduce class;
the all-gathers (``all_gather_shards``, ``gather_workers``) the gather
class; anything else goes under ``other_kinds``.

Observed bytes are the bytes this rank SENT, as ``CommStats`` counts them,
not the reference's HLO result-shape bytes.  At full width (gpt2_small.FULL,
N = 123,882,240 bf16, W = 4 over 4 ranks, ZeRO) a rank sends 247,764,992 B
of worker chunks (its bf16 row padded to 4 chunks of 30,970,624 elements,
the one to itself included) and 61,941,248 B of its bf16 shard into the
all-gather; the reference's HLO counts the reduction's f32 result
(N/R x 4 B = 123,882,240 B as a reduce-scatter, half the port's) and the
all-gather's whole bf16 result (N x 2 B = 247,764,480 B, four times the
port's).  The predicted side keeps the reference's fields: the payload at
the reduce dtype's floor of 4 B per element and the ring model's wire bytes.
On a world of one, no collective runs: the record says so
(``degenerate_mesh``) and its ratios are None.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from repro_torch.obs.comm_model import (GATHER_CLASS, PHASES, REDUCE_CLASS,
                                        wire_bytes_for_payload)

# each collective of distributed/comm.py, by the class of collective it is
KIND_CLASS = {
    "scatter_rows": "reduce-scatter",
    "all_reduce_sum": "all-reduce",
    "all_reduce_min": "all-reduce",
    "all_gather_shards": "all-gather",
    "gather_workers": "all-gather",
    "gather_to_root": "gather",
    # the model group's (``distributed.tensor_parallel``; ``<name>@model``)
    "all_reduce_max": "all-reduce",
    "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
}


def stats_delta(before: Dict[str, Dict[str, int]],
                after: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """``{kind: {"calls", "bytes"}}`` of ``CommStats.as_dict()`` between two
    reads; kinds with no call in between are left out."""
    out = {}
    for kind, rec in after.items():
        old = before.get(kind, {})
        calls = rec["calls"] - old.get("calls", 0)
        if calls:
            out[kind] = {"calls": calls, "bytes": rec["bytes"] - old.get("bytes", 0)}
    return out


def observed_ledger(
    delta: Dict[str, Dict[str, int]],
    *,
    group_numels: Sequence[int],
    n_param_leaves: int,
    group_itemsizes: Sequence[int],
    algo: str,
    tau: int,
    phase: str,
    world: int,
    name: str = "outer_step",
) -> Dict[str, Any]:
    """The ledger record of one outer step whose collectives ``delta``
    counted (:func:`stats_delta`), against the analytic model.

    ``group_numels`` / ``group_itemsizes``: the global params x0 the phase
    moves, one entry per dtype group (``FlatLayout.group_numels`` and its
    dtypes' sizes): the payload adds each group's elements times its
    bytes, at the reduce dtype's floor of 4; ``phase``: one of ``PHASES``;
    ``world``: the ranks the step runs over.
    """
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    payload = sum(n * max(4, b) for n, b in zip(group_numels, group_itemsizes, strict=True))
    wire, rounds = wire_bytes_for_payload(payload, algo, tau)
    pred_reduce = payload if phase != "local" else 0
    pred_gather = payload if phase == "global_zero" else 0

    def of(cls):
        return {k: v for k, v in delta.items() if KIND_CLASS.get(k) in cls}

    reduce, gather = of(REDUCE_CLASS), of(GATHER_CLASS)
    other = {k: v for k, v in delta.items() if k not in reduce and k not in gather}
    obs_reduce = sum(v["bytes"] for v in reduce.values())
    obs_gather = sum(v["bytes"] for v in gather.values())
    degenerate = world <= 1

    def _ratio(obs: int, pred: int) -> Optional[float]:
        if pred <= 0 or degenerate:
            return None
        return obs / pred

    return {
        "name": name,
        "phase": phase,
        "algo": algo,
        "tau": int(tau),
        "n_param_leaves": int(n_param_leaves),
        "mesh_devices": int(world),
        "degenerate_mesh": degenerate,
        "predicted": {
            "payload_bytes": int(payload),
            "reduce_bytes": int(pred_reduce),
            "gather_bytes": int(pred_gather),
            "wire_bytes_per_outer": int(wire),
            "comm_rounds_per_outer": int(rounds),
        },
        "observed": {
            "source": "CommStats: bytes this rank sent in the run's first outer step",
            "reduce_ops": sum(v["calls"] for v in reduce.values()),
            "gather_ops": sum(v["calls"] for v in gather.values()),
            "other_ops": sum(v["calls"] for v in other.values()),
            "other_kinds": sorted(other),
            "reduce_bytes": int(obs_reduce),
            "gather_bytes": int(obs_gather),
            "by_kind": delta,
        },
        "ratio": {
            "reduce": _ratio(obs_reduce, pred_reduce),
            "gather": _ratio(obs_gather, pred_gather),
        },
    }
