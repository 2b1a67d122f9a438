"""Summarize / diff run directories (``python -m repro_torch.obs summarize``).

Reads the sinks that ``repro_torch.obs.sinks.RunWriter`` writes, or the
reference's (the format is one) — manifest, events.jsonl, scalars.csv —
and renders the reference's compact report: run identity, scalar
trajectory (first / last / best, including the sign-agreement and density
metrics the paper's dynamics story turns on), per-phase wall-time spans,
the observed-vs-predicted comm ledger, and throughput.  The identity line
shows whichever framework version the manifest holds (``torch_version`` or
the reference's ``jax_version``).  Pure host code.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from repro_torch.obs.sinks import read_run

# metrics the renderer highlights, in display order
_KEY_METRICS = ("loss", "pg_l1", "pg_l2", "pg_density", "sign_agree",
                "m_l1", "update_cos", "worker_spread", "survivor_frac")


def _finite(v: Any) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


def _dedupe_by_step(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Keep the LAST row for each step (resumed runs re-log the boundary
    step), ordered by step."""
    by_step: Dict[int, Dict[str, Any]] = {}
    for row in rows:
        by_step[row["step"]] = row
    return [by_step[s] for s in sorted(by_step)]


def summarize_run(run_dir: str) -> Dict[str, Any]:
    """Machine-readable summary of one run directory."""
    manifest, events, rows = read_run(run_dir)
    rows = _dedupe_by_step(rows)

    scalars: Dict[str, Dict[str, Any]] = {}
    for name in _KEY_METRICS:
        series = [(r["step"], _finite(r.get(name))) for r in rows]
        series = [(s, v) for s, v in series if v is not None]
        if not series:
            continue
        vals = [v for _, v in series]
        best_step, best = min(series, key=lambda sv: sv[1])
        scalars[name] = {
            "first": vals[0],
            "last": vals[-1],
            "min": best,
            "min_step": best_step,
            "max": max(vals),
            "n": len(vals),
        }

    spans: Dict[str, Dict[str, float]] = {}
    for ev in events:
        if ev.get("kind") != "span":
            continue
        nm = ev.get("name", "?")
        sec = _finite(ev.get("seconds")) or 0.0
        n = int(ev.get("n", 1) or 1)
        agg = spans.setdefault(nm, {"seconds": 0.0, "count": 0})
        agg["seconds"] += sec
        agg["count"] += n
    for agg in spans.values():
        agg["ms_per"] = 1e3 * agg["seconds"] / max(agg["count"], 1)

    ledger = None
    finished = None
    resumes = 0
    for ev in events:
        kind = ev.get("kind")
        if kind == "comm_ledger":
            ledger = ev
        elif kind == "finished":
            finished = ev
        elif kind == "resumed":
            resumes += 1

    throughput: Dict[str, Any] = {}
    if finished is not None:
        for k in ("steps", "wall_s", "steps_per_s", "tokens", "tokens_per_s"):
            v = _finite(finished.get(k))
            if v is not None:
                throughput[k] = v

    return {
        "run_dir": run_dir,
        "run_name": manifest.get("run_name"),
        "git_sha": manifest.get("git_sha"),
        "jax_version": manifest.get("jax_version"),
        "torch_version": manifest.get("torch_version"),
        "backend": manifest.get("backend"),
        "mesh": manifest.get("mesh"),
        "algorithm": (manifest.get("settings") or {}).get("algorithm"),
        "steps_logged": len(rows),
        "first_step": rows[0]["step"] if rows else None,
        "last_step": rows[-1]["step"] if rows else None,
        "resumes": resumes,
        "scalars": scalars,
        "spans": spans,
        "comm_ledger": ledger,
        "throughput": throughput,
    }


def _fmt(v: Any, nd: int = 4) -> str:
    f = _finite(v)
    if f is None:
        return "-"
    if f != 0 and (abs(f) >= 1e5 or abs(f) < 1e-3):
        return f"{f:.3e}"
    return f"{f:.{nd}f}"


def _fmt_bytes(v: Any) -> str:
    f = _finite(v)
    if f is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(f) < 1024 or unit == "GiB":
            return f"{f:.1f} {unit}" if unit != "B" else f"{int(f)} B"
        f /= 1024
    return f"{f:.1f} GiB"


def render(summary: Dict[str, Any]) -> str:
    """Human-readable report for one summarized run."""
    lines: List[str] = []
    lines.append(f"run      {summary.get('run_name') or summary['run_dir']}")
    ident = []
    for key in ("algorithm", "backend", "jax_version", "torch_version"):
        if summary.get(key):
            ident.append(f"{key}={summary[key]}")
    if summary.get("git_sha"):
        ident.append(f"git={summary['git_sha'][:10]}")
    mesh = summary.get("mesh")
    if mesh:
        shape = "x".join(f"{k}:{v}" for k, v in (mesh.get("shape") or {}).items())
        ident.append(f"mesh={shape}")
    if ident:
        lines.append("         " + "  ".join(ident))
    span_rng = (summary.get("first_step"), summary.get("last_step"))
    lines.append(
        f"steps    {summary['steps_logged']} logged"
        + (f" (outer {span_rng[0]}..{span_rng[1]})" if span_rng[0] is not None else "")
        + (f", {summary['resumes']} resume(s)" if summary.get("resumes") else ""))

    if summary["scalars"]:
        lines.append("")
        lines.append(f"{'metric':<14}{'first':>12}{'last':>12}{'min':>12}  @step")
        for name in _KEY_METRICS:
            s = summary["scalars"].get(name)
            if not s:
                continue
            lines.append(
                f"{name:<14}{_fmt(s['first']):>12}{_fmt(s['last']):>12}"
                f"{_fmt(s['min']):>12}  {s['min_step']}")

    if summary["spans"]:
        lines.append("")
        lines.append(f"{'phase':<18}{'total s':>10}{'count':>8}{'ms/it':>10}")
        for name in sorted(summary["spans"]):
            agg = summary["spans"][name]
            lines.append(
                f"{name:<18}{agg['seconds']:>10.3f}{agg['count']:>8d}"
                f"{agg['ms_per']:>10.2f}")

    led = summary.get("comm_ledger")
    if led:
        pred, obs = led.get("predicted", {}), led.get("observed", {})
        lines.append("")
        lines.append(f"comm ledger ({led.get('phase')}, algo={led.get('algo')},"
                     f" tau={led.get('tau')})")
        for cls in ("reduce", "gather"):
            p, o = pred.get(f"{cls}_bytes"), obs.get(f"{cls}_bytes")
            r = (led.get("ratio") or {}).get(cls)
            lines.append(
                f"  {cls:<7} observed {_fmt_bytes(o):>11}  predicted"
                f" {_fmt_bytes(p):>11}  ratio {_fmt(r, 3)}")
        if led.get("degenerate_mesh"):
            lines.append("  (single-device mesh: the partitioner compiles no"
                         " collectives; ratios suppressed)")
        if obs.get("source"):
            lines.append(f"  observed: {obs['source']}")
        if pred.get("wire_bytes_per_outer") is not None:
            lines.append(
                f"  ring-model wire bytes/outer {_fmt_bytes(pred['wire_bytes_per_outer'])}"
                f" over {pred.get('comm_rounds_per_outer')} round(s)")

    tp = summary.get("throughput") or {}
    if tp:
        lines.append("")
        bits = []
        if "steps_per_s" in tp:
            bits.append(f"{tp['steps_per_s']:.3f} outer steps/s")
        if "tokens_per_s" in tp:
            bits.append(f"{tp['tokens_per_s']:.0f} tokens/s")
        if "wall_s" in tp:
            bits.append(f"{tp['wall_s']:.1f} s wall")
        lines.append("throughput  " + "  ".join(bits))
    return "\n".join(lines)


def diff(a: Dict[str, Any], b: Dict[str, Any]) -> str:
    """Side-by-side scalar/throughput comparison of two summaries."""
    lines: List[str] = []
    na = a.get("run_name") or a["run_dir"]
    nb = b.get("run_name") or b["run_dir"]
    lines.append(f"diff  A={na}  B={nb}")
    lines.append(f"{'metric (last)':<16}{'A':>12}{'B':>12}{'B-A':>12}")
    for name in _KEY_METRICS:
        sa, sb = a["scalars"].get(name), b["scalars"].get(name)
        if not sa and not sb:
            continue
        va = sa["last"] if sa else None
        vb = sb["last"] if sb else None
        delta = (vb - va) if (va is not None and vb is not None) else None
        lines.append(f"{name:<16}{_fmt(va):>12}{_fmt(vb):>12}{_fmt(delta):>12}")
    ta, tb = a.get("throughput") or {}, b.get("throughput") or {}
    for key in ("steps_per_s", "tokens_per_s"):
        if key in ta or key in tb:
            va, vb = ta.get(key), tb.get(key)
            delta = (vb - va) if (va is not None and vb is not None) else None
            lines.append(f"{key:<16}{_fmt(va):>12}{_fmt(vb):>12}{_fmt(delta):>12}")
    return "\n".join(lines)
