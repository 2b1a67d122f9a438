"""Phase span tracing: fenced wall-time spans, the ``torch.profiler``
window, device memory stats, and the reading of a captured trace (the
reference's ``repro.obs.tracing`` for eager PyTorch on the card).

PyTorch returns before the card finishes, so a bare host clock around a
step measures the enqueue.  ``Span`` fences its exit with
``torch.cuda.synchronize`` on the device the caller hands it, which makes
the wall time honest at the cost of a pipeline bubble, so the trainer opens
spans around *windows* (a log interval, an eval, a checkpoint), never around
every step.

``ProfileWindow`` arms ``torch.profiler.profile`` (CPU and, on the card,
CUDA activity) for an inclusive outer-step range (``--profile-steps A:B``)
and exports a Chrome trace into ``<run_dir>/profile``;
``record_function`` ranges inside the outer step ("dsm_local_phase" /
"dsm_global_step", ``core/dsm.py``) mark the two phases in it.
:func:`profile_summary` reads such a trace: kernel launches by name, the
card's busy share, the top device operations and the longest idle gaps.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple

import torch


def _fence(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Span:
    """Context manager measuring a wall-time span, fenced at exit by a
    synchronize of ``device`` (nothing on the CPU)."""

    def __init__(self, name: str, device: Any = None):
        self.name = name
        self.device = device
        self.seconds = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type: Any, *exc: Any) -> None:
        if exc_type is None:
            _fence(self.device)
        self.seconds = time.monotonic() - self._t0


class PhaseTotals:
    """Accumulates span seconds / counts per phase name."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, seconds: float, n: int = 1) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + float(seconds)
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def ms_per(self, name: str) -> Optional[float]:
        n = self.counts.get(name, 0)
        if n <= 0:
            return None
        return 1e3 * self.seconds[name] / n

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "seconds": self.seconds[name],
                "count": self.counts[name],
                "ms_per": self.ms_per(name) or 0.0,
            }
            for name in sorted(self.seconds)
        }


def parse_profile_steps(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """Parse ``"A:B"`` into an inclusive step range; None when unset."""
    if not spec:
        return None
    try:
        a_s, b_s = spec.split(":")
        a, b = int(a_s), int(b_s)
    except ValueError as e:
        raise ValueError(
            f"--profile-steps expects 'A:B' (got {spec!r})"
        ) from e
    if a < 0 or b < a:
        raise ValueError(f"--profile-steps needs 0 <= A <= B (got {spec!r})")
    return a, b


class ProfileWindow:
    """Arms ``torch.profiler.profile`` while the outer step is inside
    [A, B] and exports its Chrome trace to :attr:`trace_path` when the
    window closes.

    A profiler that fails to start or to export does not end the run: the
    window stops for good, keeps the error text in :attr:`error` and hands
    it to ``on_fail(step, error)`` (the trainer's ``profile_failed`` event).
    """

    def __init__(self, steps: Optional[Tuple[int, int]], out_dir: str, device: Any = "cpu",
                 on_fail: Optional[Callable[[int, str], None]] = None):
        self.steps = steps
        self.out_dir = out_dir
        self.device = torch.device(device)
        self.on_fail = on_fail
        self.active = False
        self.failed = False
        self.error: Optional[str] = None
        self.trace_path = (None if steps is None else
                           os.path.join(out_dir, f"outer_steps_{steps[0]}-{steps[1]}.pt.trace.json"))
        self._prof = None
        self._step = 0

    def tick(self, step: int) -> None:
        """Call once per outer step, before running it."""
        self._step = step
        if self.steps is None or self.failed:
            return
        a, b = self.steps
        if not self.active and a <= step <= b:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                _fence(self.device)
                self._prof = torch.profiler.profile(activities=acts)
                self._prof.start()
                self.active = True
            except Exception as e:  # noqa: BLE001 - a profiler must not end the run
                self._fail(e)
        elif self.active and step > b:
            self._stop()

    def _fail(self, e: Exception) -> None:
        self.failed = True
        self.error = f"{type(e).__name__}: {e}"
        if self.on_fail is not None:
            self.on_fail(self._step, self.error)

    def _stop(self) -> None:
        self.active = False
        try:
            _fence(self.device)
            self._prof.stop()
            os.makedirs(self.out_dir, exist_ok=True)
            self._prof.export_chrome_trace(self.trace_path)
        except Exception as e:  # noqa: BLE001 - a profiler must not end the run
            self._fail(e)
        self._prof = None

    def close(self) -> None:
        if self.active:
            self._stop()


def device_memory_stats(device: Any = "cpu") -> Optional[Dict[str, Any]]:
    """Live / peak / total bytes of ``device`` under the reference's key
    names, keyed by the device, or None on the CPU (as the reference's CPU
    backend has no memory stats)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    st = torch.cuda.memory_stats(dev)
    return {str(dev): {"bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
                       "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
                       "bytes_limit": int(torch.cuda.mem_get_info(dev)[1])}}


def timeit_fenced(fn: Callable[..., Any], *args: Any, iters: int = 5, warmup: int = 1,
                  device: Any = "cpu") -> float:
    """Median seconds per call: CUDA events around each call on the card,
    the host clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(max(warmup, 0)):
        fn(*args)
    _fence(device)
    times = []
    for _ in range(max(iters, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


# what the card does, in a torch.profiler Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("user_annotation", "cpu_op")


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def profile_summary(path: str, start: str = "dsm_local_phase", top: int = 10,
                    gaps: int = 5) -> Dict[str, Any]:
    """What a ``torch.profiler`` Chrome trace shows of the card.

    The window runs from the first host range named ``start`` to the end of
    the last device activity.  ``busy_share`` is the union of the device's
    kernel, memcpy and memset intervals inside the window over its length
    (None without a ``start`` range or without device activity, as in a
    trace taken on the CPU).  Also: every kernel's launches by name, the
    ``top`` device operations by total time, and the ``gaps`` longest idle
    gaps, each with the innermost host range open at its middle and the
    host operations that overlap it.  Times in microseconds.
    """
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES]
    out: Dict[str, Any] = {
        "device_events": len(dev),
        "kernel_launches": dict(Counter(e["name"] for e in dev if e["cat"] == "kernel")),
        "busy_share": None,
    }
    starts = [e["ts"] for e in host if e.get("name") == start]
    if not starts or not dev:
        return out
    t0 = min(starts)
    spans = [(max(e["ts"], t0), e["ts"] + e["dur"], e) for e in dev if e["ts"] + e["dur"] > t0]
    if not spans:
        return out
    t1 = max(b for _, b, _ in spans)
    busy = _union((a, b) for a, b, _ in spans)
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, list] = {}
    for a, b, e in spans:
        rec = by_name.setdefault(e["name"], [0.0, 0, e["cat"]])
        rec[0] += b - a
        rec[1] += 1
    idle = [(a, b) for (_, a), (b, _) in zip([(t0, t0)] + busy, busy) if b > a]

    def host_at(a, b):
        mid = 0.5 * (a + b)
        cover = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        ops = sorted(((min(b, e["ts"] + e["dur"]) - max(a, e["ts"]), e["name"]) for e in host
                      if e["cat"] == "cpu_op" and e["ts"] < b and e["ts"] + e["dur"] > a),
                     reverse=True)
        return {"host": min(cover, key=lambda e: e["dur"])["name"] if cover else None,
                "host_ops": [n for _, n in ops[:3]]}

    out.update({
        "window_us": t1 - t0,
        "busy_us": busy_us,
        "busy_share": busy_us / (t1 - t0) if t1 > t0 else None,
        "top_ops": [{"name": n, "category": c, "us": us, "count": k}
                    for n, (us, k, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]],
        "idle_gaps": [{"start_us": a - t0, "us": b - a, **host_at(a, b)}
                      for a, b in sorted(idle, key=lambda ab: ab[0] - ab[1])[:gaps]],
        "idle_gaps_total": len(idle),
    })
    return out
