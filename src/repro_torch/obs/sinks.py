"""Structured run sinks: per-run directory with a manifest, a JSONL event
stream, and a CSV scalar table, in the reference's format
(``repro.obs.sinks``), so that each package reads the other's run
directories.

Run-dir layout::

    <run_dir>/
      manifest.json   # config, rank grid, dtypes, torch / CUDA version,
                      # card, git sha
      events.jsonl    # one JSON object per line: spans, comm ledger,
                      # checkpoints, eval points, run lifecycle
      scalars.csv     # step,<METRIC_NAMES...> — one row per flushed pack
      profile/        # torch.profiler Chrome traces (--profile-steps)

Host-side only.  Writers append with line-buffered handles so a run killed
mid-flight still leaves a readable prefix, and resumed runs reopen the same
files in append mode without rewriting history.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.metrics import METRIC_NAMES

SCALAR_HEADER = ("step",) + METRIC_NAMES
_REPO = Path(__file__).resolve().parents[3]


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """HEAD of the checkout that holds this package (or of ``cwd``); None
    outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or _REPO, capture_output=True, text=True, timeout=5,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, torch.dtype):
        return str(obj).removeprefix("torch.")      # "bfloat16", as numpy names it
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def build_manifest(
    *,
    run_name: str,
    settings: Any = None,
    model_cfg: Any = None,
    mesh: Any = None,
    device: Any = "cpu",
    world: int = 1,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Everything needed to identify / reproduce a run, as plain JSON: the
    reference's keys, with ``torch_version`` for its ``jax_version`` and
    ``cuda_version`` / ``device_name`` besides.  ``backend`` is the device
    type, ``device_count`` the number of ranks (``world``), and ``mesh`` the
    ranks' ``(worker, zero)`` grid (a ``repro_torch.distributed.mesh.Topology``).
    """
    dev = torch.device(device)
    man: Dict[str, Any] = {
        "run_name": run_name,
        "created_unix": time.time(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "backend": dev.type,
        "device_count": int(world),
        "git_sha": git_sha(),
        "metric_names": list(METRIC_NAMES),
    }
    if mesh is not None:
        man["mesh"] = {"axis_names": ["worker", "zero"],
                       "shape": {"worker": int(mesh.worker), "zero": int(mesh.zero)}}
    if settings is not None:
        man["settings"] = _jsonable(settings)
    if model_cfg is not None:
        man["model_cfg"] = _jsonable(model_cfg)
    if extra:
        man["extra"] = _jsonable(extra)
    return man


def pack_to_dict(pack) -> Dict[str, float]:
    """Decode a fetched ``(N_METRICS,)`` pack (on the host) into
    ``{name: float}``."""
    arr = np.asarray(pack, dtype=np.float64).reshape(-1)
    if arr.shape[0] != len(METRIC_NAMES):
        raise ValueError(
            f"pack has {arr.shape[0]} entries, expected {len(METRIC_NAMES)}"
        )
    return {name: float(v) for name, v in zip(METRIC_NAMES, arr)}


class RunWriter:
    """Append-only writer for one run directory."""

    def __init__(self, run_dir: str, manifest: Optional[Dict[str, Any]] = None,
                 resume: bool = False):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._events_path = os.path.join(run_dir, "events.jsonl")
        self._scalars_path = os.path.join(run_dir, "scalars.csv")
        manifest_path = os.path.join(run_dir, "manifest.json")
        if manifest is not None and not (resume and os.path.exists(manifest_path)):
            tmp = manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(_jsonable(manifest), f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, manifest_path)
        need_header = not (resume and os.path.exists(self._scalars_path)
                           and os.path.getsize(self._scalars_path) > 0)
        mode = "a" if resume else "w"
        self._events = open(self._events_path, mode, buffering=1)
        self._scalars = open(self._scalars_path, mode, buffering=1)
        self._csv = csv.writer(self._scalars)
        if need_header:
            self._csv.writerow(SCALAR_HEADER)
        self._closed = False

    # -- sinks ---------------------------------------------------------

    def event(self, kind: str, **fields: Any) -> None:
        rec = {"kind": kind, "wall": time.time()}
        rec.update(_jsonable(fields))
        self._events.write(json.dumps(rec) + "\n")

    def metrics_row(self, step: int, pack) -> Dict[str, float]:
        """Write one scalars.csv row; returns the decoded dict for reuse
        (e.g. the trainer's log line)."""
        d = pack_to_dict(pack)
        self._csv.writerow([int(step)] + [d[n] for n in METRIC_NAMES])
        return d

    def span(self, name: str, seconds: float, **fields: Any) -> None:
        self.event("span", name=name, seconds=float(seconds), **fields)

    def flush(self) -> None:
        if not self._closed:
            self._events.flush()
            self._scalars.flush()

    def close(self) -> None:
        if not self._closed:
            self._events.close()
            self._scalars.close()
            self._closed = True

    def __enter__(self) -> "RunWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def read_run(run_dir: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]],
                                    List[Dict[str, Any]]]:
    """Load ``(manifest, events, scalar_rows)`` from a run directory.

    Scalar rows come back as ``{"step": int, <name>: float, ...}``.
    Tolerates a truncated trailing JSONL line (killed run).
    """
    manifest_path = os.path.join(run_dir, "manifest.json")
    manifest: Dict[str, Any] = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)

    events: List[Dict[str, Any]] = []
    events_path = os.path.join(run_dir, "events.jsonl")
    if os.path.exists(events_path):
        with open(events_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    break  # truncated tail from a killed run

    rows: List[Dict[str, Any]] = []
    scalars_path = os.path.join(run_dir, "scalars.csv")
    if os.path.exists(scalars_path):
        with open(scalars_path) as f:
            reader = csv.DictReader(f)
            for raw in reader:
                try:
                    row: Dict[str, Any] = {"step": int(raw["step"])}
                    for name in reader.fieldnames or ():
                        if name != "step":
                            row[name] = float(raw[name])
                except (KeyError, TypeError, ValueError):
                    continue  # truncated / partial row
                rows.append(row)
    return manifest, events, rows
