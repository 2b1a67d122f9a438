"""Observability of the port, in the reference's layout and file format
(``repro.obs``; docs/observability.md):

  * ``metrics``    — the on-device metric pack of the outer step, and its
                     fetch to the host and decoding into a scalars row.
  * ``sinks``      — per-run directory: manifest.json / events.jsonl /
                     scalars.csv (host-side only).
  * ``tracing``    — fenced wall-time spans, the ``torch.profiler`` window
                     and the reading of its trace, device memory stats.
  * ``ledger``     — observed (counted collectives) vs predicted (analytic
                     model, ``comm_model``) communication bytes.
  * ``summarize``  — ``python -m repro_torch.obs summarize <run_dir>`` CLI.
"""

from repro_torch.obs.metrics import (
    IDX,
    METRIC_NAMES,
    N_METRICS,
    decode_metrics_row,
    finish_pack,
    loss_stats,
    minimal_pack,
)
from repro_torch.obs.sinks import RunWriter, build_manifest, read_run
from repro_torch.obs.summarize import summarize_run

__all__ = [
    "IDX",
    "METRIC_NAMES",
    "N_METRICS",
    "RunWriter",
    "build_manifest",
    "decode_metrics_row",
    "finish_pack",
    "loss_stats",
    "minimal_pack",
    "read_run",
    "summarize_run",
]
