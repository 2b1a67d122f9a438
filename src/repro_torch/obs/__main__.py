"""``python -m repro_torch.obs`` — run-directory CLI, the reference's
(``python -m repro.obs``) for either package's run directories.

  summarize <run_dir> [<run_dir_b>]
      Print a report for one run — scalar trajectory, per-phase spans,
      observed-vs-predicted comm bytes, throughput — or a scalar diff
      when a second run directory is given.  ``--json`` emits the
      machine-readable summary instead.

Pure host code, safe to run on a machine without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_summarize(args: argparse.Namespace) -> int:
    from repro_torch.obs.summarize import diff, render, summarize_run

    for d in filter(None, (args.run_dir, args.run_dir_b)):
        if not os.path.isdir(d):
            print(f"not a run directory: {d}", file=sys.stderr)
            return 2

    a = summarize_run(args.run_dir)
    if args.run_dir_b:
        b = summarize_run(args.run_dir_b)
        if args.json:
            print(json.dumps({"a": a, "b": b}, indent=2))
        else:
            print(diff(a, b))
        return 0
    if args.json:
        print(json.dumps(a, indent=2))
    else:
        print(render(a))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_sum = sub.add_parser("summarize", help="summarize / diff run dirs")
    ap_sum.add_argument("run_dir")
    ap_sum.add_argument("run_dir_b", nargs="?", default=None,
                        help="second run dir: print a scalar diff instead")
    ap_sum.add_argument("--json", action="store_true")
    ap_sum.set_defaults(fn=_cmd_summarize)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
