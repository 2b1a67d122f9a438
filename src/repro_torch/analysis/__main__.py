"""``python -m repro_torch.analysis`` — audit / lint CLI.

  audit  — run the dense / device-parallel / ZeRO-sharded outer steps, the
           bare local phase and the trainer's step over ``--ranks`` gloo
           processes (default 4), record their collectives and check them
           against the budgets of ``obs.comm_model``.  On the card unless
           ``--device cpu``; with no card it raises.  A world of one is
           degenerate (every collective is the identity) and fails unless
           ``--allow-degenerate``.
  lint   — run the RPR0xx rules over files/directories.

Both exit nonzero on findings/violations (2 on a usage error); ``--json``
prints a machine-readable report.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_audit(args: argparse.Namespace) -> int:
    from repro_torch.analysis.collective_audit import standard_audit

    reports = standard_audit(n_workers=args.n_workers, tau=args.tau, ranks=args.ranks,
                             device=args.device, self_test=args.self_test)
    degenerate = args.ranks < 2
    ok = True
    for r in reports:
        expect_fail = r.name.startswith("self_test")
        passed = (not r.passed) if expect_fail else r.passed
        ok &= passed
        if expect_fail and not r.passed:
            # the planted collective was caught: the auditor is live
            r.violations = [f"(expected) {v}" for v in r.violations]
    if degenerate and not args.allow_degenerate:
        ok = False

    payload = {
        "n_ranks": args.ranks,
        "device": args.device,
        "degenerate": degenerate,
        "passed": bool(ok),
        "reports": [r.to_json() for r in reports],
    }
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2)
    if args.json:
        print(json.dumps(payload, indent=2))
    else:
        for r in reports:
            counts = ", ".join(f"{k}={v}" for k, v in sorted(r.counts.items())) \
                or "no collectives"
            status = "PASS" if r.passed else "FAIL"
            if r.name.startswith("self_test"):
                status = "PASS (caught)" if not r.passed else \
                    "FAIL (planted collective NOT caught)"
            print(f"[{status}] {r.name:<32} {counts}")
            for v in r.violations:
                print(f"         {v}")
        if degenerate and not args.allow_degenerate:
            print("FAIL: a world of one rank is degenerate and issues no collectives; rerun "
                  "with --ranks >= 2 (or pass --allow-degenerate)")
        print("audit:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def _cmd_lint(args: argparse.Namespace) -> int:
    from repro_torch.analysis.lint import RULES, lint_paths

    findings = lint_paths(args.paths)
    if args.select:
        keep = {r.strip() for r in args.select.split(",")}
        unknown = keep - set(RULES) - {"RPR000"}
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)}", file=sys.stderr)
            return 2
        findings = [f for f in findings if f.rule in keep]
    if args.json:
        print(json.dumps([f.to_json() for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
        print(f"{len(findings)} finding(s)")
    return 1 if findings else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_audit = sub.add_parser("audit", help="collective-budget audit of the outer step")
    ap_audit.add_argument("--ranks", type=int, default=4,
                          help="gloo processes the steps run over (default 4)")
    ap_audit.add_argument("--device", default="cuda",
                          help="cuda (default; raises without a card) or cpu")
    ap_audit.add_argument("--n-workers", type=int, default=4)
    ap_audit.add_argument("--tau", type=int, default=2)
    ap_audit.add_argument("--self-test", action="store_true",
                          help="also audit a step with a PLANTED extra "
                               "all-reduce, which must fail")
    ap_audit.add_argument("--allow-degenerate", action="store_true",
                          help="do not fail on a world of one rank")
    ap_audit.add_argument("--json", action="store_true")
    ap_audit.add_argument("--out", default=None,
                          help="also write the JSON report to this file")
    ap_audit.set_defaults(fn=_cmd_audit)

    ap_lint = sub.add_parser("lint", help="RPR0xx custom AST lint")
    ap_lint.add_argument("paths", nargs="+")
    ap_lint.add_argument("--select", default=None,
                         help="comma-separated rule ids to keep")
    ap_lint.add_argument("--json", action="store_true")
    ap_lint.set_defaults(fn=_cmd_lint)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
