"""``python -m repro_torch.analysis`` — run the port's simlint.

Exit status 0 when no non-suppressed finding remains, 1 otherwise.
``--json`` writes the machine-readable report; suppressed findings are
included there.  The step checks run on ``--device`` (default ``cuda``;
without a card pass ``--device cpu``, or ``--no-jaxpr`` to run only the
source rules).
"""
from __future__ import annotations

import argparse
import sys

from . import (RULES, active, check_all, check_paths, render_report,
               to_json)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="simlint: event-step invariant checks + step-code lint "
                    "for the port's vectorized simulator")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--no-jaxpr", action="store_true",
                    help="skip the JX1xx step checks (the name is the "
                         "reference's)")
    ap.add_argument("--no-ast", action="store_true",
                    help="skip the source-level PY2xx rules")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="files/directories for the AST rules (default: "
                         "core/vectorized, kernels, workloads)")
    ap.add_argument("--workers", type=int, default=4,
                    help="W of the check grid (default 4)")
    ap.add_argument("--shape", type=int, nargs=3, default=(32, 64, 96),
                    metavar=("T", "O", "E"),
                    help="bucket shape of the check grid")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the step checks (default 'cuda'; "
                         "raises without a card)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id and exit")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print suppressed findings")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    findings = []
    if not args.no_ast:
        findings.extend(check_paths(args.paths))
    if not args.no_jaxpr:
        findings.extend(check_all(n_workers=args.workers,
                                  shape=tuple(args.shape),
                                  device=args.device))

    print(render_report(findings, verbose=args.verbose))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(to_json(findings,
                             workers=args.workers,
                             shape=list(args.shape),
                             jaxpr=not args.no_jaxpr,
                             ast=not args.no_ast,
                             device=args.device))
        print(f"json report: {args.json}")
    return 1 if active(findings) else 0


if __name__ == "__main__":
    sys.exit(main())
