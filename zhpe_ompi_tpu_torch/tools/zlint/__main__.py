"""CLI: ``python -m zhpe_ompi_tpu_torch.tools.zlint [paths...]``
(namesake: ``zhpe_ompi_tpu/tools/zlint/__main__.py``).

Exit codes: 0 clean (baseline applied), 1 findings, 2 usage/empty scan.
"""

from __future__ import annotations

import argparse
import os
import sys

from .engine import default_baseline_path, lint_paths, run
from .rules import rule_table


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="zlint",
        description="AST concurrency-and-protocol analyzer for "
                    "zhpe_ompi_tpu_torch (rules ZL001-ZL008; see --list-rules)",
    )
    ap.add_argument("paths", nargs="*", help="files/dirs to lint "
                    "(default: the zhpe_ompi_tpu_torch package)")
    ap.add_argument("--baseline", default=None,
                    help="annotated baseline file (default: the "
                    "checked-in tools/zlint/baseline.txt)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report grandfathered findings too")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--write-baseline", metavar="PATH",
                    help="write every current finding to PATH in "
                    "baseline format (justifications to be filled in)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, title, guards in rule_table():
            print(f"{rid}  {title:18s} guards against: {guards}")
        return 0

    paths = args.paths
    if not paths:
        # default scan: the package this tool ships in
        pkg = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        paths = [pkg]

    baseline = None if args.no_baseline else (
        args.baseline or default_baseline_path())

    if args.write_baseline:
        result = lint_paths(paths, baseline=None)
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            fh.write("# zlint baseline — every entry needs a one-line "
                     "justification after ' -- '\n")
            for f in result.findings:
                fh.write(f"{f.key()} -- TODO: justify or fix\n")
        print(f"wrote {len(result.findings)} entries to "
              f"{args.write_baseline}")
        return 0

    return run(paths, baseline=baseline)


if __name__ == "__main__":
    sys.exit(main())
