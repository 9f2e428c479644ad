"""The port's static gate: ``python -m repro_torch.analysis``.

Runs the ``repro_torch.analysis`` rules (torch host sync, retrace,
paged-leaf coverage, tile atomicity, syntax) over the given paths (the
port package by default) and exits 1 on any active violation, 2 on a
usage error, 0 when clean.

    python -m repro_torch.analysis                     # the port
    python -m repro_torch.analysis --json src/repro_torch
    python -m repro_torch.analysis --rules syntax src/repro_torch
    python -m repro_torch.analysis --list-rules
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis import NO_COUNTERPART, all_rules, run

PACKAGE = pathlib.Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant checker of the PyTorch port")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to scan (default: the "
                         "repro_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="emit per-violation JSON records to stdout")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)         # a usage error exits 2

    if args.list_rules:
        for rid, rule in sorted(all_rules().items()):
            print(f"{rid:28s} {rule.description}")
        for rid, why in sorted(NO_COUNTERPART.items()):
            print(f"{rid:28s} no counterpart: {why}")
        return 0

    paths = args.paths or [str(PACKAGE)]
    missing = [p for p in paths if not pathlib.Path(p).exists()]
    if missing:
        print(f"repro_torch.analysis: FAIL: no such path: "
              f"{', '.join(missing)}", file=sys.stderr)
        return 2
    rule_ids = ([r.strip() for r in args.rules.split(",") if r.strip()]
                if args.rules else None)
    try:
        report = run(paths, rule_ids)
    except KeyError as e:
        print(f"repro_torch.analysis: FAIL: {e.args[0]}", file=sys.stderr)
        return 2

    if args.json:
        print(report.to_json())
    else:
        for v in report.violations:
            print(v.format())
        for v in report.suppressed:
            if not v.justified:
                print(f"note: {v.format()} — suppression has no "
                      f"justification text")
        print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
