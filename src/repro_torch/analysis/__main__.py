"""``python -m repro_torch.analysis``: the port's static gate (twin of
``python -m repro.analysis``).

Runs, in order: the AST lint rules over the given paths, the dispatch
audit of the entry points, the launch guard, the launch audit of the
hand kernels, and the (informational) substrate report.  Exits 1 iff any
*unsuppressed* finding remains.

The lint needs no device.  The sections that run the program (the
dispatch audit, the guard) resolve ``--device`` through
``repro_torch.device.resolve``: the default is the card, and without one
they raise unless ``--device cpu`` is passed.  On the card the launch
audit is also held against the built extension.

Examples::

    python -m repro_torch.analysis src/repro_torch --device cpu
    python -m repro_torch.analysis --format json --out report.json
    python -m repro_torch.analysis --list-rules
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from repro_torch.analysis import linter, rules
from repro_torch.analysis.linter import Finding


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis and sanitizers")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files/directories to lint (default: the "
                         "installed repro_torch package)")
    ap.add_argument("--device", default=None,
                    help="where the dispatch audit and the guard run: "
                         "'cuda' (the default) or 'cpu'")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", help="also write the JSON report here")
    ap.add_argument("--no-dispatch", action="store_true",
                    help="skip the dispatch audit of the entry points")
    ap.add_argument("--no-launch", action="store_true",
                    help="skip the launch audit of the hand kernels")
    ap.add_argument("--no-guard", action="store_true",
                    help="skip the launch guard (build-once counts)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    return ap


def _default_paths() -> List[str]:
    import repro_torch
    return [os.path.dirname(os.path.abspath(repro_torch.__file__))]


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    if args.list_rules:
        for rule in rules.all_rules():
            print(f"{rule.id}\n    {rule.summary}\n    "
                  f"history: {rule.history}")
        for rule_id, why in rules.DROPPED_RULES.items():
            print(f"{rule_id} (no twin in the port)\n    {why}")
        return 0

    paths = args.paths or _default_paths()
    lint = linter.lint_paths(paths)
    report = {
        "paths": paths,
        "findings": [f.to_dict() for f in lint if not f.suppressed],
        "suppressed": [f.to_dict() for f in lint if f.suppressed],
    }
    gate = [f for f in lint if not f.suppressed]

    dev = None
    if not (args.no_dispatch and args.no_guard):
        from repro_torch import device as device_lib
        dev = device_lib.resolve(args.device)
        report["device"] = str(dev)
    if not args.no_dispatch:
        from repro_torch.analysis.dispatch_audit import audit_entry_points
        dx = audit_entry_points(dev)
        report["dispatch"] = [f.to_dict() for f in dx]
        gate += dx
    if not args.no_guard:
        from repro_torch.analysis.dispatch_audit import launch_guard
        gd = launch_guard(dev)
        report["guard"] = [f.to_dict() for f in gd]
        gate += gd
    if not args.no_launch:
        from repro_torch.analysis import launch_audit
        la = launch_audit.audit_kernels()
        if dev is not None and dev.type == "cuda":
            from repro_torch.kernels import build
            ext_findings, record = launch_audit.audit_extension(
                build.extension(), dev)
            la += ext_findings
            report["launch_extension"] = record
        report["launch"] = [f.to_dict() for f in la]
        gate += la

    from repro_torch.analysis.substrate import substrate_report
    report["substrate"] = substrate_report()
    report["summary"] = {
        "unsuppressed": len(gate),
        "suppressed": len(report["suppressed"]),
        "substrate_modules": len(report["substrate"]["substrate"]),
    }

    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(linter.render_text(
            gate + [Finding(**d) for d in report["suppressed"]]))
        sub = report["substrate"]["substrate"]
        print(f"substrate (informational): {len(sub)} modules")
    return 1 if gate else 0


if __name__ == "__main__":
    sys.exit(main())
