"""The lint's command line (`python -m mdi_llm_tpu_torch.analysis`) and the
dispatch of its subcommands.

Exit codes: 0 = clean (modulo baseline/suppressions), 1 = new findings,
2 = usage/parse errors.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from mdi_llm_tpu_torch.analysis.core import (
    BASELINE_PATH,
    DEFAULT_PATHS,
    Baseline,
    RULES,
    _selected_rules,
    lint_paths,
)

# the subcommands beside the lint: module of each (its `main(argv)`)
SUBCOMMANDS = {
    "audit": "mdi_llm_tpu_torch.analysis.audit",
    "ir": "mdi_llm_tpu_torch.analysis.ir",
    "flow": "mdi_llm_tpu_torch.analysis.liveness",
    "check": "mdi_llm_tpu_torch.analysis.check",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mdi_llm_tpu_torch.analysis",
        description="CUDA-graph-aware static analysis for the port (host reads "
        "and tensor branches in captured steps, captures in loops, thread "
        "roles)",
    )
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files or directories to lint (default: mdi_llm_tpu_torch)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"baseline file (default: {BASELINE_PATH.name} in the "
                    "analysis package)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to grandfather all current findings")
    ap.add_argument("--select", default=None, metavar="RULES",
                    help="comma-separated rule names to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rules = _selected_rules(None)  # import side effect: populate RULES

    if args.list_rules:
        width = max(len(r.name) for r in rules)
        for r in sorted(RULES.values(), key=lambda r: r.name):
            print(f"{r.name:<{width}}  {r.summary}")
        return 0

    select = [s.strip() for s in args.select.split(",")] if args.select else None
    if select:
        unknown = [s for s in select if s not in RULES]
        if unknown:
            print(f"mdi-lint: unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2

    baseline_path = Path(args.baseline) if args.baseline else BASELINE_PATH
    findings, errors = lint_paths(args.paths, select=select)
    for e in errors:
        print(f"mdi-lint: {e}", file=sys.stderr)

    if args.update_baseline:
        new_baseline = Baseline.from_findings(findings)
        if select:
            # refresh ONLY the selected rules' entries; other rules keep
            # their grandfathered findings (keys are "rule::path::text")
            old = Baseline.load(baseline_path)
            for key, count in old.counts.items():
                if key.split("::", 1)[0] not in select:
                    new_baseline.counts[key] = count
        new_baseline.save(baseline_path)
        print(
            f"mdi-lint: baseline written to {baseline_path} "
            f"({len(findings)} finding(s) grandfathered)"
        )
        return 0 if not errors else 2

    if args.no_baseline:
        new, old = list(findings), []
    else:
        new, old = Baseline.load(baseline_path).split(findings)

    if args.format == "json":
        print(json.dumps({
            "findings": [f.__dict__ for f in new],
            "baselined": len(old),
            "errors": errors,
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        summary = f"mdi-lint: {len(new)} finding(s)"
        if old:
            summary += f" ({len(old)} grandfathered by {baseline_path})"
        print(summary)
    if errors:
        return 2
    return 1 if new else 0


def dispatch(argv: List[str]) -> int:
    """`audit ...` -> the plan audit, `ir ...` / `flow ...` -> the analysis
    of the serving steps traced on the meta device, `check ...` -> the
    aggregate gate, `[lint] ...` -> the lint."""
    if argv[:1] and argv[0] in SUBCOMMANDS:
        import importlib

        return importlib.import_module(SUBCOMMANDS[argv[0]]).main(argv[1:])
    if argv[:1] == ["lint"]:
        argv = argv[1:]
    return main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
