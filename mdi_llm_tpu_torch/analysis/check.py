"""`check`: the aggregate analysis gate — lint + audit + ir + flow.

Port of `mdi_llm_tpu/analysis/check.py` (`mdi-check`).  One command runs
every static analyzer of the port over one (model, mesh, ServingConfig)
tuple and the source tree, with unified exit codes and one `--format
json` report:

- **lint** (`analysis/core.py` + rules): the AST rules over the port's
  sources, grandfathered through the committed `lint-baseline.json`
  exactly as the bare lint;
- **audit** (`analysis/audit.py`): plan and shape arithmetic for the
  serving launch the tuple implies;
- **ir** (`analysis/ir.py`): every serving step traced on the meta
  device: compile-set closure, in-place pool updates, graph hygiene;
- **flow** (`analysis/liveness.py`): buffer liveness over the same
  traces, pinned against the port's `flow-goldens.json` when present.

The engine is built once and its steps traced once, shared by ir and
flow.  Purely host-side: no checkpoint, no card, no CUDA initialisation.

CLI: ``python -m mdi_llm_tpu_torch.analysis check --model pythia-14m``;
``--tp/--pp``, serving knobs, ``--hbm-gb``, ``--goldens`` (default: the
port's goldens when present), ``--skip FAMILY`` (repeatable), ``--format
json``, ``--list-checks``.  Exit 0 when every family is clean (modulo the
lint baseline; warnings do not fail), 1 on findings, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from mdi_llm_tpu_torch.analysis.ir import config_from_args, serving_from_args

__all__ = ["FAMILIES", "main", "run_check"]

FAMILIES = ("lint", "audit", "ir", "flow")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mdi_llm_tpu_torch.analysis check",
        description="Aggregate analysis gate: the lint, the plan audit, ir and "
        "flow over one (model, mesh, ServingConfig) tuple and the source tree, "
        "with unified exit codes and one JSON report",
    )
    src = ap.add_argument_group("model source")
    src.add_argument("--model", default=None, help="registry model name")
    src.add_argument("--config", default=None, metavar="FILE",
                     help="model_config.yaml / config.json to trace")
    par = ap.add_argument_group("parallel plan")
    par.add_argument("--tp", type=int, default=1)
    par.add_argument("--pp", type=int, default=1)
    run = ap.add_argument_group("run shape")
    run.add_argument("--seq-len", type=int, default=None)
    run.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16", "float32"))
    run.add_argument("--quantize", default="none", choices=("none", "int8", "w8a8"))
    srv = ap.add_argument_group("serving (ServingConfig)")
    srv.add_argument("--block-size", type=int, default=16)
    srv.add_argument("--max-batch", type=int, default=8)
    srv.add_argument("--prefill-chunk", type=int, default=128)
    srv.add_argument("--token-budget", type=int, default=None)
    srv.add_argument("--decode-chunk", type=int, default=8)
    srv.add_argument("--spec-k", type=int, default=0)
    srv.add_argument("--kv-dtype", default="auto")
    srv.add_argument("--host-pool-mib", type=int, default=0,
                     help="host-RAM KV block tier in MiB (0 = off); audited by "
                     "bad-host-tier and credited against flow's hbm-over-budget")
    srv.add_argument("--host-link-gbps", type=float, default=None,
                     help="host<->device bandwidth (GB/s) for the swap cost model")
    ap.add_argument("--paths", nargs="*", default=None, metavar="PATH",
                    help="files/dirs for the lint family (default: the port's package)")
    ap.add_argument("--lint-baseline", default=None, metavar="FILE",
                    help="lint baseline (default: the committed lint-baseline.json)")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device memory budget for the audit and flow families")
    ap.add_argument("--host-gb", type=float, default=None,
                    help="host-RAM budget for the KV block tier (audit, bad-host-tier)")
    ap.add_argument("--goldens", default=None, metavar="FILE",
                    help="flow golden budgets (default: the port's flow-goldens.json "
                    "when present)")
    ap.add_argument("--skip", action="append", default=[], choices=FAMILIES,
                    metavar="FAMILY", help="skip one analyzer family; repeatable")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-checks", action="store_true",
                    help="print every family's rule registry and exit")
    return ap


def _list_checks() -> None:
    from mdi_llm_tpu_torch.analysis.audit import AUDIT_RULES
    from mdi_llm_tpu_torch.analysis.core import RULES, _selected_rules
    from mdi_llm_tpu_torch.analysis.ir import IR_RULES
    from mdi_llm_tpu_torch.analysis.liveness import FLOW_RULES

    _selected_rules(None)  # populate RULES
    families = [
        ("lint", {name: ("error", r.summary) for name, r in RULES.items()}),
        ("audit", AUDIT_RULES),
        ("ir", IR_RULES),
        ("flow", FLOW_RULES),
    ]
    for family, rules in families:
        for code, (sev, summary) in rules.items():
            print(f"{family}:{code}  [{sev}] {summary}")


def run_check(args) -> Dict[str, Any]:
    """Run the requested families; returns the aggregate report (the
    `--format json` payload).  Raises ValueError on usage problems."""
    skip = set(args.skip or ())
    report: Dict[str, Any] = {"families": {}, "errors": 0, "warnings": 0}
    cfg = serving = None
    if {"audit", "ir", "flow"} - skip:
        cfg = config_from_args(args)
        serving = serving_from_args(args)
    name = args.model or (Path(args.config).stem if args.config else "?")
    tag = "".join(t for t in (f"@tp{args.tp}" if args.tp > 1 else "",
                              f"@pp{args.pp}" if args.pp > 1 else ""))
    origin = f"{name}{tag}"
    report["origin"] = origin

    if "lint" not in skip:
        from mdi_llm_tpu_torch.analysis.core import BASELINE_PATH, Baseline, lint_paths

        pkg = Path(__file__).resolve().parents[1]
        paths = [Path(p) for p in args.paths] if args.paths else [pkg]
        root = Path.cwd() if args.paths else pkg.parent
        findings, errors = lint_paths([str(p) for p in paths], root=root)
        base_path = Path(args.lint_baseline) if args.lint_baseline else BASELINE_PATH
        grandfathered = 0
        if base_path.exists():
            new, old = Baseline.load(base_path).split(findings)
            findings, grandfathered = new, len(old)
        report["families"]["lint"] = {
            "errors": len(findings) + len(errors),
            "warnings": 0,
            "grandfathered": grandfathered,
            "findings": [f"{f.path}:{f.line}: {f.rule}: {f.message}" for f in findings] + errors,
        }

    if "audit" not in skip:
        from mdi_llm_tpu_torch.analysis.audit import preflight

        audit_report = preflight(
            cfg, tp=args.tp, pp=args.pp, batch=args.max_batch, seq_len=args.seq_len,
            act_seq_len=serving.resolved_token_budget(), dtype=args.dtype,
            quantize=None if args.quantize == "none" else args.quantize,
            serving=serving, hbm_gb=args.hbm_gb, host_gb=args.host_gb,
            origin=f"check:{origin}",
        )
        report["families"]["audit"] = {
            "errors": len(audit_report.errors),
            "warnings": len(audit_report.warnings),
            "findings": audit_report.render_findings(),
            "breakdown": audit_report.breakdown,
        }

    traces = engine = None
    if "ir" not in skip or "flow" not in skip:
        from mdi_llm_tpu_torch.analysis.ir import trace_engine, trace_serving

        engine = trace_serving(cfg, serving, tp=args.tp, pp=args.pp, dtype=args.dtype,
                               quantize=None if args.quantize == "none" else args.quantize,
                               max_seq_length=args.seq_len)
        traces = trace_engine(engine)  # traced once, shared by ir and flow

    if "ir" not in skip:
        from mdi_llm_tpu_torch.analysis.ir import ir_preflight

        ir_report = ir_preflight(engine, origin=origin, traces=traces)
        report["families"]["ir"] = {
            "errors": len(ir_report.errors),
            "warnings": len(ir_report.warnings),
            "findings": ir_report.render_findings(),
            "executables": {r["name"]: r.get("nodes") for r in ir_report.executables},
        }

    if "flow" not in skip:
        from mdi_llm_tpu_torch.analysis.liveness import DEFAULT_GOLDENS, flow_preflight, load_goldens

        goldens = None
        goldens_path = Path(args.goldens) if args.goldens else DEFAULT_GOLDENS
        if args.goldens or goldens_path.exists():
            goldens = load_goldens(goldens_path)  # raises on a bad file
        flow_report = flow_preflight(engine, origin=origin, hbm_gb=args.hbm_gb,
                                     goldens=goldens, traces=traces)
        report["families"]["flow"] = {
            "errors": len(flow_report.errors),
            "warnings": len(flow_report.warnings),
            "findings": flow_report.render_findings(),
            "peak_bytes": {p.name: p.peak_bytes for p in flow_report.profiles},
        }

    report["errors"] = sum(f["errors"] for f in report["families"].values())
    report["warnings"] = sum(f["warnings"] for f in report["families"].values())
    return report


def render_text(report: Dict[str, Any]) -> str:
    lines = [f"check: {report.get('origin', '?')}"]
    for family, res in report["families"].items():
        status = "clean" if not res["errors"] else f"{res['errors']} error(s)"
        extra = ""
        if res.get("warnings"):
            extra += f", {res['warnings']} warning(s)"
        if res.get("grandfathered"):
            extra += f", {res['grandfathered']} grandfathered"
        lines.append(f"  {family:<6} {status}{extra}")
        for f in res.get("findings", []):
            lines.append(f"    {f}")
    lines.append("check: " + ("PASS" if not report["errors"]
                              else f"FAIL ({report['errors']} error(s))"))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_checks:
        _list_checks()
        return 0
    try:
        report = run_check(args)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"check: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(render_text(report))
    return 1 if report["errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
