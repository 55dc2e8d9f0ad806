"""`ir`: static analysis of the serving compile set over traced step graphs.

Port of `mdi_llm_tpu/analysis/ir.py` (`mdi-ir`).  The JAX tool traces
every executable the serving engine can dispatch to a jaxpr over
`ShapeDtypeStruct`s and runs a rule registry over each.  The port's steps
are bodies captured as CUDA graphs (`utils/step_graph.py`) or launched
eagerly; their counterpart of a jaxpr is an fx graph of the body traced on
the meta device (`analysis/trace.py`): one node per operator, K1 and K2
one node per launch (`kernels.define_op`), the weights and the pool graph
inputs with their roles.  The steps come from the same enumeration seams
as in the JAX package: `ServingEngine.enumerate_executables()` (the
pipelined engine inherits it) and `Generator.enumerate_executables()` for
`generate()`, built on `obs/device.py`'s `StepSpec` and `abstractify`.
`trace_serving()` builds the whole engine abstractly (`Generator(abstract=
True)` over `analysis.plan.abstract_params`): no checkpoint, no card, no
CUDA initialisation; a live engine (the serve's preflight) is traced on
its meta twin, so nothing runs on its card and none of its counters or
generators moves.

Rules (IR_RULES, the JAX names, so baselines and `--suppress` read the
same), jaxpr -> fx:

- **compile-set-closure** [error] — unchanged: the enumerated (label,
  key) set must equal `reachable_serving_set`, derived independently from
  the ServingConfig.
- **dropped-donation** [error] — JAX: every donated buffer must appear in
  the lowered module's input-output aliasing.  Here: every pool leaf a
  step writes (the spec's `writes`, the JAX `donate_argnums`) must be
  updated in place (`index_put_`, `copy_`, `index_copy_`, `scatter_` on
  the placeholder or a view of it), and no node may make a second tensor
  of a pool leaf's shape and dtype (a functional update: both copies live).
- **callback-in-executable** [error] — JAX: a callback primitive in the
  jaxpr.  Here: a host round trip inside a step (`.item()` or a Python
  branch on a tensor, which reach `aten._local_scalar_dense`; a
  data-dependent `nonzero`; a copy to the CPU).  It cannot be traced on
  meta tensors: the trace stops there and the finding names the body's
  source line.
- **sharding-constraint-drift** [error] — JAX: a sharding constraint on
  a pool value that disagrees with the pool's declared sharding (GSPMD
  then reshards the whole pool every step).  The port has no sharding
  constraints: each tp rank's and pp stage's pool is its own tensor.  The
  cost the rule exists for is a whole pool leaf copied inside a tp or pp
  step: a `_to_copy`, `clone` or `copy_` of a pool leaf's bytes.  On meta
  every device is the meta device, so a hop the code writes as
  `.to(peer_device)` is a no-op there and leaves no node; what the rule
  sees is a copy that materializes.
- **dtype-promotion-leak** [warning] — unchanged in meaning: a bf16/f16
  value cast to float32 (`_to_copy`), through views only, feeding a
  matmul operand (`mm`, `bmm`, `addmm`, `baddbmm`), when the weights are
  low precision.
- **baked-constant-bloat** [warning] — a tensor the body reads that is
  neither an argument nor computed (a `get_attr` node) larger than
  `--const-bytes`.  Under the twin's devices every constant is whole on
  its device (the port has no sharded constants).
- **trace-failure** [error] — a step that cannot be traced: no static
  claim holds for it.  A step is never dropped silently.

Records name each step's node count (`nodes`, the JAX `eqns`) and the
pool leaves it updates in place (`donated`).

CLI: ``python -m mdi_llm_tpu_torch.analysis ir --model pythia-14m --tp 2``;
``--format json``, ``--baseline`` / ``--update-baseline``, ``--suppress
RULE=justification`` (a justification is mandatory), ``--list-checks``,
``--sequential`` (the `generate()` set too).  Exit 0 clean, 1 on
findings, 2 on usage or plan errors.  `cli.serve` runs `ir_preflight` +
`enforce_ir_preflight` on the engine it built.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from mdi_llm_tpu_torch.analysis.core import Baseline, Finding
from mdi_llm_tpu_torch.analysis.trace import (
    HostRoundTrip,
    Node,
    Traced,
    trace_all,
    view_source,
)
from mdi_llm_tpu_torch.config import Config, ServingConfig

__all__ = [
    "IR_RULES",
    "IrReport",
    "analyze_executables",
    "enforce_ir_preflight",
    "ir_detail",
    "ir_preflight",
    "main",
    "reachable_serving_set",
    "trace_serving",
]

ERROR, WARNING = "error", "warning"

# rule -> (severity, one-line summary); --list-checks prints this
IR_RULES: Dict[str, Tuple[str, str]] = {
    "compile-set-closure": (ERROR, (
        "enumerated step set != the step()-reachable dispatch set: a "
        "reachable shape outside the enumeration is never captured or "
        "checked, an unreachable enumerated shape captures dead code"
    )),
    "dropped-donation": (ERROR, (
        "a pool leaf the step writes is not updated in place, or a node "
        "makes a second tensor of a pool leaf's shape and dtype: both "
        "copies live, a 2x pool spike per step"
    )),
    "callback-in-executable": (ERROR, (
        "a host round trip inside a step (.item(), a Python branch on a "
        "tensor, a data-dependent nonzero, a copy to the CPU)"
    )),
    "sharding-constraint-drift": (ERROR, (
        "a tp or pp step copies a whole pool leaf (_to_copy / clone / "
        "copy_): the pool moves every step"
    )),
    "dtype-promotion-leak": (WARNING, (
        "a low-precision value is cast to f32 feeding a matmul on the "
        "compute path: 2x matmul bytes"
    )),
    "baked-constant-bloat": (WARNING, (
        "a large tensor is read as a constant of the traced step, not as an "
        "argument or the model's state"
    )),
    "trace-failure": (ERROR, (
        "an enumerated step refused to trace on the meta device: the "
        "static compile-set contract cannot be checked"
    )),
}

DEFAULT_MAX_CONST_BYTES = 8 * 1024 * 1024  # rope tables of small and medium
# models sit well under this; a baked weight leaf blows straight through it

_LOW_PRECISION = (torch.bfloat16, torch.float16)
aten = torch.ops.aten
_MATMULS = {aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default}
_COPIES = {aten._to_copy.default, aten.clone.default, aten.copy_.default}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _sig(t) -> str:
    return f"{_dtype_name(t.dtype)}{tuple(t.shape)}"


# ---------------------------------------------------------------------------
# per-step rules
# ---------------------------------------------------------------------------


def _placeholders(model) -> List[Any]:
    return [n for n in model.nodes if n.op == "placeholder"]


def _role_storages(traced: Traced, model, role: str) -> Dict[int, Tuple[str, torch.Tensor]]:
    """Storage id -> (arg name, tensor) of every placeholder of `role`."""
    spec = traced.spec
    names = {n for n, r in spec.roles.items() if r == role}
    phs = _placeholders(model)
    out: Dict[int, Tuple[str, torch.Tensor]] = {}
    for i, (name, t) in enumerate(traced.inputs):
        if name in names:
            out[model.of[phs[i]][0]] = (name, t)
    return out


def _ranked(tree) -> bool:
    """A tree keyed by rank or stage ({int: ...}): a tp or pp layout."""
    return isinstance(tree, dict) and bool(tree) and all(isinstance(k, int) for k in tree)


def _check_callback(traced: Traced, path: str) -> List[Finding]:
    e = traced.error
    return [Finding(
        rule="callback-in-executable", path=path, line=0, col=0,
        message=(
            f"{traced.spec.name} makes a host round trip (`{e.op}`) at {e.where}: "
            "a captured step cannot replay it and an eager one waits on the card "
            "every step (keep the value on the device, or move the read out of "
            "the step)"
        ),
        line_text=f"callback:{e.op}:{e.where}",
    )]


def _check_const_bloat(traced: Traced, path: str, max_bytes: int) -> List[Finding]:
    out: List[Finding] = []
    for name, c in traced.constants.items():
        if not isinstance(c, torch.Tensor):
            continue
        nb = c.numel() * c.element_size()
        if nb >= max_bytes:
            out.append(Finding(
                rule="baked-constant-bloat", path=path, line=0, col=0,
                message=(
                    f"{traced.spec.name} reads a {nb / 2**20:.1f} MiB {_sig(c)} tensor "
                    f"as a constant (threshold {max_bytes / 2**20:.0f} MiB): pass it "
                    "as an argument or keep it in the model's state"
                ),
                line_text=f"const:{_sig(c)}",
            ))
    return out


def _check_dtype_leaks(traced: Traced, path: str) -> List[Finding]:
    """A `_to_copy` from bf16/f16 to f32 reaching a matmul operand through
    views only: the matmul then runs at twice the compute dtype's bytes.
    Narrow by construction, as in the JAX rule: f32 softmax statistics or
    sampling upcasts feed no matmul and never flag."""
    hits: Dict[str, int] = {}
    for node in traced.graph.nodes:
        if node.op != "call_function" or node.target not in _MATMULS:
            continue
        for a in node.args:
            src = a
            while isinstance(src, Node) and view_source(src) is not None:
                src = view_source(src)
            if not isinstance(src, Node) or src.target is not aten._to_copy.default:
                continue
            inp = src.args[0].meta.get("val") if isinstance(src.args[0], Node) else None
            outv = src.meta.get("val")
            if (isinstance(inp, torch.Tensor) and inp.dtype in _LOW_PRECISION
                    and isinstance(outv, torch.Tensor) and outv.dtype == torch.float32):
                k = _dtype_name(inp.dtype)
                hits[k] = hits.get(k, 0) + 1
    return [Finding(
        rule="dtype-promotion-leak", path=path, line=0, col=0,
        message=(
            f"{traced.spec.name} casts {n}x {dt}->f32 directly feeding a matmul: "
            "the contraction runs at 2x the compute-path bytes (keep operands in "
            "the compute dtype)"
        ),
        line_text=f"leak:{dt}",
    ) for dt, n in sorted(hits.items())]


def _pool_checks(traced: Traced, model, path: str) -> Tuple[List[Finding], int]:
    """dropped-donation and sharding-constraint-drift over the pool leaves;
    returns (findings, leaves updated in place)."""
    spec = traced.spec
    pool = _role_storages(traced, model, "kv")
    if not pool:
        return [], 0
    written = {sid for sids in model.writes.values() for sid in sids}
    expected = [sid for sid, (name, _) in pool.items() if name in spec.writes]
    missing = [sid for sid in expected if sid not in written]
    sigs = {(tuple(t.shape), t.dtype) for _, t in pool.values()}
    dtypes = {t.dtype for _, t in pool.values()}
    leaf_bytes = min(model.nbytes[sid] for sid in pool)
    ranked = any(_ranked(spec.args.get(n)) for n in {n for n, _ in pool.values()})
    copies: Dict[str, List[str]] = {}  # rule -> ops
    for node in model.nodes:
        if node.op != "call_function":
            continue
        target = node.target
        val = node.meta.get("val")
        fresh = (type(val) is torch.Tensor and val.dtype in dtypes
                 and (tuple(val.shape), val.dtype) in sigs
                 and model.of.get(node) and model.kind[model.of[node][0]] == "temp")
        big_copy = False
        if target is aten.copy_.default:
            dst = model.of.get(node.args[0], [None])[0]
            src_pool = any(s in pool for s in model.of.get(node.args[1], ()))
            big_copy = src_pool and dst not in pool and model.nbytes[dst] >= leaf_bytes
        elif target in _COPIES and type(val) is torch.Tensor:
            from_pool = any(sid in pool for a in node.args[:1] if type(a) is Node
                            for sid in model.of.get(a, ()))
            big_copy = from_pool and val.numel() * val.element_size() >= leaf_bytes
        if not (fresh or big_copy):
            continue
        rule = ("sharding-constraint-drift" if ranked and target in _COPIES
                else "dropped-donation")
        copies.setdefault(rule, []).append(str(target))
    out: List[Finding] = []
    if missing:
        sig = _sig(pool[missing[0]][1])
        out.append(Finding(
            rule="dropped-donation", path=path, line=0, col=0,
            message=(
                f"{spec.name} writes {len(expected)} pool leaf(s) but only "
                f"{len(expected) - len(missing)} are updated in place (first missed: "
                f"{sig}): the step makes a new pool and both copies stay live — a 2x "
                "HBM spike per step (write the pool with index_put_/index_copy_/copy_)"
            ),
            line_text=f"donation:{len(missing)}",
        ))
    for rule, ops in sorted(copies.items()):
        what = ", ".join(sorted(set(ops)))
        if rule == "dropped-donation":
            message = (f"{spec.name} makes {len(ops)} second tensor(s) of a pool leaf's "
                       f"shape and dtype ({what}): both copies stay live — a 2x HBM spike "
                       "per step (update the pool in place)")
        else:
            message = (f"{spec.name} copies a whole pool leaf {len(ops)}x ({what}) inside a "
                       "tp/pp step: the pool moves every step (each rank and stage reads "
                       "its own pool in place)")
        out.append(Finding(rule=rule, path=path, line=0, col=0, message=message,
                           line_text=f"{rule}:{what}"))
    return out, len(expected) - len(missing)


# ---------------------------------------------------------------------------
# compile-set closure
# ---------------------------------------------------------------------------


def reachable_serving_set(
    serving: ServingConfig, max_batch: int, token_budget: int
) -> Set[Tuple[str, Tuple[int, ...]]]:
    """The dispatch signatures `ServingEngine.step()` can reach, derived
    INDEPENDENTLY from the ServingConfig (the engine's step routing): mixed
    always; verify iff spec_k (a turn where no slot drafts falls through to
    plain decode, so decode stays reachable); decode_chunk iff decode_chunk
    > 1, else decode; the tier's fetch and restore with a host tier.
    Deliberately a second implementation of the engine's
    `reachable_signatures`: diffing it against the enumeration is the
    closure proof."""
    sigs: Set[Tuple[str, Tuple[int, ...]]] = {("mixed", (int(max_batch), int(token_budget)))}
    if serving.spec_k:
        # exact-match verify at temperature 0, rejection-sampled above it
        label = "verify_sample" if serving.spec_verify_sampled() else "verify"
        sigs.add((label, (int(max_batch), int(serving.spec_k) + 1)))
        if serving.draft_model:
            # draft model: the mixed-step mirror + the catch-up/scan
            sigs.add(("draft_mixed", (int(max_batch), int(token_budget))))
            sigs.add(("draft_scan", (int(max_batch), int(serving.spec_k) + 2)))
    if serving.decode_chunk > 1:
        sigs.add(("decode_chunk", (int(max_batch), int(serving.decode_chunk))))
    else:
        sigs.add(("decode", (int(max_batch),)))
    if serving.host_pool_mib > 0:
        # host KV tier: swap-out gathers and restore scatters run in one
        # fixed transfer quantum, so the tier adds exactly two steps
        W = max(1, int(serving.swap_chunk_blocks))
        sigs.add(("fetch", (W,)))
        sigs.add(("restore", (W,)))
    return sigs


def _check_compile_set(engine, specs, origin: str) -> List[Finding]:
    path = f"{origin}::compile-set"
    enumerated = {(s.label, tuple(s.key)) for s in specs}
    reachable = reachable_serving_set(engine.cfg, engine.scheduler.max_batch,
                                      engine.token_budget)
    out: List[Finding] = []
    for label, key in sorted(reachable - enumerated):
        out.append(Finding(
            rule="compile-set-closure", path=path, line=0, col=0,
            message=(
                f"step() can dispatch {label}{key} but the engine does not "
                "enumerate it: the step is never checked, and on the card it is "
                "built mid-serve (fix enumerate_executables/reachable_signatures "
                "to cover every step() branch)"
            ),
            line_text=f"missing:{label}{key}",
        ))
    for label, key in sorted(enumerated - reachable):
        out.append(Finding(
            rule="compile-set-closure", path=path, line=0, col=0,
            message=(
                f"the engine enumerates {label}{key} but no step() branch can "
                "reach it under this ServingConfig: dead warm-up (capture time and "
                "device memory for a step that never runs)"
            ),
            line_text=f"unreachable:{label}{key}",
        ))
    return out


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def analyze_executables(
    specs: Sequence[Any],
    origin: str = "<specs>",
    compute_dtype: Optional[Any] = None,
    max_const_bytes: int = DEFAULT_MAX_CONST_BYTES,
    check_donation: bool = True,
) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """Trace every `StepSpec` (a `trace.Traced` is used as it is) and run
    the per-step rules.  Returns (findings, step records).
    `compute_dtype` (the weights' dtype) gates dtype-promotion-leak, which
    means something only over low-precision weights."""
    findings: List[Finding] = []
    records: List[Dict[str, Any]] = []
    leak_rule = compute_dtype is not None and _as_dtype(compute_dtype) in _LOW_PRECISION
    for traced in trace_all(specs):
        spec = traced.spec
        path = f"{origin}::{spec.name}"
        base = {"name": spec.name, "label": spec.label, "key": list(spec.key),
                "seconds": round(traced.seconds, 4)}
        if traced.error is not None:
            if isinstance(traced.error, HostRoundTrip):
                findings += _check_callback(traced, path)
            else:
                findings.append(Finding(
                    rule="trace-failure", path=path, line=0, col=0,
                    message=(f"{spec.name} failed to trace on the meta device: "
                             f"{type(traced.error).__name__}: {traced.error}"),
                    line_text="trace",
                ))
            records.append({**base, "error": str(traced.error)})
            continue
        model = traced.model
        here = _check_const_bloat(traced, path, max_const_bytes)
        if leak_rule:
            here += _check_dtype_leaks(traced, path)
        donated = 0
        if check_donation:
            pool_findings, donated = _pool_checks(traced, model, path)
            here += pool_findings
        findings += here
        records.append({**base, "nodes": len(model.nodes), "donated": donated,
                        "findings": len(here)})
    return findings, records


def _as_dtype(d):
    if isinstance(d, torch.dtype):
        return d
    return getattr(torch, str(d).replace("torch.", ""), None)


@dataclasses.dataclass
class IrReport:
    """One ir pass: findings + the traced step inventory."""

    origin: str
    findings: List[Finding]
    executables: List[Dict[str, Any]]
    suppressed: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def severity(self, f: Finding) -> str:
        return IR_RULES.get(f.rule, (ERROR, ""))[0]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if self.severity(f) == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if self.severity(f) == WARNING]

    def suppress(self, reasons: Dict[str, str]) -> None:
        """Move findings whose rule has a justified suppression out of the
        active set (they still print, marked suppressed, with their
        justification)."""
        keep: List[Finding] = []
        for f in self.findings:
            reason = reasons.get(f.rule)
            if reason:
                self.suppressed.append({"rule": f.rule, "path": f.path,
                                        "message": f.message, "justification": reason})
            else:
                keep.append(f)
        self.findings = keep

    def render_findings(self) -> List[str]:
        return [f"{f.path}: {self.severity(f)}: {f.rule}: {f.message}" for f in self.findings]

    def render_text(self) -> str:
        lines = [f"traced: {self.origin}"]
        for r in self.executables:
            if "error" in r:
                lines.append(f"  {r['name']:<24} TRACE FAILED: {r['error']}")
            else:
                lines.append(f"  {r['name']:<24} nodes={r['nodes']:<6} donated={r['donated']}")
        lines.extend(self.render_findings() or ["findings: none"])
        for s in self.suppressed:
            lines.append(f"suppressed: {s['rule']} ({s['justification']}): {s['message']}")
        return "\n".join(lines)

    def as_json(self) -> Dict[str, Any]:
        return {
            "origin": self.origin,
            "executables": self.executables,
            "findings": [{**f.__dict__, "severity": self.severity(f)} for f in self.findings],
            "suppressed": self.suppressed,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
        }


def device_kind_of(engine) -> Optional[str]:
    """The card a live engine runs on (its K1 knobs are planned for it when
    its steps are traced), None for an abstract or CPU engine."""
    dev = engine.gen.device
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else None


def trace_engine(engine, device_kind: Optional[str] = None) -> List[Traced]:
    """Every enumerated step of `engine`, traced once (ir and flow share
    them).  K1's split is planned for `device_kind` (default: the card a
    live engine runs on, else the NVIDIA H100 80GB HBM3)."""
    from mdi_llm_tpu_torch.ops import tuning

    kind = device_kind or device_kind_of(engine) or tuning._H100
    with tuning.planned_device(kind):
        return trace_all(engine.enumerate_executables())


def ir_preflight(
    engine,
    origin: Optional[str] = None,
    max_const_bytes: int = DEFAULT_MAX_CONST_BYTES,
    check_donation: bool = True,
    traces: Optional[List[Traced]] = None,
) -> IrReport:
    """Run the full rule set over one serving engine, abstract
    (`trace_serving`) or live (`cli.serve`: the steps are traced on the
    engine's meta twin; nothing runs on the card).  `traces` reuses a
    `trace_engine` result."""
    from mdi_llm_tpu_torch.models import transformer

    origin = origin or type(engine).__name__
    traces = trace_engine(engine) if traces is None else traces
    findings = _check_compile_set(engine, [t.spec for t in traces], origin)
    # the leak rule prices the card's bytes: a CPU engine's steps run the
    # plain versions, whose float32 arithmetic is the reference math
    dtype = None if engine.gen.device.type == "cpu" else transformer.param_dtype(
        engine.gen.params)
    per_step, records = analyze_executables(
        traces, origin=origin, compute_dtype=dtype,
        max_const_bytes=max_const_bytes, check_donation=check_donation,
    )
    return IrReport(origin=origin, findings=findings + per_step, executables=records)


def trace_serving(
    cfg: Config,
    serving: Optional[ServingConfig] = None,
    tp: int = 1,
    pp: int = 1,
    dtype: str = "bfloat16",
    quantize: Optional[str] = None,
    max_seq_length: Optional[int] = None,
    scan_unroll: int = 1,
):
    """Build the ENTIRE serving engine abstractly for a (Config, mesh,
    ServingConfig) tuple: meta parameter stubs (`analysis.plan.
    abstract_params`, quantized layout included), `Generator(abstract=
    True)` on a mesh of meta devices (tp ranks and pp stages all on the
    meta device), and `.serve()`, which routes to the flat or the
    pipelined engine exactly as a real launch.  Returns the engine; run
    `ir_preflight` on it.  Allocates nothing on a card."""
    from mdi_llm_tpu_torch.analysis.plan import abstract_params
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh, pipeline_mesh

    serving = serving if serving is not None else ServingConfig()
    tp, pp = int(tp), int(pp)
    if tp < 1 or pp < 1:
        raise ValueError(f"tp={tp} and pp={pp} must be >= 1")
    mesh = None
    if pp > 1:
        mesh = pipeline_mesh(pp, ["meta"], tp=tp)
    elif tp > 1:
        mesh = make_mesh({"tp": tp}, ["meta"])
    params = abstract_params(cfg, dtype=dtype, quantize=quantize)
    gen = Generator(cfg, params, max_seq_length=max_seq_length, mesh=mesh,
                    scan_unroll=scan_unroll, abstract=True)
    return gen.serve(serving=serving)


# ---------------------------------------------------------------------------
# launch gate (cli.serve)
# ---------------------------------------------------------------------------


def ir_refusal_text(tool: str) -> str:
    return (f"{tool}: ir preflight refused the launch "
            "(re-run with --no-preflight to launch anyway)")


def enforce_ir_preflight(report: IrReport, tool: str, allow: bool = False, emit=None) -> bool:
    """Emit every finding; refuse (SystemExit) on errors unless `allow`
    (--no-preflight)."""
    if emit is None:
        def emit(line):
            print(line, file=sys.stderr)
    for line in report.render_findings():
        emit(f"{tool}: ir-preflight: {line}")
    if not report.errors or allow:
        return True
    raise SystemExit(ir_refusal_text(tool))


def ir_detail(report: IrReport) -> Dict[str, Any]:
    """The compact record a stats line carries."""
    return {
        "findings": len(report.errors),
        "warnings": len(report.warnings),
        "executables": {r["name"]: r.get("nodes") for r in report.executables},
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def add_plan_args(ap: argparse.ArgumentParser, top_k: bool = True) -> None:
    """The (model, mesh, ServingConfig) flags ir and flow share (the JAX
    CLIs': flow takes no `--top-k`)."""
    src = ap.add_argument_group("model source")
    src.add_argument("--model", default=None, help="registry model name")
    src.add_argument("--config", default=None, metavar="FILE",
                     help="model_config.yaml / config.json to trace")
    par = ap.add_argument_group("parallel plan")
    par.add_argument("--tp", type=int, default=1,
                     help="tensor-parallel ranks (all on the meta device)")
    par.add_argument("--pp", type=int, default=1,
                     help="pipeline-parallel serving stages (>=2 routes to "
                     "PipelinedServingEngine, exactly like a real launch)")
    run = ap.add_argument_group("run shape")
    run.add_argument("--seq-len", type=int, default=None,
                     help="engine window (default: model context)")
    run.add_argument("--dtype", default="bfloat16",
                     choices=("bfloat16", "float16", "float32"))
    run.add_argument("--quantize", default="none", choices=("none", "int8", "w8a8"))
    srv = ap.add_argument_group("serving (ServingConfig)")
    srv.add_argument("--block-size", type=int, default=16)
    srv.add_argument("--max-batch", type=int, default=8)
    srv.add_argument("--prefill-chunk", type=int, default=128)
    srv.add_argument("--token-budget", type=int, default=None)
    srv.add_argument("--decode-chunk", type=int, default=8)
    srv.add_argument("--spec-k", type=int, default=0)
    srv.add_argument("--temperature", type=float, default=0.0,
                     help="0 traces the exact-match verify; >0 the rejection-sampled one")
    if top_k:
        srv.add_argument("--top-k", type=int, default=None)
    srv.add_argument("--top-p", type=float, default=None)
    srv.add_argument("--draft-model", default=None, metavar="NAME",
                     help="registry name of a small draft model: traces the "
                     "draft_mixed/draft_scan steps and the draft pool")
    srv.add_argument("--draft-share", type=float, default=0.25,
                     help="fraction of a bounded block budget carved out for "
                     "the draft pool (default 0.25)")
    srv.add_argument("--kv-dtype", default="auto", help="paged-pool storage dtype (e.g. int8)")


def serving_from_args(args) -> ServingConfig:
    return ServingConfig(
        block_size=args.block_size,
        max_batch=args.max_batch,
        prefill_chunk=args.prefill_chunk,
        token_budget=args.token_budget,
        decode_chunk=args.decode_chunk,
        spec_k=args.spec_k,
        temperature=getattr(args, "temperature", 0.0),
        top_k=getattr(args, "top_k", None),
        top_p=getattr(args, "top_p", None),
        draft_model=getattr(args, "draft_model", None),
        draft_share=getattr(args, "draft_share", 0.25),
        kv_dtype=None if args.kv_dtype == "auto" else args.kv_dtype,
        host_pool_mib=getattr(args, "host_pool_mib", 0),
        host_link_gbps=getattr(args, "host_link_gbps", None),
    )


def config_from_args(args) -> Config:
    if args.config:
        return Config.from_file(args.config)
    if args.model:
        return Config.from_name(args.model)
    raise ValueError("need --model or --config")


def engine_from_args(args):
    return trace_serving(
        config_from_args(args), serving_from_args(args), tp=args.tp, pp=args.pp,
        dtype=args.dtype, quantize=None if args.quantize == "none" else args.quantize,
        max_seq_length=args.seq_len,
    )


def parse_suppressions(items: Sequence[str], rules: Dict[str, Any]) -> Dict[str, str]:
    """RULE=why pairs; ValueError names an unknown rule or a missing
    justification."""
    reasons: Dict[str, str] = {}
    for s in items:
        rule, _, why = s.partition("=")
        rule, why = rule.strip(), why.strip()
        if rule not in rules:
            raise ValueError(f"unknown rule in --suppress: {rule!r}")
        if not why:
            raise ValueError(f"--suppress requires a justification: {rule}=<why this "
                             "is acceptable>")
        reasons[rule] = why
    return reasons


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mdi_llm_tpu_torch.analysis ir",
        description="Static analysis of the serving steps: trace every step a "
        "(model, mesh, ServingConfig) tuple can dispatch on the meta device (no "
        "checkpoint, no card) and check compile-set closure, in-place pool "
        "updates and graph hygiene",
    )
    add_plan_args(ap)
    seq = ap.add_argument_group("sequential generate() path")
    seq.add_argument("--sequential", action="store_true",
                     help="also trace the generate() steps of the workload below")
    seq.add_argument("--batch", type=int, default=1)
    seq.add_argument("--prompt-len", type=int, default=32)
    seq.add_argument("--new-tokens", type=int, default=32)
    seq.add_argument("--chunk-size", type=int, default=16)
    seq.add_argument("--speculative", type=int, default=None)
    ap.add_argument("--const-bytes", "--max-const-bytes", dest="max_const_bytes", type=int,
                    default=DEFAULT_MAX_CONST_BYTES,
                    help="baked-constant-bloat threshold in bytes")
    ap.add_argument("--no-donation-check", action="store_true",
                    help="skip the dropped-donation and sharding-constraint-drift rules")
    ap.add_argument("--suppress", action="append", default=[], metavar="RULE=WHY",
                    help="suppress a rule WITH a justification (mandatory); repeatable")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="grandfather findings via a lint-style baseline")
    ap.add_argument("--update-baseline", default=None, metavar="FILE",
                    help="write the current findings as the baseline and exit 0")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-checks", action="store_true",
                    help="print the rule registry and exit")
    return ap


def list_checks(rules: Dict[str, Tuple[str, str]]) -> None:
    width = max(len(c) for c in rules)
    for code, (sev, summary) in rules.items():
        print(f"{code:<{width}}  [{sev}] {summary}")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_checks:
        list_checks(IR_RULES)
        return 0
    try:
        reasons = parse_suppressions(args.suppress, IR_RULES)
        engine = engine_from_args(args)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"ir: {e}", file=sys.stderr)
        return 2
    origin = (args.model or Path(args.config).stem) + "".join(
        t for t in (f"@tp{args.tp}" if args.tp > 1 else "", f"@pp{args.pp}" if args.pp > 1 else ""))
    report = ir_preflight(engine, origin=origin, max_const_bytes=args.max_const_bytes,
                          check_donation=not args.no_donation_check)
    if args.sequential:
        try:
            seq_specs = engine.gen.enumerate_executables(
                batch_size=args.batch, prompt_len=args.prompt_len,
                max_new_tokens=args.new_tokens, chunk_size=args.chunk_size,
                speculative=args.speculative)
        except ValueError as e:
            print(f"ir: {e}", file=sys.stderr)
            return 2
        f2, r2 = analyze_executables(seq_specs, origin=f"{origin}:generate",
                                     compute_dtype=args.dtype,
                                     max_const_bytes=args.max_const_bytes,
                                     check_donation=not args.no_donation_check)
        report.findings += f2
        report.executables += r2
    report.suppress(reasons)
    if args.update_baseline:
        Baseline.from_findings(report.findings).save(Path(args.update_baseline))
        print(f"ir: wrote {len(report.findings)} finding(s) to {args.update_baseline}")
        return 0
    errors = report.errors
    if args.baseline:
        errors, _old = Baseline.load(Path(args.baseline)).split(errors)
    if args.format == "json":
        out = report.as_json()
        out["new_errors"] = len(errors)
        print(json.dumps(out, indent=2))
    else:
        print(report.render_text())
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
