"""`flow`: buffer liveness over the traced step graphs of the serving
compile set.

Port of `mdi_llm_tpu/analysis/liveness.py` (`mdi-flow`).  ir
(`analysis/ir.py`) proves what is built; flow proves what is live when:
per-storage live ranges over each step's graph (`analysis/trace.py`), the
pool's in-place writes, and a static peak of device memory per step, with
no card and no compile.

The static model (the JAX model: arguments + outputs - aliases + the
temporaries' peak), on fx graphs of meta tensors:

- **arguments** — the step's graph inputs (the weights, the pool, the
  sampling operands, the run operands), each storage once: a tp rank's or
  pp stage's weights are views of the one tree, which counts whole.
- **outputs / aliases** — the tensors the body returns, plus every pool
  leaf it updates in place; those pool bytes are the aliases (the JAX
  donated pool is an output aliased with its input: the same sum).
- **temporaries** — a def/last-use sweep over the nodes.  What the
  jaxpr version never had to model:
  - views alias storage: `view`, `slice`, `select`, `permute`, `expand`,
    `t`, `transpose`, `unsqueeze`, `_unsafe_view` (any operator whose
    schema marks its result as an alias of an argument) add no bytes and
    keep their base alive until the last use of any alias;
  - in-place operators (a schema that writes its argument) return their
    first argument's storage;
  - custom operators: K1's output and its split workspace are two
    temporaries defined at its node (the operator returns both), K2's
    output and LSE likewise;
  - the graph unrolls both the layer loop and the K-step decode chunk:
    there is no `scan` body to count once, so the interior peak is a
    plain def/last-use sweep over all nodes.
- **per-device attribution** — an argument laid out per rank or stage
  ({int: tree}: the tp ranks' slices, the pp stages' blocks, the
  per-rank pools) counts its largest rank's or stage's bytes per device
  (the JAX `_params_device_fraction` and the pool's declared sharding
  give the same: a rank's Megatron slice, a stage's layers); temporaries
  count whole (every rank of one card runs in the one graph:
  conservative, never optimistic).

Rules (FLOW_RULES; `jaxpr-drift` is `graph-drift` here):

- **missed-donation** [warning] — a large (>= `--min-bytes`) argument that
  is not written in place although the step returns a fresh tensor of its
  shape and dtype: updating it in place would drop one buffer.
- **live-range-bloat** [warning] — JAX: a buffer threaded through a
  `scan`/`while`/`cond` whose body never reads it.  The fx graph unrolls
  those loops, so the rule is defined over the unrolled graph: its units
  are the repetitions of the loop, marked by the reads of the weight leaf
  read most often (each layer of each decode step reads the stacked
  weights once); a temporary >= `--min-bytes` that stays live across a
  whole unit without being read is dead payload carried through that
  iteration.
- **hbm-over-budget** [error] — params + pool per device (the byte-exact
  `ServingConfig` formulas, as JAX) plus the worst step's other live
  bytes exceed `--hbm-gb`.
- **peak-memory-regression** [error] — a step's static peak grew beyond
  its golden budget (`flow-goldens.json` beside this module, the port's
  own; `--update-goldens` re-baselines deliberately).
- **graph-drift** [warning] — a step's canonical graph digest no longer
  matches its golden; the finding carries the op-level diff.
- **trace-failure** [error] — a step refused to trace (a host round trip
  included): no liveness claim can be made about it.

CLI: ``python -m mdi_llm_tpu_torch.analysis flow --model pythia-14m
--tp 2``; ``--hbm-gb``, ``--goldens`` / ``--update-goldens``,
``--min-bytes``, ``--format json``, ``--baseline`` /
``--update-baseline``, ``--suppress RULE=justification``,
``--list-checks``.  Exit 0 clean, 1 on findings, 2 on usage errors.
`cli.serve` runs `flow_preflight` + `enforce_flow_preflight`; `check`
and `audit --liveness` call it too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from mdi_llm_tpu_torch.analysis.core import Baseline, Finding
from mdi_llm_tpu_torch.analysis.ir import (
    add_plan_args,
    engine_from_args,
    list_checks,
    parse_suppressions,
    trace_engine,
)
from mdi_llm_tpu_torch.analysis.trace import (
    Node,
    Traced,
    digest,
    leaves_of,
    trace_all,
)

__all__ = [
    "FLOW_RULES",
    "ExecProfile",
    "FlowReport",
    "analyze_flow",
    "device_bytes",
    "enforce_flow_preflight",
    "flow_detail",
    "flow_preflight",
    "load_goldens",
    "main",
    "profile_executable",
    "write_goldens",
]

ERROR, WARNING = "error", "warning"

# rule -> (severity, one-line summary); --list-checks prints this
FLOW_RULES: Dict[str, Tuple[str, str]] = {
    "missed-donation": (WARNING, (
        "a large argument is not updated in place although the step returns a "
        "fresh tensor of its shape and dtype: both copies stay live"
    )),
    "live-range-bloat": (WARNING, (
        "a large temporary stays live across a whole unrolled layer or decode "
        "step that never reads it: dead payload"
    )),
    "hbm-over-budget": (ERROR, (
        "the per-device static high-water (params + pool + worst step's live "
        "temporaries) exceeds the --hbm-gb budget"
    )),
    "peak-memory-regression": (ERROR, (
        "a step's static peak grew beyond its committed golden budget by more "
        "than the tolerance (--update-goldens re-baselines deliberately)"
    )),
    "graph-drift": (WARNING, (
        "a step's canonical graph digest drifted from the committed golden; "
        "the finding carries the op-level diff"
    )),
    "trace-failure": (ERROR, (
        "an enumerated step refused to trace on the meta device: no liveness "
        "claim can be made about it"
    )),
}

DEFAULT_MIN_BYTES = 1 * 1024 * 1024  # missed-donation / live-range-bloat floor
DEFAULT_GOLDEN_TOLERANCE = 0.10  # peak-memory-regression trip point
GiB = float(1024**3)
# the port's goldens, beside this module (`goldens/flow-goldens.json` at the
# repository root is the JAX package's)
DEFAULT_GOLDENS = Path(__file__).resolve().parent / "flow-goldens.json"


def _fmt_bytes(n: int) -> str:
    return f"{n / 2**20:.1f} MiB" if n >= 2**20 else f"{n} B"


def _sig(t) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{tuple(t.shape)}"


def _nb(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# byte attribution
# ---------------------------------------------------------------------------


def _root(t: torch.Tensor) -> torch.Tensor:
    return t._base if t._base is not None else t


def global_bytes(tree) -> int:
    """Bytes of a tree's storages, each once (views count their base)."""
    roots = {id(_root(t)): _root(t) for t in leaves_of(tree)}
    return sum(_nb(r) for r in roots.values())


def device_bytes(tree) -> int:
    """Bytes one device holds of a tree: a tree keyed by rank or stage
    ({int: ...}) its largest entry's, any other tree its leaves' (each
    leaf's own size: a rank's slice counts the slice)."""
    if isinstance(tree, dict) and tree and all(isinstance(k, int) for k in tree):
        return max(device_bytes(v) for v in tree.values())
    seen = {id(t): t for t in leaves_of(tree)}
    return sum(_nb(t) for t in seen.values())


# ---------------------------------------------------------------------------
# one step's profile
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExecProfile:
    """The liveness profile of ONE step: the static byte model (args +
    outputs - aliases + the temporaries' peak, global and per device), the
    params and pool terms, and the canonical graph digest."""

    name: str
    label: str
    key: Tuple
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    temp_peak_bytes: int
    device_argument_bytes: int
    device_output_bytes: int
    device_alias_bytes: int
    params_bytes: int
    pool_bytes: int
    device_params_bytes: int
    device_pool_bytes: int
    nodes: int
    graph: Any = dataclasses.field(default=None, repr=False, compare=False)
    _digest: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def digest(self) -> str:
        """The canonical graph digest (computed at first use: the serve's
        preflight never reads it)."""
        if self._digest is None:
            self._digest = digest(self.graph)
        return self._digest[0]

    @property
    def ops(self) -> Dict[str, int]:
        self.digest  # noqa: B018 (fills _digest)
        return self._digest[1]

    @property
    def peak_bytes(self) -> int:
        return (self.argument_bytes + self.output_bytes - self.alias_bytes
                + self.temp_peak_bytes)

    @property
    def device_peak_bytes(self) -> int:
        return (self.device_argument_bytes + self.device_output_bytes
                - self.device_alias_bytes + self.temp_peak_bytes)

    def as_record(self) -> Dict[str, Any]:
        return {
            "name": self.name, "label": self.label, "key": list(self.key),
            "nodes": self.nodes,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "alias_bytes": self.alias_bytes,
            "temp_peak_bytes": self.temp_peak_bytes,
            "peak_bytes": self.peak_bytes,
            "device_peak_bytes": self.device_peak_bytes,
            "params_bytes": self.params_bytes,
            "pool_bytes": self.pool_bytes,
            "digest": self.digest,
        }


def _temp_peak(model) -> int:
    """The temporaries' peak: every storage defined by a node and not
    returned, live from its definition to its last use."""
    n = len(model.nodes)
    delta = [0] * (n + 1)
    outs = set(model.outputs)
    for sid, kind in enumerate(model.kind):
        if kind != "temp" or sid in outs:
            continue
        delta[model.defined[sid]] += model.nbytes[sid]
        delta[model.last_use[sid] + 1] -= model.nbytes[sid]
    peak = cur = 0
    for i in range(n):
        cur += delta[i]
        peak = max(peak, cur)
    return peak


def _written(model) -> set:
    return {sid for sids in model.writes.values() for sid in sids}


def profile_executable(traced, model=None) -> ExecProfile:
    """The liveness profile of one traced step (a `StepSpec` is traced
    here).  Pure host arithmetic over the graph: no card."""
    if not isinstance(traced, Traced):
        traced = trace_all([traced])[0]
    if traced.error is not None:
        raise ValueError(f"{traced.spec.name} did not trace: {traced.error}")
    spec = traced.spec
    model = traced.model if model is None else model
    roles = spec.roles
    written = _written(model)
    phs = [nd for nd in model.nodes if nd.op == "placeholder"]
    pool_args = [n for n, r in roles.items() if r == "kv" and n in spec.args]
    param_args = [n for n, r in roles.items() if r == "params" and n in spec.args]
    # pool leaves written in place: the JAX donated outputs
    ph_sid = {id(t): model.of[phs[i]][0] for i, (_, t) in enumerate(traced.inputs)}
    alias = [t for n in pool_args for t in leaves_of(spec.args[n]) if ph_sid.get(id(t)) in written]
    alias_b = sum(_nb(t) for t in alias)
    alias_ids = {id(t) for t in alias}

    def dev_alias(tree):
        if isinstance(tree, dict) and tree and all(isinstance(k, int) for k in tree):
            return max(dev_alias(v) for v in tree.values())
        return sum(_nb(t) for t in leaves_of(tree) if id(t) in alias_ids)

    args_b = global_bytes(list(spec.args.values()))
    dev_args = sum(device_bytes(v) for v in spec.args.values())
    ret_b = sum(model.nbytes[sid] for sid in set(model.outputs))
    params_b = global_bytes([spec.args[n] for n in param_args])
    pool_b = global_bytes([spec.args[n] for n in pool_args])
    dev_params = sum(device_bytes(spec.args[n]) for n in param_args)
    dev_pool = sum(device_bytes(spec.args[n]) for n in pool_args)
    dev_alias_b = sum(dev_alias(spec.args[n]) for n in pool_args)
    return ExecProfile(
        name=spec.name, label=spec.label, key=tuple(spec.key),
        argument_bytes=int(args_b), output_bytes=int(ret_b + alias_b),
        alias_bytes=int(alias_b), temp_peak_bytes=int(_temp_peak(model)),
        device_argument_bytes=int(dev_args), device_output_bytes=int(ret_b + dev_alias_b),
        device_alias_bytes=int(dev_alias_b),
        params_bytes=int(params_b), pool_bytes=int(pool_b),
        device_params_bytes=int(dev_params), device_pool_bytes=int(dev_pool),
        nodes=len(model.nodes), graph=traced.graph,
    )


# ---------------------------------------------------------------------------
# rules over one step
# ---------------------------------------------------------------------------


def _check_missed_donation(traced, model, path: str, min_bytes: int) -> List[Finding]:
    """Arguments >= min_bytes, not written in place, whose (shape, dtype)
    matches a fresh tensor the step returns."""
    spec = traced.spec
    written = _written(model)
    outs = {}
    for sid in set(model.outputs):
        if model.kind[sid] == "temp":
            val = model.nodes[model.defined[sid]].meta.get("val")
            vals = val if isinstance(val, (list, tuple)) else [val]
            for v in vals:
                if isinstance(v, torch.Tensor) and _nb(v) == model.nbytes[sid]:
                    outs.setdefault((tuple(v.shape), v.dtype), 0)
                    outs[(tuple(v.shape), v.dtype)] += 1
                    break
    if not outs:
        return []
    phs = [nd for nd in model.nodes if nd.op == "placeholder"]
    out: List[Finding] = []
    for i, (name, t) in enumerate(traced.inputs):
        sid = model.of[phs[i]][0]
        sig = (tuple(t.shape), t.dtype)
        if sid in written or _nb(t) < min_bytes or outs.get(sig, 0) <= 0:
            continue
        outs[sig] -= 1
        out.append(Finding(
            rule="missed-donation", path=path, line=0, col=0,
            message=(
                f"{spec.name} takes a {_fmt_bytes(_nb(t))} {_sig(t)} argument "
                f"({name!r}) and returns a fresh tensor of its signature without "
                f"updating it in place: both copies stay live — write {name!r} in "
                f"place to drop {_fmt_bytes(_nb(t))} from the high-water"
            ),
            line_text=f"missed-donation:{name}:{_sig(t)}",
        ))
    return out


def _units(traced, model) -> List[int]:
    """Node indices that start a repetition of the unrolled loops: the
    direct reads of the weight leaf read most often (each layer of each
    step takes its slice of the stacked weights once); [] when no weight
    is read twice."""
    spec = traced.spec
    names = {n for n, r in spec.roles.items() if r == "params"}
    phs = [nd for nd in model.nodes if nd.op == "placeholder"]
    weights = {phs[i] for i, (n, _) in enumerate(traced.inputs) if n in names}
    reads: Dict[Any, List[int]] = {w: [] for w in weights}
    for i, node in enumerate(model.nodes):
        for a in node.args:
            if isinstance(a, Node) and a in reads:
                reads[a].append(i)
    best = max(reads.values(), key=len, default=[])
    return best if len(best) >= 2 else []


def _check_live_range_bloat(traced, model, path: str, min_bytes: int) -> List[Finding]:
    units = _units(traced, model)
    if not units:
        return []
    outs = set(model.outputs)
    out: List[Finding] = []
    for sid, kind in enumerate(model.kind):
        if kind != "temp" or model.nbytes[sid] < min_bytes:
            continue
        reads = [model.defined[sid]] + model.uses[sid]
        if sid in outs:
            reads.append(len(model.nodes))
        for a, b in zip(reads, reads[1:]):
            crossed = sum(1 for u in units if a < u < b)
            if crossed >= 2:  # a whole unit went by without a read
                node = model.nodes[model.defined[sid]]
                val = node.meta.get("val")
                sig = _sig(val) if isinstance(val, torch.Tensor) else "?"
                out.append(Finding(
                    rule="live-range-bloat", path=path, line=0, col=0,
                    message=(
                        f"{traced.spec.name} holds a {_fmt_bytes(model.nbytes[sid])} "
                        f"{sig} buffer (defined at node #{model.defined[sid]} "
                        f"`{node.target}`) live across {crossed - 1} whole unrolled "
                        f"layer/step(s) that never read it (next read at node #{b}): "
                        "dead payload — compute it where it is read"
                    ),
                    line_text=f"bloat:{node.target}:{sig}",
                ))
                break
    return out


# ---------------------------------------------------------------------------
# goldens (budgets + digests)
# ---------------------------------------------------------------------------


def load_goldens(path: Path) -> Dict[str, Any]:
    data = json.loads(Path(path).read_text())
    if not isinstance(data, dict) or "budgets" not in data:
        raise ValueError(f"{path}: not a flow goldens file (no 'budgets')")
    return data


def write_goldens(path: Path, origin: str, profiles: Sequence[ExecProfile],
                  tolerance: float = DEFAULT_GOLDEN_TOLERANCE) -> Dict[str, Any]:
    """Merge this origin's budgets and digests into the goldens file (other
    origins' entries are kept: the file gathers origins one
    `--update-goldens` run at a time)."""
    path = Path(path)
    try:
        data = load_goldens(path)
    except (OSError, ValueError, json.JSONDecodeError):
        data = {"version": 1, "tolerance": tolerance, "budgets": {}}
    for p in profiles:
        data["budgets"][f"{origin}::{p.name}"] = {
            "peak_bytes": p.peak_bytes,
            "device_peak_bytes": p.device_peak_bytes,
            "digest": p.digest,
            "ops": dict(sorted(p.ops.items())),
        }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    return data


def _op_diff(golden: Dict[str, int], current: Dict[str, int]) -> str:
    deltas = []
    for op in sorted(set(golden) | set(current)):
        d = current.get(op, 0) - golden.get(op, 0)
        if d:
            deltas.append(f"{'+' if d > 0 else ''}{d} {op}")
    return ", ".join(deltas) if deltas else "op counts unchanged"


def _check_goldens(profiles: Sequence[ExecProfile], goldens: Dict[str, Any], origin: str,
                   tolerance: Optional[float] = None) -> List[Finding]:
    tol = tolerance if tolerance is not None else float(
        goldens.get("tolerance", DEFAULT_GOLDEN_TOLERANCE))
    budgets = goldens.get("budgets", {})
    out: List[Finding] = []
    for p in profiles:
        path = f"{origin}::{p.name}"
        entry = budgets.get(path)
        if entry is None:
            continue  # no committed budget for this tuple: nothing to pin
        golden_peak = int(entry.get("peak_bytes", 0))
        if golden_peak and p.peak_bytes > golden_peak * (1 + tol):
            grew = p.peak_bytes / golden_peak - 1
            out.append(Finding(
                rule="peak-memory-regression", path=path, line=0, col=0,
                message=(
                    f"{p.name} static peak {_fmt_bytes(p.peak_bytes)} is {grew:+.1%} over "
                    f"its golden budget {_fmt_bytes(golden_peak)} (tolerance {tol:.0%}): "
                    "a live-range or in-place regression — fix it, or re-baseline "
                    "deliberately with --update-goldens"
                ),
                line_text=f"regression:{p.name}",
            ))
        golden_digest = entry.get("digest")
        if golden_digest and golden_digest != p.digest:
            out.append(Finding(
                rule="graph-drift", path=path, line=0, col=0,
                message=(
                    f"{p.name} canonical graph digest {p.digest} != golden "
                    f"{golden_digest}; op-level diff: {_op_diff(entry.get('ops', {}), p.ops)} "
                    "(review the graph churn, then --update-goldens)"
                ),
                line_text=f"drift:{p.name}",
            ))
    return out


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def analyze_flow(specs: Sequence[Any], origin: str = "<specs>",
                 min_bytes: int = DEFAULT_MIN_BYTES) -> Tuple[List[Finding], List[ExecProfile]]:
    """Trace every `StepSpec` (a `trace.Traced` is used as it is), build
    its profile and run the per-step rules (missed-donation,
    live-range-bloat).  Returns (findings, profiles)."""
    findings: List[Finding] = []
    profiles: List[ExecProfile] = []
    for traced in trace_all(specs):
        path = f"{origin}::{traced.spec.name}"
        if traced.error is not None:
            findings.append(Finding(
                rule="trace-failure", path=path, line=0, col=0,
                message=(f"{traced.spec.name} failed to trace on the meta device: "
                         f"{type(traced.error).__name__}: {traced.error}"),
                line_text="trace",
            ))
            continue
        model = traced.model
        profiles.append(profile_executable(traced, model))
        findings += _check_missed_donation(traced, model, path, min_bytes)
        findings += _check_live_range_bloat(traced, model, path, min_bytes)
    return findings, profiles


@dataclasses.dataclass
class FlowReport:
    """One flow pass: findings + the per-step liveness profiles."""

    origin: str
    findings: List[Finding]
    profiles: List[ExecProfile]
    breakdown: Dict[str, Any] = dataclasses.field(default_factory=dict)
    suppressed: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def severity(self, f: Finding) -> str:
        return FLOW_RULES.get(f.rule, (ERROR, ""))[0]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if self.severity(f) == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if self.severity(f) == WARNING]

    def suppress(self, reasons: Dict[str, str]) -> None:
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
        lines = [f"liveness: {self.origin}"]
        for p in self.profiles:
            lines.append(
                f"  {p.name:<24} peak={p.peak_bytes / 2**20:8.1f} MiB  "
                f"(args={p.argument_bytes / 2**20:.1f} out={p.output_bytes / 2**20:.1f} "
                f"alias=-{p.alias_bytes / 2**20:.1f} temps={p.temp_peak_bytes / 2**20:.1f})  "
                f"dev={p.device_peak_bytes / 2**20:.1f} MiB  digest={p.digest}"
            )
        dev = self.breakdown.get("per_device")
        if dev:
            lines.append(
                f"  per-device high-water: {dev['high_water_bytes'] / 2**20:.1f} MiB "
                f"(params {dev['params_bytes'] / 2**20:.1f} + pool "
                f"{dev['pool_bytes'] / 2**20:.1f} + worst-step temps/operands, at "
                f"{dev['worst_executable']})"
            )
        lines.extend(self.render_findings() or ["findings: none"])
        for s in self.suppressed:
            lines.append(f"suppressed: {s['rule']} ({s['justification']}): {s['message']}")
        return "\n".join(lines)

    def as_json(self) -> Dict[str, Any]:
        return {
            "origin": self.origin,
            "executables": [p.as_record() for p in self.profiles],
            "breakdown": self.breakdown,
            "findings": [{**f.__dict__, "severity": self.severity(f)} for f in self.findings],
            "suppressed": self.suppressed,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
        }


def _pool_term(engine) -> int:
    """Per-device pool bytes from the ServingConfig formulas (the JAX
    budget's), the staged pool's largest stage under pp."""
    gen, serving = engine.gen, engine.cfg
    cfg = gen.cfg
    tp = int(getattr(gen, "tp", 1) or 1)
    pp = int(getattr(engine, "n_stages", 1) or 1)
    if pp > 1:
        tp = int(engine._tp)
    kv_name = serving.resolved_kv_dtype(str(gen.cache_dtype).replace("torch.", ""))
    try:
        pool_dev = serving.pool_bytes_per_device(cfg, tp, gen.max_seq_length, kv_name)
    except (AttributeError, TypeError, ValueError):
        pool_dev = serving.pool_bytes(cfg, gen.max_seq_length) // max(1, tp)
    if pp > 1 and cfg.n_layer >= pp:
        from mdi_llm_tpu_torch.parallel.partition import stage_layers

        pool_dev = pool_dev // cfg.n_layer * max(stage_layers(cfg.n_layer, pp))
    return int(pool_dev)


def budget_terms(engine) -> Dict[str, int]:
    """The per-device params and pool terms of the HBM budget: the weights
    as the steps read them (a tp rank's slices, a pp stage's blocks and
    head) and the pool formula."""
    return {"params_bytes": device_bytes(engine._step_params(engine.gen)),
            "pool_bytes": _pool_term(engine)}


def _check_hbm_budget(engine, profiles: Sequence[ExecProfile], origin: str, hbm_gb: float,
                      breakdown: Dict[str, Any]) -> List[Finding]:
    """Per-device static high-water vs the budget: params + pool, plus the
    worst step's per-device live bytes beyond them (other operands,
    outputs, the temporaries' peak)."""
    gen, serving = engine.gen, engine.cfg
    cfg = gen.cfg
    terms = budget_terms(engine)
    params_dev, pool_dev = terms["params_bytes"], terms["pool_bytes"]
    worst, worst_rest = None, 0
    for p in profiles:
        rest = max(0, p.device_peak_bytes - p.device_params_bytes - p.device_alias_bytes
                   - (p.device_pool_bytes - p.device_alias_bytes))
        if worst is None or rest > worst_rest:
            worst, worst_rest = p, rest
    host_credit = 0
    if serving.host_pool_mib > 0:
        # host KV tier: swapped-out and spilled blocks return to the free
        # list, so the resident peak drops by the swappable share (block 0,
        # the trash block, never leaves the card)
        kv_name = serving.resolved_kv_dtype(str(gen.cache_dtype).replace("torch.", ""))
        max_seq = int(min(gen.max_seq_length or cfg.block_size, cfg.block_size))
        n_blocks = serving.num_pool_blocks(max_seq)
        per_block_dev = pool_dev // max(1, n_blocks)
        host_credit = min(serving.num_host_blocks(cfg, kv_name), max(0, n_blocks - 1)) \
            * per_block_dev
    high_water = params_dev + pool_dev - host_credit + worst_rest
    breakdown["per_device"] = {
        "params_bytes": int(params_dev),
        "pool_bytes": int(pool_dev),
        "host_credit_bytes": int(host_credit),
        "high_water_bytes": int(high_water),
        "worst_executable": worst.name if worst else None,
    }
    budget = int(float(hbm_gb) * GiB)
    breakdown["budget_bytes"] = budget
    if high_water <= budget:
        return []
    return [Finding(
        rule="hbm-over-budget", path=f"{origin}::budget", line=0, col=0,
        message=(
            f"per-device static high-water {high_water / GiB:.2f} GiB exceeds the "
            f"{float(hbm_gb):g} GiB budget (params {params_dev / GiB:.2f} + pool "
            f"{pool_dev / GiB:.2f}"
            + (f" - host tier {host_credit / GiB:.2f}" if host_credit else "")
            + f" + {worst_rest / GiB:.2f} live at {worst.name if worst else '?'}): shrink "
            "the pool (max_blocks / kv_dtype=int8), the batch or the window, offload "
            "with --host-pool-mib — or raise --hbm-gb if the budget was wrong"
        ),
        line_text="hbm-over-budget",
    )]


def flow_preflight(
    engine,
    origin: Optional[str] = None,
    min_bytes: int = DEFAULT_MIN_BYTES,
    hbm_gb: Optional[float] = None,
    goldens: Optional[Dict[str, Any]] = None,
    golden_tolerance: Optional[float] = None,
    traces: Optional[List[Traced]] = None,
) -> FlowReport:
    """Run the liveness pass over one serving engine, abstract
    (`trace_serving`) or live (its meta twin: nothing runs on the card).
    `traces` reuses an `ir.trace_engine` result."""
    origin = origin or type(engine).__name__
    traces = trace_engine(engine) if traces is None else traces
    findings, profiles = analyze_flow(traces, origin=origin, min_bytes=min_bytes)
    breakdown: Dict[str, Any] = {}
    if hbm_gb is not None:
        findings += _check_hbm_budget(engine, profiles, origin, hbm_gb, breakdown)
    if goldens is not None:
        findings += _check_goldens(profiles, goldens, origin, golden_tolerance)
    return FlowReport(origin=origin, findings=findings, profiles=profiles, breakdown=breakdown)


def flow_refusal_text(tool: str) -> str:
    return (f"{tool}: flow preflight refused the launch "
            "(re-run with --no-preflight to launch anyway)")


def enforce_flow_preflight(report: FlowReport, tool: str, allow: bool = False,
                           emit=None) -> bool:
    """Emit every finding; refuse (SystemExit) on errors unless `allow`
    (--no-preflight)."""
    if emit is None:
        def emit(line):
            print(line, file=sys.stderr)
    for line in report.render_findings():
        emit(f"{tool}: flow-preflight: {line}")
    if not report.errors or allow:
        return True
    raise SystemExit(flow_refusal_text(tool))


def flow_detail(report: FlowReport) -> Dict[str, Any]:
    """The compact record a stats line carries."""
    return {
        "findings": len(report.errors),
        "warnings": len(report.warnings),
        "peak_bytes": {p.name: p.peak_bytes for p in report.profiles},
        "device_peak_bytes": {p.name: p.device_peak_bytes for p in report.profiles},
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mdi_llm_tpu_torch.analysis flow",
        description="Buffer liveness over the serving steps traced on the meta "
        "device: per-storage live ranges, in-place pool updates and a static "
        "peak of device memory per step — no checkpoint, no card",
    )
    add_plan_args(ap, top_k=False)
    seq = ap.add_argument_group("sequential generate() path")
    seq.add_argument("--sequential", action="store_true",
                     help="also profile the generate() steps of the workload below")
    seq.add_argument("--batch", type=int, default=1)
    seq.add_argument("--prompt-len", type=int, default=32)
    seq.add_argument("--new-tokens", type=int, default=32)
    seq.add_argument("--chunk-size", type=int, default=16)
    bud = ap.add_argument_group("budgets")
    bud.add_argument("--hbm-gb", type=float, default=None,
                     help="per-device memory budget: the static high-water must fit "
                     "(hbm-over-budget)")
    bud.add_argument("--min-bytes", type=int, default=DEFAULT_MIN_BYTES,
                     help="missed-donation / live-range-bloat floor (bytes)")
    bud.add_argument("--goldens", default=None, metavar="FILE",
                     help="golden budgets+digests to pin against "
                     "(peak-memory-regression / graph-drift)")
    bud.add_argument("--update-goldens", action="store_true",
                     help="write this run's budgets/digests into --goldens (default: "
                     "the port's flow-goldens.json; other origins are kept) and exit 0")
    bud.add_argument("--golden-tolerance", type=float, default=None,
                     help="peak growth fraction that trips the regression rule "
                     f"(default: the goldens file's, else {DEFAULT_GOLDEN_TOLERANCE})")
    ap.add_argument("--suppress", action="append", default=[], metavar="RULE=WHY",
                    help="suppress a rule WITH a justification (mandatory); repeatable")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="grandfather findings via a lint-style baseline")
    ap.add_argument("--update-baseline", default=None, metavar="FILE",
                    help="write the current findings as the baseline and exit 0")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-checks", action="store_true",
                    help="print the flow rule registry and exit")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_checks:
        list_checks(FLOW_RULES)
        return 0
    try:
        reasons = parse_suppressions(args.suppress, FLOW_RULES)
        goldens = None
        if args.goldens and not args.update_goldens:
            goldens = load_goldens(Path(args.goldens))
        engine = engine_from_args(args)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"flow: {e}", file=sys.stderr)
        return 2
    origin = (args.model or Path(args.config).stem) + "".join(t for t in (
        f"@tp{args.tp}" if args.tp > 1 else "", f"@pp{args.pp}" if args.pp > 1 else "",
        f"@spec{args.spec_k}" if args.spec_k else "", "@draft" if args.draft_model else ""))
    report = flow_preflight(engine, origin=origin, min_bytes=args.min_bytes,
                            hbm_gb=args.hbm_gb, goldens=goldens,
                            golden_tolerance=args.golden_tolerance)
    seq_profiles: List[ExecProfile] = []
    if args.sequential:
        try:
            seq_specs = engine.gen.enumerate_executables(
                batch_size=args.batch, prompt_len=args.prompt_len,
                max_new_tokens=args.new_tokens, chunk_size=args.chunk_size)
        except ValueError as e:
            print(f"flow: {e}", file=sys.stderr)
            return 2
        f2, seq_profiles = analyze_flow(seq_specs, origin=f"{origin}:generate",
                                        min_bytes=args.min_bytes)
        if goldens is not None:
            f2 += _check_goldens(seq_profiles, goldens, f"{origin}:generate",
                                 args.golden_tolerance)
        report.findings += f2
    if args.update_goldens:
        gpath = Path(args.goldens) if args.goldens else DEFAULT_GOLDENS
        write_goldens(gpath, origin, report.profiles)
        if seq_profiles:
            write_goldens(gpath, f"{origin}:generate", seq_profiles)
        n = len(report.profiles) + len(seq_profiles)
        print(f"flow: wrote {n} budget(s) for {origin} to {gpath}")
        return 0
    report.profiles += seq_profiles
    report.suppress(reasons)
    if args.update_baseline:
        Baseline.from_findings(report.findings).save(Path(args.update_baseline))
        print(f"flow: wrote {len(report.findings)} finding(s) to {args.update_baseline}")
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
