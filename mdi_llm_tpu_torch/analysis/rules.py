"""mdi-lint rule implementations of the port.

Every rule encodes one way a CUDA-graph hot path silently degrades: a
host read inside a captured body, a Python branch on a tensor frozen at
capture, a capture repeated in a loop.  `tests/test_torch_lint.py` pins
every rule with a triggering and a passing fixture.

The JAX lint's hot-path rules (`mdi_llm_tpu/analysis/rules.py`) and their
counterparts here, on the "captured" notion of `core.py`:

- ``host-sync-in-jit`` -> ``host-sync-in-capture``: `.item()`,
  `.tolist()`, `.cpu()`, `.numpy()`, `torch.cuda.synchronize()` (and
  `np.asarray` of a value) inside a captured body.  A device-to-host read
  is illegal while a graph captures, and what it would read is the
  capture's value, never a replay's.
- ``host-sync`` keeps its name: `.item()` and `torch.cuda.synchronize()`
  on the host path, and the fetch idioms `.tolist()`/`.cpu()`/`.numpy()`
  inside a per-step loop.
- ``tracer-branch`` -> ``tensor-branch``: a Python `if`/`while` on a
  tensor parameter of a captured body.  The branch is taken once, at
  capture, and every replay follows it whatever the tensor then holds.
- ``static-float-arg`` -> ``captured-scalar-arg``: a float parameter of a
  captured body (annotated `float`, a float default, or a float knob's
  name).  Its value at capture is baked into the graph; the steps pass
  such values as device operands (`sampling_operands`' `t_op`/`p_op`).
- ``jit-in-loop`` -> ``capture-in-loop``: a graph made or captured inside
  a loop (`StepGraph(...)`, `CudaGraph(...)`, `torch.cuda.CUDAGraph()`,
  `.capture(...)`, `with torch.cuda.graph(...)`): every iteration pays a
  capture (seconds at full width) where the steps cache one per key.
- ``mutable-global-in-jit`` -> ``mutable-global-in-capture`` and
  ``timing-in-jit`` -> ``timing-in-capture``: the same checks on captured
  bodies (a module-level container read at capture; a clock read once, at
  capture, and never by a replay).
- ``lax-scalar-operand`` -> ``scalar-tensor-in-capture``: torch promotes a
  Python scalar operand as a weak type (a bfloat16 tensor times 0.5 stays
  bfloat16), so the JAX trap has no counterpart; the port's hazard with a
  scalar is `torch.tensor(x)`/`torch.as_tensor(x)`/`torch.full(...)` from
  a host value inside a captured body: a host-to-device copy during
  capture, whose value is frozen (the repair PR 8 made: `torch.where`
  takes the scalar).
- ``donation-after-use``: no counterpart.  The port donates no buffer: a
  step's static inputs and the model state persist across replays, and a
  replay overwrites its outputs in place, a contract `StepGraph` documents
  and its callers keep by reading the outputs (on the same stream) before
  the next `run`.
- ``missing-named-scope``: no counterpart.  A `torch.profiler` trace names
  every aten op and every hand-written kernel by its CUDA symbol
  (`ragged_paged_attention_kernel`, ...), and the port's profilers
  (`cli/profile_*.py`) attribute device time by those names; the port
  opens no `record_function` range and needs none for attribution.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from mdi_llm_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    _dotted,
    capture_targets,
    is_graph_block,
    is_graph_ctor,
    is_step_graph_call,
    rule,
)

_NP_NAMES = {"np", "numpy"}
# methods whose invocation always waits for the device
_SYNC_METHODS = {"item"}
_SYNC_FUNCS = {"torch.cuda.synchronize", "cuda.synchronize"}
# methods that copy a device tensor to the host (a wait on the device)
_FETCH_METHODS = {"tolist", "cpu", "numpy"}


def _is_host_sync_call(call: ast.Call) -> Optional[str]:
    """Describe the unconditional host sync a Call performs, or None."""
    d = _dotted(call.func)
    if d in _SYNC_FUNCS:
        return f"`{d}()` waits for the whole device"
    if (isinstance(call.func, ast.Attribute) and call.func.attr in _SYNC_METHODS
            and not call.args):
        return f"`.{call.func.attr}()` waits for the device"
    return None


def _is_fetch(call: ast.Call) -> Optional[str]:
    """A device-to-host copy: `x.tolist()`, `x.cpu()`, `x.numpy()`."""
    if (isinstance(call.func, ast.Attribute) and call.func.attr in _FETCH_METHODS
            and not call.args and not call.keywords):
        return f"`.{call.func.attr}()` copies the tensor to the host"
    return None


def _is_np_materialize(call: ast.Call) -> Optional[str]:
    d = _dotted(call.func)
    if "." in d:
        root, attr = d.split(".", 1)
        if root in _NP_NAMES and attr in ("asarray", "array"):
            return f"`{d}` materializes the operand on the host"
    return None


# ---------------------------------------------------------------------------
# host syncs
# ---------------------------------------------------------------------------


@rule(
    "host-sync-in-capture",
    "host read (.item, .tolist, .cpu, .numpy, synchronize, np.asarray) inside "
    "a captured function (illegal during capture; frozen at its value)",
)
def host_sync_in_capture(mod: ModuleInfo) -> Iterator[Finding]:
    for label, tops in mod.captured_regions():
        for top in tops:
            for node in ast.walk(top):
                if not isinstance(node, ast.Call):
                    continue
                why = (_is_host_sync_call(node) or _is_fetch(node)
                       or _is_np_materialize(node))
                if why:
                    yield mod.finding(
                        "host-sync-in-capture",
                        node,
                        f"{why} inside {label}: a host read is illegal while "
                        "a CUDA graph captures, and a replay never repeats "
                        "it — keep the body device-only and read the step's "
                        "outputs after `run`",
                    )


@rule(
    "host-sync",
    ".item()/synchronize() on the host path, .tolist()/.cpu()/.numpy() inside "
    "a per-step loop",
)
def host_sync(mod: ModuleInfo) -> Iterator[Finding]:
    captured = mod.captured_nodes()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or node in captured:
            continue
        loop = mod.enclosing_loop(node)
        why = _is_host_sync_call(node)
        if not why and loop is not None:
            # a fetch is a hot-path hazard when it repeats per iteration
            # (serving/decode loops); one fetch after a loop is the
            # recommended batched shape
            why = _is_fetch(node)
        if not why:
            continue
        where = (
            "inside a per-step loop — each iteration stalls the device "
            "queue for a full host round-trip"
            if loop is not None
            else "on the host path"
        )
        yield mod.finding(
            "host-sync",
            node,
            f"{why} {where}; hoist/batch it (one read per chunk, not per "
            "token), or suppress with a justification if the sync is the "
            "point",
        )


# ---------------------------------------------------------------------------
# tensor-branch
# ---------------------------------------------------------------------------


def _safe_name_use(mod: ModuleInfo, name_node: ast.Name) -> bool:
    """A use of a tensor param inside a branch test that is NOT a value
    branch: attribute access (x.shape, x.dtype, x.device are static),
    `x is [not] None`, and isinstance/len/type of it."""
    parent = mod.parents.get(name_node)
    if isinstance(parent, ast.Attribute):
        return True
    if isinstance(parent, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in parent.ops):
            return True
    if isinstance(parent, ast.Call):
        d = _dotted(parent.func)
        if d in ("isinstance", "len", "type", "hasattr", "getattr"):
            return True
    return False


@rule(
    "tensor-branch",
    "Python if/while on a tensor argument of a captured function (taken once, "
    "at capture)",
)
def tensor_branch(mod: ModuleInfo) -> Iterator[Finding]:
    for c in mod.captured:
        tensors = c.tensor_params()
        if not tensors:
            continue
        for node in ast.walk(c.node):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            for sub in ast.walk(node.test):
                if (
                    isinstance(sub, ast.Name)
                    and isinstance(sub.ctx, ast.Load)
                    and sub.id in tensors
                    and not _safe_name_use(mod, sub)
                ):
                    kind = "if" if isinstance(node, ast.If) else "while"
                    yield mod.finding(
                        "tensor-branch",
                        node,
                        f"Python `{kind}` on tensor argument `{sub.id}` of "
                        f"captured `{c.name}`: the branch reads the tensor "
                        "once, at capture (a host sync the capture refuses), "
                        "and every replay follows that branch — use "
                        "torch.where, or make it a static of the step's key",
                    )
                    break  # one finding per branch statement


# ---------------------------------------------------------------------------
# capture hazards
# ---------------------------------------------------------------------------

# names that in this codebase always carry float sampling/scaling knobs
_FLOATY_NAMES = {
    "temperature", "top_p", "scale", "eps", "rate", "ratio",
    "threshold", "prob", "penalty", "alpha", "dropout",
}


def _param_is_floaty(fn: ast.AST, name: str) -> Optional[str]:
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    defaults = list(a.defaults)
    pos = a.posonlyargs + a.args
    default_of = {}
    for p, d in zip(pos[len(pos) - len(defaults):], defaults):
        default_of[p.arg] = d
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            default_of[p.arg] = d
    for p in params:
        if p.arg != name:
            continue
        ann = getattr(p, "annotation", None)
        if ann is not None and _dotted(ann) == "float":
            return "annotated `float`"
        d = default_of.get(name)
        if isinstance(d, ast.Constant) and isinstance(d.value, float):
            return f"float default {d.value!r}"
        if name in _FLOATY_NAMES:
            return "a float-valued knob by convention"
    return None


@rule(
    "captured-scalar-arg",
    "float argument of a captured function (its value at capture is baked "
    "into the graph)",
)
def captured_scalar_arg(mod: ModuleInfo) -> Iterator[Finding]:
    for c in mod.captured:
        if isinstance(c.node, ast.Lambda):
            continue
        for name in c.param_names:
            why = _param_is_floaty(c.node, name)
            if why:
                yield mod.finding(
                    "captured-scalar-arg",
                    c.spec.site if c.spec.site is not None else c.node,
                    f"argument `{name}` of captured `{c.name}` is {why}: a "
                    "Python float is frozen into the graph at capture, so a "
                    "later value is silently ignored by every replay — pass "
                    "it as a device operand (generation.sampling_operands)",
                )


def _is_capture_site(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        return bool(is_step_graph_call(node) or is_graph_ctor(node)
                    or capture_targets(node))
    return is_graph_block(node)


@rule(
    "capture-in-loop",
    "CUDA graph made or captured inside a loop body (a capture per iteration)",
)
def capture_in_loop(mod: ModuleInfo) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not _is_capture_site(node):
            continue
        if mod.enclosing_loop(node) is not None:
            yield mod.finding(
                "capture-in-loop",
                node,
                "CUDA graph made or captured inside a loop body: every "
                "iteration pays a warm-up and a capture (seconds at full "
                "width) — build the step once per shape key and replay it "
                "(cache it on the instance like the engine's `_steps`)",
            )


_TENSOR_CTORS = {"torch.tensor", "torch.as_tensor", "torch.full", "torch.scalar_tensor"}


def _host_value(node: ast.AST) -> bool:
    """A host value: a literal, a name, a list/tuple of them, an arithmetic
    expression over them (not a call result, which may be a tensor)."""
    if isinstance(node, (ast.Constant, ast.Name)):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_host_value(e) for e in node.elts)
    if isinstance(node, (ast.BinOp, ast.UnaryOp)):
        return all(_host_value(e) for e in ast.iter_child_nodes(node)
                   if isinstance(e, ast.expr))
    return False


@rule(
    "scalar-tensor-in-capture",
    "device tensor made from a host value inside a captured function (a "
    "host-to-device copy frozen at capture)",
)
def scalar_tensor_in_capture(mod: ModuleInfo) -> Iterator[Finding]:
    for label, tops in mod.captured_regions():
        for top in tops:
            for node in ast.walk(top):
                if not isinstance(node, ast.Call):
                    continue
                d = _dotted(node.func)
                if d not in _TENSOR_CTORS or not node.args:
                    continue
                value = node.args[-1] if d == "torch.full" else node.args[0]
                if not _host_value(value):
                    continue
                yield mod.finding(
                    "scalar-tensor-in-capture",
                    node,
                    f"`{d}` of a host value inside {label}: the copy to the "
                    "device runs at capture and its value is frozen into the "
                    "graph (and a pageable copy breaks the capture) — pass "
                    "the scalar to the op (torch.where takes it) or make the "
                    "tensor once outside the step",
                )


# ---------------------------------------------------------------------------
# closures over module state
# ---------------------------------------------------------------------------

_MUTABLE_CTORS = {"list", "dict", "set", "defaultdict", "deque", "Counter", "OrderedDict"}


def _names_stored(node: ast.AST) -> Set[str]:
    return {
        n.id
        for n in ast.walk(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
    }


def _module_mutable_globals(mod: ModuleInfo) -> Set[str]:
    out: Set[str] = set()
    for stmt in mod.tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        if value is None:
            continue
        mutable = isinstance(value, (ast.List, ast.Dict, ast.Set)) or (
            isinstance(value, ast.Call)
            and _dotted(value.func).split(".")[-1] in _MUTABLE_CTORS
        )
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


@rule(
    "mutable-global-in-capture",
    "module-level mutable state read by a captured function (read once, at "
    "capture)",
)
def mutable_global_in_capture(mod: ModuleInfo) -> Iterator[Finding]:
    mutables = _module_mutable_globals(mod)
    if not mutables:
        return
    for c in mod.captured:
        locals_: Set[str] = set(c.param_names)
        for n in ast.walk(c.node):
            locals_ |= _names_stored(n)
        seen: Set[str] = set()  # one finding per (fn, global) is plenty
        for n in ast.walk(c.node):
            if (
                isinstance(n, ast.Name)
                and isinstance(n.ctx, ast.Load)
                and n.id in mutables
                and n.id not in locals_
                and n.id not in seen
            ):
                seen.add(n.id)
                yield mod.finding(
                    "mutable-global-in-capture",
                    n,
                    f"captured `{c.name}` reads module-level mutable "
                    f"`{n.id}`: its contents are read once, at capture — "
                    "later mutations are silently ignored by every replay; "
                    "pass it as a static of the step's key instead",
                )


# ---------------------------------------------------------------------------
# timing hygiene
# ---------------------------------------------------------------------------

_TIMING_FUNCS = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.perf_counter_ns", "time.monotonic_ns",
    "time.time_ns", "datetime.now", "datetime.datetime.now",
    "datetime.utcnow", "datetime.datetime.utcnow",
}


@rule(
    "timing-in-capture",
    "wall-clock call (time.perf_counter/time.time/...) inside a captured "
    "function (read once, at capture)",
)
def timing_in_capture(mod: ModuleInfo) -> Iterator[Finding]:
    for label, tops in mod.captured_regions():
        for top in tops:
            for node in ast.walk(top):
                if not isinstance(node, ast.Call):
                    continue
                d = _dotted(node.func)
                if d not in _TIMING_FUNCS:
                    continue
                yield mod.finding(
                    "timing-in-capture",
                    node,
                    f"`{d}()` inside {label} runs once, at capture, and no "
                    "replay runs it: it measures the capture, not the step "
                    "— time on the host around `run` at a sync boundary "
                    "(the obs/ observer's pattern), or with CUDA events",
                )
