"""Tracing a step on the meta device, and the storage model of its graph.

The JAX tools trace jaxprs over `ShapeDtypeStruct`s.  The port's steps
are bodies (`utils/step_graph.py`) that the card captures as CUDA graphs;
their counterpart of a jaxpr is a graph of the body's operators traced on
the meta device, in `torch.fx`'s node shape:

- `trace_step(spec)` traces one `obs.device.StepSpec`: the body runs on
  meta tensors under a dispatch mode (`_Recorder`) that records each
  operator it dispatches as one node, at the level `make_fx` records
  (after autograd and the composite decompositions), into a `Graph` of
  nodes in `torch.fx.Node`'s shape (`Graph.fx()` gives the
  `torch.fx.Graph`).
  The body reads its weights and its pool from its owner (a meta twin,
  `obs.device.abstractify`), not from its arguments; a tracer that knows
  only its arguments (`make_fx`) would bake those as constants and lose
  the pool's in-place writes.  The recorder knows tensors by object: the
  spec's args (the owner's own tensor objects among them) are the
  placeholders, so every read of a weight is a read of a placeholder and
  every paged write an in-place write to one.  (`make_fx` over the same
  objects gives the same graph, twenty times slower: it snapshots every
  value as a fake tensor made in a fresh mode; the recorder also skips
  the meta kernel of a call it has seen at the same argument metadata,
  `_run_meta`.)  Kernels K1 and K2 are
  operators with a meta implementation (`kernels.define_op`): one node
  per launch, where the card launches it.
- A host round trip inside the body (`.item()`, a branch on a tensor, a
  data-dependent `nonzero`, a copy to the CPU) cannot be traced on meta
  tensors: `_HostSyncGuard` stops the trace there and `HostRoundTrip`
  names the operation and the body's source line.
- `storage_model(traced)` walks the graph once: which storage each node's
  outputs live in (a view or an in-place op returns its argument's, read
  off the operator's schema; `_unsafe_view` is a view too; `getitem`
  picks one output of a node that returns several), where each storage
  is defined and last read, and which storages each node writes.

Nothing here touches a device: meta tensors have shapes, strides and
dtypes, no data.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import operator
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "HostRoundTrip",
    "StorageModel",
    "Traced",
    "digest",
    "kernel_nodes",
    "leaves_of",
    "storage_model",
    "trace_step",
    "trace_all",
]

aten = torch.ops.aten
_PKG = Path(__file__).resolve().parents[1]
_HERE = Path(__file__).resolve().parent
# views the schema does not mark as such
_UNMARKED_VIEWS = {aten._unsafe_view.default}


class HostRoundTrip(RuntimeError):
    """A step body made a host round trip: `op` names it, `where` is the
    body's source line (path:line inside the package)."""

    def __init__(self, op: str, where: str):
        super().__init__(f"host round trip `{op}` at {where}")
        self.op, self.where = op, where


def _source_line() -> str:
    """The innermost frame outside torch, the standard library and this
    analysis package: the body's line (path relative to the repository
    root when it lies inside)."""
    skip = (Path(torch.__file__).resolve().parent, Path(contextlib.__file__).resolve().parent, _HERE)
    for frame in reversed(traceback.extract_stack()):
        path = Path(frame.filename).resolve()
        if any(d == path.parent or d in path.parents for d in skip):
            continue
        try:
            return f"{path.relative_to(_PKG.parent)}:{frame.lineno}"
        except ValueError:
            return f"{path}:{frame.lineno}"
    return "?"


# operators that may be a host round trip (the others skip `_host_op`)
_HOST_SUSPECTS = {aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten.unique_dim,
                  aten._unique2, aten._to_copy, aten.copy_}


# id(operator) -> whether it is one of `_HOST_SUSPECTS`: an operator's own
# hash is Python code, its id is not
_SUSPECT: Dict[int, bool] = {}


def _host_op(func, args, kwargs) -> Optional[str]:
    suspect = _SUSPECT.get(id(func))
    if suspect is None:
        suspect = _SUSPECT[id(func)] = (getattr(func, "overloadpacket", None)
                                        in _HOST_SUSPECTS)
    if not suspect:
        return None
    packet = func.overloadpacket
    if packet is aten._local_scalar_dense:
        return "item"  # .item(), int()/bool() of a tensor, a Python branch on one
    if packet in (aten.nonzero, aten.masked_select, aten.unique_dim, aten._unique2):
        return str(packet.__name__)  # an output shape that depends on the data
    if packet is aten._to_copy and torch.device(kwargs.get("device") or "meta").type == "cpu":
        return "copy to the CPU"
    if packet is aten.copy_ and args[0].device.type == "cpu" and args[1].device.type != "cpu":
        return "copy to the CPU"
    return None


class _HostSyncGuard(TorchDispatchMode):
    """Stops a trace at a host round trip (`HostRoundTrip`)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        what = _host_op(func, args, kwargs)
        if what is not None:
            raise HostRoundTrip(what, _source_line())
        return func(*args, **kwargs)


def leaves_of(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves_of(v)]
    return []


class Node:
    """One node of a traced step, in `torch.fx.Node`'s shape: `op`
    ("placeholder", "get_attr", "call_function", "output"), `target` (the
    operator, `operator.getitem`, or a name), `args` and `kwargs` (other
    nodes in place of tensors) and `meta["val"]` (the meta tensor(s) it
    produced)."""

    __slots__ = ("op", "target", "args", "kwargs", "meta", "index", "_name")

    def __init__(self, op: str, target, args, kwargs, index: int, name: str = ""):
        self.op, self.target, self.args, self.kwargs = op, target, args, kwargs
        self.meta: Dict[str, Any] = {}
        self.index, self._name = index, name

    @property
    def name(self) -> str:
        return self._name or f"n{self.index}"

    def __repr__(self) -> str:
        return f"%{self.name}"


class Graph:
    """A traced step's nodes in program order.  The recorder appends to a
    list: a `torch.fx.Graph` built node by node is four times slower to
    record (its names and argument maps), and the chip's serve preflights
    pay that per engine; `fx()` builds the same graph as a
    `torch.fx.Graph` on demand."""

    def __init__(self):
        self.nodes: List[Node] = []

    def add(self, op: str, target, args=(), kwargs=None, name: str = "") -> Node:
        node = Node(op, target, args, {} if kwargs is None else kwargs, len(self.nodes), name)
        self.nodes.append(node)
        return node

    def fx(self) -> torch.fx.Graph:
        """This graph as a `torch.fx.Graph` (same nodes, order, targets and
        values)."""
        g = torch.fx.Graph()
        env: Dict[int, Any] = {}

        def arg(a):
            if isinstance(a, Node):
                return env[id(a)]
            if isinstance(a, (list, tuple)):
                return type(a)(arg(x) for x in a)
            if isinstance(a, dict):
                return {k: arg(v) for k, v in a.items()}
            return a

        for node in self.nodes:
            if node.op == "placeholder":
                new = g.placeholder(node.name)
            elif node.op == "get_attr":
                new = g.get_attr(node.target)
            elif node.op == "output":
                new = g.output(arg(node.args[0]))
            else:
                new = g.call_function(node.target, arg(node.args), arg(node.kwargs))
            new.meta.update(node.meta)
            env[id(node)] = new
        return g


@dataclasses.dataclass
class Traced:
    """One traced step: `graph` its nodes (None when the trace failed, then
    `error` holds the exception), `inputs` per placeholder (arg name,
    tensor) in order, `constants` the tensors a `get_attr` node names (what
    the body read that is neither an arg nor computed: a baked constant).
    `model` caches the graph's `storage_model`."""

    spec: Any
    graph: Optional[Graph]
    inputs: List[Tuple[str, torch.Tensor]]
    constants: Dict[str, Any] = dataclasses.field(default_factory=dict)
    error: Optional[BaseException] = None
    seconds: float = 0.0
    _model: Any = None

    @property
    def model(self) -> "StorageModel":
        if self._model is None:
            self._model = storage_model(self)
        return self._model


# (operator, argument metadata) -> how to make its outputs: most of a
# trace's time is torch's Python meta kernels, and an unrolled step runs
# the same operator on the same shapes once per layer and decode step
_META_MEMO: Dict[Any, Any] = {}


def _run_meta(func, args, kwargs, key, ins: List[torch.Tensor], all_meta: bool = True):
    """`func(*args, **kwargs)` on meta tensors (`ins` the tensors among the
    arguments, `key` the operator with the arguments' metadata, `all_meta`
    whether every one of `ins` is a meta tensor); a call whose key was seen
    before makes its outputs from the first call's (the same argument
    object for an in-place result, the same view of the same argument, or a
    fresh meta tensor of the recorded shape, strides and dtype) without
    running the meta kernel again."""
    if not all_meta:
        return func(*args, **kwargs)
    try:
        recipe = _META_MEMO.get(key)
    except TypeError:  # an unhashable argument: no memo
        return func(*args, **kwargs)
    if recipe is None:
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        items = []
        for o in outs:
            if not isinstance(o, torch.Tensor) or not o.is_meta:
                return out  # not a meta tensor result: never memoised
            same = [i for i, t in enumerate(ins) if t is o]
            if same:
                items.append(("arg", same[0]))
                continue
            root = o._base if o._base is not None else o
            src = [i for i, t in enumerate(ins) if (t._base if t._base is not None else t) is root]
            if src:  # a view: its offset from its argument's (the key holds no offset)
                items.append(("view", src[0], (tuple(o.shape), o.stride(),
                                               o.storage_offset() - ins[src[0]].storage_offset())))
            else:
                items.append(("new", (tuple(o.shape), o.stride(), o.dtype)))
        _META_MEMO[key] = (type(out) if isinstance(out, (list, tuple)) else None, items)
        return out
    kind, items = recipe
    made = []
    for item in items:
        if item[0] == "arg":
            made.append(ins[item[1]])
        elif item[0] == "view":
            shape, stride, delta = item[2]
            src = ins[item[1]]
            made.append(src.as_strided(shape, stride, src.storage_offset() + delta))
        else:
            shape, stride, dtype = item[1]
            made.append(torch.empty_strided(shape, stride, dtype=dtype, device="meta"))
    return made[0] if kind is None else kind(made)


# argument types that hold no tensor: a list or tuple of them is kept whole
_PLAIN = frozenset({int, float, bool, type(None), str, torch.dtype, torch.device,
                    torch.layout, torch.memory_format})


class _Recorder(TorchDispatchMode):
    """Records every operator a body dispatches as one node (the level
    `make_fx` records at: after autograd and the composite decompositions),
    running it on the meta tensors to learn its outputs.  Tensors are known
    by object: a placeholder's, or a node's output (an in-place operator
    returns its argument, now the node's); any other tensor an operator
    reads becomes a constant.  Stops at a host round trip.  Every
    operator of a step passes through `__torch_dispatch__`, so it keeps to
    the few Python calls a node needs: the mode is not wrapped to keep
    dynamo out (nothing here is compiled), a list of plain values (a
    shape, dims) is one piece of the memo key, and operators are known by
    id."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False

    def __init__(self, graph: Graph, env: Dict[int, Any], constants: Dict[str, Any]):
        super().__init__()
        self.graph, self.env, self.constants = graph, env, constants
        self.alive: List[Any] = []  # every tensor seen: no id is reused

    def _arg(self, a, parts=None, ins=None):
        """`a` with every tensor replaced by its node (a constant's, made
        here, for a tensor no node produced); with `parts`/`ins`, also
        appends the arguments' metadata (the memo key) and their tensors."""
        t = type(a)
        if t in _PLAIN:
            if parts is not None:
                parts.append(a)
            return a
        if (t is tuple or t is list) and _PLAIN.issuperset(map(type, a)):
            if parts is not None:
                parts.append((t, tuple(a)))
            return a
        if isinstance(a, torch.Tensor):
            if parts is not None:
                # no storage offset: an operator's shapes do not depend on
                # it (a view's offset is kept relative to its argument's)
                meta = a.is_meta
                self.all_meta = self.all_meta and meta
                parts.append((a.shape, a.stride(), a.dtype, meta))
                ins.append(a)
            node = self.env.get(id(a))
            if node is None:
                name = f"_tensor_constant{len(self.constants)}"
                self.constants[name] = a
                node = self.graph.add("get_attr", name, name=name)
                node.meta["val"] = a
                self.env[id(a)] = node
                self.alive.append(a)
            return node
        if t is tuple or t is list:
            if parts is not None:
                parts.append(len(a))
            return t([self._arg(x, parts, ins) for x in a])
        if t is dict:
            return {k: self._arg(v, parts, ins) for k, v in a.items()}
        if parts is not None:
            parts.append("generator" if t is torch.Generator else a)
        return a

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        what = _host_op(func, args, kwargs)
        if what is not None:
            raise HostRoundTrip(what, _source_line())
        parts: List[Any] = [id(func)]
        ins: List[torch.Tensor] = []
        self.all_meta = True
        node_args = self._arg(tuple(args), parts, ins)
        node_kwargs = {}
        for k in sorted(kwargs):
            parts.append(k)
            node_kwargs[k] = self._arg(kwargs[k], parts, ins)
        out = _run_meta(func, args, kwargs, tuple(parts), ins, self.all_meta)
        node = self.graph.add("call_function", func, node_args, node_kwargs)
        node.meta["val"] = out
        if isinstance(out, torch.Tensor):
            self.env[id(out)] = node
            self.alive.append(out)
        elif isinstance(out, (list, tuple)):
            for i, o in enumerate(out):
                if isinstance(o, torch.Tensor):
                    g = self.graph.add("call_function", operator.getitem, (node, i))
                    g.meta["val"] = o
                    self.env[id(o)] = g
                    self.alive.append(o)
        return out


def trace_step(spec) -> Traced:
    """Trace `spec` (an `obs.device.StepSpec`) on the meta device.  Never
    raises: a failure is a `Traced` with `error` set."""
    t0 = time.perf_counter()
    inputs: List[Tuple[str, torch.Tensor]] = []
    seen = set()
    for name, tree in spec.args.items():
        for t in leaves_of(tree):
            if id(t) not in seen:  # one placeholder per tensor object
                seen.add(id(t))
                inputs.append((name, t))
    passed = {n: v for n, v in spec.args.items() if n not in spec.owned}
    graph = Graph()
    env: Dict[int, Any] = {}
    for i, (name, t) in enumerate(inputs):
        node = graph.add("placeholder", f"{name}_{i}", name=f"{name}_{i}")
        node.meta["val"] = t
        env[id(t)] = node
    constants: Dict[str, Any] = {}
    rec = _Recorder(graph, env, constants)
    try:
        # the body reads the owner's tensors and is passed `passed`: the
        # very objects of `inputs`, each a placeholder
        with torch.no_grad(), rec:
            out = spec.body(spec.owner, **(spec.static or {}), **passed)
        graph.add("output", "output", (rec._arg(out),))
    except Exception as e:  # a failed trace is the caller's finding, not a crash
        return Traced(spec, None, inputs, constants, e, time.perf_counter() - t0)
    return Traced(spec, graph, inputs, constants, None, time.perf_counter() - t0)


def trace_all(specs) -> List[Traced]:
    """`trace_step` of every spec (a `Traced` is passed through)."""
    return [s if isinstance(s, Traced) else trace_step(s) for s in specs]


# ---------------------------------------------------------------------------
# the storage model
# ---------------------------------------------------------------------------


def _nbytes(val) -> int:
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    return 0


def _node_args(node) -> List[Any]:
    """The nodes among a node's arguments (lists and dicts searched)."""
    out: List[Any] = []

    def walk(a):
        t = type(a)
        if t is Node:
            out.append(a)
        elif t is tuple or t is list:
            for x in a:
                walk(x)
        elif t is dict:
            for x in a.values():
                walk(x)

    walk(node.args)
    if node.kwargs:
        walk(node.kwargs)
    return out


def _arg_at(node, pos: int, name: str):
    return node.args[pos] if pos < len(node.args) else node.kwargs.get(name)


# operator -> (written argument (pos, name)s, per return: the aliased
# argument's (pos, name) or None), read once from the schema
_PLANS: Dict[Any, Any] = {}


def _plan(target):
    plan = _PLANS.get(target)
    if plan is not None:
        return plan
    schema = getattr(target, "_schema", None)
    if target in _UNMARKED_VIEWS:
        plan = ((), [(0, "self")])
    elif schema is None:
        plan = ((), None)
    else:
        writes = tuple((i, a.name) for i, a in enumerate(schema.arguments)
                       if a.alias_info is not None and a.alias_info.is_write)
        rets = []
        for r in schema.returns:
            ai = r.alias_info
            src = None
            if ai is not None:
                sets = set(ai.before_set)
                for i, a in enumerate(schema.arguments):
                    if a.alias_info is not None and (not sets or sets & set(a.alias_info.before_set)):
                        src = (i, a.name)
                        break
            rets.append(src)
        plan = (writes, rets)
    _PLANS[target] = plan
    return plan


def view_source(node) -> Optional[Any]:
    """The argument node a view node aliases (None for any other node)."""
    if node.op != "call_function" or node.target is operator.getitem:
        return None
    writes, rets = _plan(node.target)
    if writes or not rets or len(rets) != 1 or rets[0] is None:
        return None
    src = _arg_at(node, *rets[0])
    return src if isinstance(src, Node) else None


@dataclasses.dataclass
class StorageModel:
    """Storages of one graph.  Storage ids index `nbytes`, `defined`
    (node index), `last_use` (node index), `uses` (node indices reading
    it) and `kind` ("input" for a placeholder's, "const" for a baked
    constant's, "temp" otherwise); `of[node]` lists the storages of each
    of a node's outputs; `writes` maps a node to the storages it updates
    in place; `outputs` holds the storages the graph returns; `input_of`
    maps a placeholder's storage to its index in `Traced.inputs`."""

    nbytes: List[int]
    defined: List[int]
    last_use: List[int]
    kind: List[str]
    uses: List[List[int]]
    of: Dict[Any, List[int]]
    writes: Dict[Any, List[int]]
    outputs: List[int]
    input_of: Dict[int, int]
    nodes: List[Any]

    def root(self, node, i: int = 0) -> Optional[int]:
        got = self.of.get(node)
        return got[i] if got and i < len(got) else None


def storage_model(traced: Traced) -> StorageModel:
    """Walk `traced.graph` once (see the module docstring)."""
    nodes = list(traced.graph.nodes)
    m = StorageModel([], [], [], [], [], {}, {}, [], {}, nodes)
    nbytes, defined, last_use, kind, uses, of = (m.nbytes, m.defined, m.last_use, m.kind,
                                                 m.uses, m.of)

    def new(i, n, k):
        nbytes.append(int(n))
        defined.append(i)
        last_use.append(i)
        kind.append(k)
        uses.append([])
        return len(nbytes) - 1

    def use(sid, i):
        last_use[sid] = i
        u = uses[sid]
        if not u or u[-1] != i:
            u.append(i)

    n_ph = 0
    for i, node in enumerate(nodes):
        op = node.op
        if op == "placeholder":
            sid = new(i, _nbytes(node.meta.get("val")), "input")
            m.input_of[sid] = n_ph
            n_ph += 1
            of[node] = [sid]
            continue
        if op == "get_attr":
            of[node] = [new(i, _nbytes(traced.constants.get(node.target)), "const")]
            continue
        target = node.target
        if op == "call_function" and target is operator.getitem:
            sid = m.root(node.args[0], node.args[1])
            if sid is not None:
                use(sid, i)
            of[node] = [] if sid is None else [sid]
            continue
        for a in _node_args(node):
            for sid in of.get(a, ()):
                use(sid, i)
        if op == "output":
            for a in _node_args(node):
                m.outputs.extend(of.get(a, ()))
            continue
        if op != "call_function":
            continue
        writes, rets = _plan(target)
        for pos, name in writes:
            a = _arg_at(node, pos, name)
            if type(a) is Node and of.get(a):
                m.writes.setdefault(node, []).append(of[a][0])
        val = node.meta.get("val")
        vals = list(val) if isinstance(val, (list, tuple)) else [val]
        if rets is None:  # an operator without a schema (no alias): fresh outputs
            of[node] = [new(i, _nbytes(v), "temp") for v in vals]
            continue
        if len(rets) == 1 and len(vals) > 1:  # a list of views (split, unbind)
            rets = rets * len(vals)
        out: List[int] = []
        for r, v in zip(rets, vals):
            src = None if r is None else _arg_at(node, *r)
            if type(src) is Node and of.get(src):
                out.append(of[src][0])
            else:
                out.append(new(i, _nbytes(v), "temp"))
        of[node] = out
    return m


# ---------------------------------------------------------------------------
# graph facts
# ---------------------------------------------------------------------------


def op_name(node) -> str:
    if node.target is operator.getitem:
        return "getitem"
    return str(node.target)


def digest(graph) -> Tuple[str, Dict[str, int]]:
    """(canonical digest, operator counts) of a graph: each node's kind,
    operator, arguments (nodes by position) and output dtype and shape,
    hashed; the counts feed the op-level diff of `graph-drift`."""
    index: Dict[Any, int] = {}
    lines: List[str] = []
    ops: Dict[str, int] = {}

    def arg(a):
        if isinstance(a, Node):
            return f"%{index[a]}"
        if isinstance(a, (list, tuple)):
            return "[" + ",".join(arg(x) for x in a) + "]"
        if isinstance(a, torch.Generator):
            return "<generator>"
        return repr(a)

    for i, node in enumerate(graph.nodes):
        index[node] = i
        val = node.meta.get("val")
        sig = (f"{str(val.dtype).replace('torch.', '')}{tuple(val.shape)}"
               if isinstance(val, torch.Tensor) else type(val).__name__)
        if node.op == "call_function":
            name = op_name(node)
            ops[name] = ops.get(name, 0) + 1
        else:
            name = node.op if node.op != "get_attr" else f"get_attr:{sig}"
        kw = ",".join(f"{k}={arg(v)}" for k, v in sorted(node.kwargs.items()))
        lines.append(f"{name}({arg(node.args)};{kw})->{sig}")
    text = "\n".join(lines)
    return hashlib.sha256(text.encode()).hexdigest()[:16], ops


K1_OP = "mdi_torch.ragged_paged_attention.default"
K2_OP = "mdi_torch.flash_attention.default"


def kernel_nodes(graph) -> Dict[str, int]:
    """The kernel launches a graph holds: K1 nodes, the K1 nodes whose
    split runs the merge kernel (a non-empty workspace) and K2 nodes."""
    out = {"ragged_paged_attention": 0, "merge": 0, "flash_attention": 0}
    for node in graph.nodes:
        name = op_name(node) if node.op == "call_function" else ""
        if name == K1_OP:
            out["ragged_paged_attention"] += 1
            ws = node.meta.get("val")[1]
            out["merge"] += int(ws.numel() > 0)
        elif name == K2_OP:
            out["flash_attention"] += 1
    return out
