"""mdi-race: thread-role static analysis for the open-system serving stack.

A copy of `mdi_llm_tpu/analysis/threads.py` for the port (which never
imports the JAX package): the same roles, rules and annotations, over the
port's `server/` and `serving/` modules.

The serving stack is genuinely concurrent — one dedicated engine
thread (`server/frontend.py`'s `_pump`), an asyncio HTTP event loop,
and `submit()`/`cancel()`/`drain()` callable from any thread, all
serialized through one `threading.Lock`.  The rules here prove that
discipline statically, the same way `rules.py` proves the CUDA-graph
discipline: every function gets a **thread role**, and cross-role state
must go through the lock.

Roles (inferred per module, seeded from the code shapes the serving
stack actually uses, overridable with a comment annotation):

- ``engine`` — runs on a spawned worker thread: `threading.Thread(
  target=f)` targets and everything they call (the `step_hook` cone).
- ``loop``   — runs on the asyncio event loop: every ``async def`` plus
  functions handed to ``loop.call_soon_threadsafe``.
- ``any``    — callable from any thread: the public methods of a class
  that spawns a thread (the `ServingFrontend` surface).

Annotation syntax — on the ``def`` line or the line above it::

    def sink(event):  # mdi-thread: engine
        ...

An annotated function's role is pinned: inference neither adds to nor
propagates into it.  Roles propagate through ``self.method()`` calls,
module-level calls, ``self.method`` callback references and property
reads, to a fixpoint.

Rules:

- ``unguarded-shared-state``   — a ``self.X`` written in one role and
  touched from another, with any cross-role access outside a
  ``with self._lock`` block (lexical with-scoping, like the host-sync
  rule).  One finding per (class, attribute), anchored at the first
  unguarded access.
- ``blocking-in-event-loop``   — ``time.sleep``, sync ``.acquire()`` /
  ``.wait()``, thread ``.join()`` or subprocess calls inside an
  ``async def`` (or a function pinned to the loop role).
- ``lock-order-inversion``     — two locks acquired in both nesting
  orders somewhere in the module (deadlock-capable).
- ``loop-call-from-wrong-thread`` — ``call_soon``/``create_task``/...
  from an engine/any role; ``call_soon_threadsafe`` is the one
  sanctioned crossing.

The runtime companion is the deterministic schedule explorer
(`server/explorer.py`): seeded adversarial interleavings against a live
CPU engine, asserting token-stream parity with the offline engine.
The JAX package's docs/analysis.md ("Concurrency analysis") describes
both.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from mdi_llm_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    _dotted,
    rule,
)

ROLE_ENGINE = "engine"
ROLE_LOOP = "loop"
ROLE_ANY = "any"
VALID_ROLES = (ROLE_ENGINE, ROLE_LOOP, ROLE_ANY)

_ANNOT_RE = re.compile(r"#\s*mdi-thread:\s*(?P<role>[a-z]+)\b")

# attribute types that ARE synchronization (holding them shared is the
# point): detected from `self.x = threading.Lock()`-style __init__ sites
_SYNC_CTORS = {
    "Lock", "RLock", "Event", "Condition", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue",
    "LifoQueue", "PriorityQueue",
}

# method calls on an attribute that mutate it in place
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "remove", "pop",
    "popleft", "clear", "update", "add", "discard", "setdefault",
    "sort", "reverse",
}

# event-loop APIs that are only legal ON the loop thread; the
# threadsafe crossing is `call_soon_threadsafe`
_LOOP_ONLY_CALLS = {"call_soon", "call_later", "call_at", "create_task",
                    "ensure_future"}

_BLOCKING_SUBPROCESS = {"run", "call", "check_call", "check_output"}


# ---------------------------------------------------------------------------
# the per-module thread model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FuncInfo:
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    name: str
    cls: Optional[ast.ClassDef]
    roles: Set[str] = dataclasses.field(default_factory=set)
    pinned: bool = False  # annotated: inference must not add roles


@dataclasses.dataclass
class ClassInfo:
    node: ast.ClassDef
    methods: Dict[str, FuncInfo]
    spawns_thread: bool = False
    sync_attrs: Set[str] = dataclasses.field(default_factory=set)
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    init_only_attrs: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class ThreadModel:
    funcs: Dict[ast.AST, FuncInfo]
    classes: Dict[ast.ClassDef, ClassInfo]
    bad_annotations: List[Tuple[ast.AST, str]]

    def roles_of(self, node: ast.AST) -> Set[str]:
        info = self.funcs.get(node)
        return info.roles if info is not None else set()


def _is_thread_ctor(call: ast.Call) -> bool:
    d = _dotted(call.func)
    return d == "Thread" or d.endswith(".Thread")


def _annotation_for(mod: ModuleInfo, node: ast.AST) -> Optional[str]:
    """The `# mdi-thread: <role>` annotation on the def line or the line
    directly above it (above the decorators is NOT searched)."""
    line = getattr(node, "lineno", 0)
    for text in (mod.line_text(line), mod.line_text(line - 1)):
        m = _ANNOT_RE.search(text)
        if m:
            return m.group("role")
    return None


def _enclosing_class(mod: ModuleInfo, node: ast.AST) -> Optional[ast.ClassDef]:
    for a in mod.ancestors(node):
        if isinstance(a, ast.ClassDef):
            return a
    return None


def _own_body_walk(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT descending into nested defs/lambdas:
    a nested function runs in its own thread context (executor callback,
    sink, ...), so its statements carry the nested function's role, not
    the enclosing one's."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _is_property(node: ast.AST) -> bool:
    for dec in getattr(node, "decorator_list", []):
        if _dotted(dec).split(".")[-1] in ("property", "cached_property"):
            return True
    return False


_CONSTRUCTION_METHODS = {"__init__", "__new__", "__del__", "__init_subclass__"}


def _is_self_attr(n: ast.AST) -> bool:
    return (
        isinstance(n, ast.Attribute)
        and isinstance(n.value, ast.Name)
        and n.value.id == "self"
    )


def _is_write(mod: ModuleInfo, n: ast.Attribute) -> bool:
    """Does this `self.X` access mutate X?  Plain/aug-assign stores and
    dels, `self.X[k] = v`, and in-place mutator calls all count."""
    if isinstance(n.ctx, (ast.Store, ast.Del)):
        return True
    parent = mod.parents.get(n)
    if isinstance(parent, ast.Attribute) and parent.attr in _MUTATORS:
        grand = mod.parents.get(parent)
        if isinstance(grand, ast.Call) and grand.func is parent:
            return True
    if (
        isinstance(parent, ast.Subscript)
        and parent.value is n
        and isinstance(parent.ctx, (ast.Store, ast.Del))
    ):
        return True
    return False


def thread_model(mod: ModuleInfo) -> ThreadModel:
    """Build (and cache on the ModuleInfo) the module's thread model:
    per-function role sets, per-class attribute typing, spawner flags."""
    cached = getattr(mod, "_mdi_thread_model", None)
    if cached is not None:
        return cached

    funcs: Dict[ast.AST, FuncInfo] = {}
    classes: Dict[ast.ClassDef, ClassInfo] = {}
    bad_annotations: List[Tuple[ast.AST, str]] = []

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            classes[node] = ClassInfo(node, methods={})
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs[node] = FuncInfo(
                node, node.name, None  # cls filled below
            )

    for node, info in funcs.items():
        info.cls = _enclosing_class(mod, node)
        if info.cls is not None and info.cls in classes:
            # direct class-body methods only define the class surface;
            # nested defs inside a method still resolve `self` to it
            if node in info.cls.body:
                classes[info.cls].methods[info.name] = info

    # -- annotations (pinned) + async seeds ---------------------------------
    for node, info in funcs.items():
        role = _annotation_for(mod, node)
        if role is not None:
            if role not in VALID_ROLES:
                bad_annotations.append((node, role))
            else:
                info.roles = {role}
                info.pinned = True
                continue
        if isinstance(node, ast.AsyncFunctionDef):
            info.roles.add(ROLE_LOOP)

    # -- resolve a callback reference to a FuncInfo -------------------------
    def resolve(ref: ast.AST, cls: Optional[ast.ClassDef]) -> Optional[FuncInfo]:
        if (
            isinstance(ref, ast.Attribute)
            and isinstance(ref.value, ast.Name)
            and ref.value.id == "self"
            and cls is not None
            and cls in classes
        ):
            return classes[cls].methods.get(ref.attr)
        if isinstance(ref, ast.Name):
            for fn, info in funcs.items():
                if info.cls is None and info.name == ref.id:
                    return info
        return None

    # -- seeds from Thread(target=...) and call_soon_threadsafe(...) --------
    handoff_nodes: Set[ast.AST] = set()  # refs already role-seeded
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        cls = _enclosing_class(mod, node)
        if _is_thread_ctor(node):
            if cls is not None and cls in classes:
                classes[cls].spawns_thread = True
            for kw in node.keywords:
                if kw.arg == "target":
                    handoff_nodes.add(kw.value)
                    target = resolve(kw.value, cls)
                    if target is not None and not target.pinned:
                        target.roles.add(ROLE_ENGINE)
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "call_soon_threadsafe"
            and node.args
        ):
            handoff_nodes.add(node.args[0])
            target = resolve(node.args[0], cls)
            if target is not None and not target.pinned:
                target.roles.add(ROLE_LOOP)

    # -- any-thread seeds: public surface of thread-spawning classes --------
    for cls, cinfo in classes.items():
        if not cinfo.spawns_thread:
            continue
        for name, info in cinfo.methods.items():
            if info is None or name.startswith("_"):
                continue
            if not info.pinned:
                info.roles.add(ROLE_ANY)

    # -- per-class attribute typing from __init__ ---------------------------
    for cls, cinfo in classes.items():
        init = cinfo.methods.get("__init__")
        init_writes: Set[str] = set()
        if init is not None:
            for n in _own_body_walk(init.node):
                if (
                    isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                    and isinstance(n.ctx, ast.Store)
                ):
                    init_writes.add(n.attr)
                    parent = mod.parents.get(n)
                    value = getattr(parent, "value", None)
                    if isinstance(parent, (ast.Assign, ast.AnnAssign)) and \
                            isinstance(value, ast.Call):
                        ctor = _dotted(value.func).split(".")[-1]
                        if ctor in _SYNC_CTORS:
                            cinfo.sync_attrs.add(n.attr)
                            if ctor in ("Lock", "RLock"):
                                cinfo.lock_attrs.add(n.attr)
        # attributes written ONLY in __init__ are construction-time
        # constants: publishing the object is the happens-before edge
        written_elsewhere: Set[str] = set()
        for name, info in cinfo.methods.items():
            if info is None or name == "__init__":
                continue
            for n in _own_body_walk(info.node):
                if _is_self_attr(n) and _is_write(mod, n):
                    written_elsewhere.add(n.attr)
        cinfo.init_only_attrs = init_writes - written_elsewhere

    # -- propagate roles through the call graph to a fixpoint ---------------
    def callees(info: FuncInfo) -> Iterator[FuncInfo]:
        cinfo = classes.get(info.cls) if info.cls is not None else None
        method_names = set(cinfo.methods) if cinfo is not None else set()
        for n in _own_body_walk(info.node):
            target: Optional[FuncInfo] = None
            if isinstance(n, ast.Call):
                target = resolve(n.func, info.cls)
            elif (
                isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == "self"
                and isinstance(n.ctx, ast.Load)
                and n.attr in method_names
                and n not in handoff_nodes
            ):
                # callback reference (`step_hook=self._on_step`) or a
                # property read (`self.idle`): the caller's role reaches it
                target = cinfo.methods.get(n.attr)
            if target is not None:
                yield target

    changed = True
    while changed:
        changed = False
        for info in funcs.values():
            if not info.roles:
                continue
            for target in callees(info):
                if target.pinned or target.name in _CONSTRUCTION_METHODS:
                    continue
                before = len(target.roles)
                target.roles |= info.roles
                if len(target.roles) != before:
                    changed = True

    model = ThreadModel(funcs, classes, bad_annotations)
    mod._mdi_thread_model = model  # type: ignore[attr-defined]
    return model


# ---------------------------------------------------------------------------
# shared-state analysis
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Access:
    node: ast.AST
    method: FuncInfo
    write: bool
    guarded: bool


def _is_lockish(name: str, cinfo: Optional[ClassInfo]) -> bool:
    if "lock" in name.lower():
        return True
    return cinfo is not None and name in cinfo.lock_attrs


def _lock_name_of(expr: ast.AST, cinfo: Optional[ClassInfo]) -> Optional[str]:
    """The identity of a lock expression in a `with` item, or None when
    the expression does not look like a lock."""
    d = _dotted(expr)
    if not d:
        return None
    last = d.split(".")[-1]
    if _is_lockish(last, cinfo):
        return d
    return None


def _guarded(mod: ModuleInfo, node: ast.AST, fn: ast.AST,
             cinfo: Optional[ClassInfo]) -> bool:
    """True when `node` sits lexically inside a `with <lock>:` block of
    its own function (with-block scoping, same approach as host-sync)."""
    for a in mod.ancestors(node):
        if a is fn:
            return False
        if isinstance(a, (ast.With, ast.AsyncWith)):
            for item in a.items:
                if _lock_name_of(item.context_expr, cinfo) is not None:
                    return True
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False
    return False


def _class_accesses(mod: ModuleInfo, model: ThreadModel,
                    cinfo: ClassInfo) -> Dict[str, List[_Access]]:
    """self.X reads/writes per attribute, across every role-carrying
    method of the class (nested defs with roles included — `self` still
    resolves to the class)."""
    out: Dict[str, List[_Access]] = {}
    method_names = set(cinfo.methods)
    for info in model.funcs.values():
        if info.cls is not cinfo.node:
            continue
        if not info.roles or info.name in _CONSTRUCTION_METHODS:
            continue
        for n in _own_body_walk(info.node):
            if not _is_self_attr(n):
                continue
            attr = n.attr
            if attr in method_names:  # method/property access, not state
                continue
            if attr in cinfo.sync_attrs or _is_lockish(attr, cinfo):
                continue  # synchronization primitives are meant to be shared
            if attr in cinfo.init_only_attrs:
                continue  # construction-time constant
            out.setdefault(attr, []).append(_Access(
                n, info, _is_write(mod, n),
                _guarded(mod, n, info.node, cinfo),
            ))
    return out


@rule(
    "unguarded-shared-state",
    "instance attribute shared across thread roles with accesses outside the lock",
)
def unguarded_shared_state(mod: ModuleInfo) -> Iterator[Finding]:
    model = thread_model(mod)
    for node, role in model.bad_annotations:
        yield mod.finding(
            "unguarded-shared-state",
            node,
            f"unknown thread role {role!r} in `# mdi-thread:` annotation "
            f"(valid: {', '.join(VALID_ROLES)})",
        )
    for cinfo in model.classes.values():
        for attr, accesses in sorted(_class_accesses(mod, model, cinfo).items()):
            write_roles: Set[str] = set()
            touch_roles: Set[str] = set()
            for a in accesses:
                touch_roles |= a.method.roles
                if a.write:
                    write_roles |= a.method.roles
            if not write_roles or len(touch_roles) < 2:
                continue  # single-role state, or never written post-init
            unguarded = sorted(
                (a for a in accesses if not a.guarded),
                key=lambda a: (a.node.lineno, a.node.col_offset),
            )
            if not unguarded:
                continue
            sites = ", ".join(
                f"`{a.method.name}`:{a.node.lineno}"
                f" ({'write' if a.write else 'read'})"
                for a in unguarded[:4]
            )
            more = len(unguarded) - 4
            if more > 0:
                sites += f" and {more} more"
            yield mod.finding(
                "unguarded-shared-state",
                unguarded[0].node,
                f"`self.{attr}` of `{cinfo.node.name}` is written on the "
                f"{'/'.join(sorted(write_roles))} role and touched from "
                f"{'/'.join(sorted(touch_roles))}, but not every cross-role "
                f"access is under `with self.<lock>`: {sites} — take the "
                "lock, or suppress with a justification if the racy read "
                "is the design (GIL-atomic snapshot)",
            )


# ---------------------------------------------------------------------------
# blocking-in-event-loop
# ---------------------------------------------------------------------------


def _blocking_reason(mod: ModuleInfo, call: ast.Call) -> Optional[str]:
    d = _dotted(call.func)
    awaited = isinstance(mod.parents.get(call), ast.Await)
    if d == "time.sleep":
        return "`time.sleep` parks the whole event loop"
    if d == "os.system":
        return "`os.system` blocks until the child exits"
    parts = d.split(".")
    if len(parts) >= 2 and parts[-2] == "subprocess" and \
            parts[-1] in _BLOCKING_SUBPROCESS:
        return f"`{d}` blocks until the child exits"
    if not isinstance(call.func, ast.Attribute) or awaited:
        return None
    attr = call.func.attr
    recv = _dotted(call.func.value)
    if attr == "acquire":
        return f"sync `{recv or '<expr>'}.acquire()` can block the loop " \
               "on a lock another thread holds"
    if attr == "wait" and not d.startswith("asyncio"):
        return f"un-awaited `{recv or '<expr>'}.wait()` blocks the loop " \
               "until another thread signals"
    if attr == "join" and "thread" in recv.lower():
        return f"`{recv}.join()` blocks the loop on a thread exit"
    return None


@rule(
    "blocking-in-event-loop",
    "time.sleep/.acquire()/.wait()/subprocess call inside an async def (stalls every connection)",
)
def blocking_in_event_loop(mod: ModuleInfo) -> Iterator[Finding]:
    model = thread_model(mod)
    for node, info in model.funcs.items():
        on_loop = isinstance(node, ast.AsyncFunctionDef) or \
            info.roles == {ROLE_LOOP}
        if not on_loop:
            continue
        for n in _own_body_walk(node):
            if not isinstance(n, ast.Call):
                continue
            why = _blocking_reason(mod, n)
            if why:
                yield mod.finding(
                    "blocking-in-event-loop",
                    n,
                    f"{why} inside loop-role `{info.name}`: every other "
                    "connection stalls behind it — await the async "
                    "equivalent, or push it off-loop with "
                    "`loop.run_in_executor` (server/http.py's pattern)",
                )


# ---------------------------------------------------------------------------
# lock-order-inversion
# ---------------------------------------------------------------------------


def _with_lock_names(node: ast.AST, cinfo: Optional[ClassInfo]) -> List[str]:
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return []
    out = []
    for item in node.items:
        name = _lock_name_of(item.context_expr, cinfo)
        if name is not None:
            out.append(name)
    return out


@rule(
    "lock-order-inversion",
    "two locks acquired in both nesting orders within the module (deadlock-capable)",
)
def lock_order_inversion(mod: ModuleInfo) -> Iterator[Finding]:
    model = thread_model(mod)
    edges: Dict[Tuple[str, str], List[ast.AST]] = {}
    for node, info in model.funcs.items():
        cinfo = model.classes.get(info.cls) if info.cls is not None else None
        for n in _own_body_walk(node):
            inner = _with_lock_names(n, cinfo)
            if not inner:
                continue
            held: List[str] = []
            for a in mod.ancestors(n):
                if a is node:
                    break
                held.extend(_with_lock_names(a, cinfo))
            # `with a, b:` acquires left-to-right: earlier items are
            # held while later ones are taken
            for i, b in enumerate(inner):
                for a_name in held + inner[:i]:
                    if a_name != b:
                        edges.setdefault((a_name, b), []).append(n)
    for (a, b), sites in sorted(edges.items()):
        rev = edges.get((b, a))
        if not rev:
            continue
        for site in sites:
            yield mod.finding(
                "lock-order-inversion",
                site,
                f"`{b}` is acquired while holding `{a}` here, but line "
                f"{rev[0].lineno} acquires `{a}` while holding `{b}` — two "
                "threads taking the two orders deadlock; pick one global "
                "acquisition order",
            )


# ---------------------------------------------------------------------------
# loop-call-from-wrong-thread
# ---------------------------------------------------------------------------


@rule(
    "loop-call-from-wrong-thread",
    "asyncio loop API (call_soon/create_task/...) touched from an engine/any role",
)
def loop_call_from_wrong_thread(mod: ModuleInfo) -> Iterator[Finding]:
    model = thread_model(mod)
    for node, info in model.funcs.items():
        if isinstance(node, ast.AsyncFunctionDef):
            continue
        if not info.roles or ROLE_LOOP in info.roles:
            continue
        for n in _own_body_walk(node):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)):
                continue
            if n.func.attr not in _LOOP_ONLY_CALLS:
                continue
            d = _dotted(n.func)
            yield mod.finding(
                "loop-call-from-wrong-thread",
                n,
                f"`{d}` in `{info.name}` (role: "
                f"{'/'.join(sorted(info.roles))}) touches the asyncio loop "
                "from off-loop: these APIs are not thread-safe — cross with "
                "`loop.call_soon_threadsafe(...)` (the HTTP sink's bridge)",
            )
