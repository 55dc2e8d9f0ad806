"""mdi-lint core of the port: findings, the rule registry, suppressions,
the baseline.

A copy of `mdi_llm_tpu/analysis/core.py` (the port never imports the JAX
package), with one change: where the JAX lint finds the bodies that run
inside a compiled XLA program (`jax.jit`), the port's finds the bodies
that run inside a CUDA graph, its "captured" functions.  A captured body
runs once at capture, and every replay repeats its device work and
nothing else: a host read, a clock, a Python branch on a tensor or a
Python scalar in it is frozen at capture, as a jitted body's are at trace
time.  The capture sites of the port are

- a `StepGraph(name, key, owner, body, inputs, ...)` construction
  (`utils/step_graph.py`): `body` (the fourth argument, or `body=`) is
  captured, with the keys of its `static=dict(...)` fixed per key and its
  owner (first parameter) not a tensor; a helper that passes one of its
  own parameters on as that body (the engine's `step(name, key, body,
  **inputs)`) makes the same argument of every call to it a body too;
- `<graph>.capture(fn)` (`utils/step_graph.CudaGraph.capture`): `fn`;
- the body of a `with torch.cuda.graph(...)` block;
- a `def` marked ``# mdi-lint: captured`` on its line (a body that another
  module's `StepGraph` captures, such as a subclass's override).

A rule is a function ``check(module: ModuleInfo) -> Iterable[Finding]``
registered via the :func:`rule` decorator (implementations live in
``rules.py`` and ``threads.py``).  ``ModuleInfo`` does the shared
one-pass AST analysis every rule needs: parent links, the captured
functions and blocks, and module-level state.

Suppressions are per line, in the JAX lint's spelling::

    toks = out.tolist()  # mdi-lint: disable=host-sync -- one read per chunk

    # mdi-lint: disable-next-line=tensor-branch -- shape check, not a value branch
    if x.dim() == 2: ...

Everything after ``--`` is a free-form justification.  ``disable=all``
silences every rule on that line.

The baseline (`mdi_llm_tpu_torch/analysis/lint-baseline.json`)
grandfathers existing findings: keys are ``rule::path::<stripped source
line>`` with an occurrence count, so findings survive line-number drift
but a new violation of the same rule on a different line still fails.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

BASELINE_PATH = Path(__file__).resolve().parent / "lint-baseline.json"
# the lint's default target: the port's package, from the repository root
DEFAULT_PATHS = ("mdi_llm_tpu_torch",)

# ---------------------------------------------------------------------------
# findings + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # posix, relative to the lint root when possible
    line: int
    col: int
    message: str
    line_text: str = ""  # stripped source line, used for baseline keys

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"

    @property
    def baseline_key(self) -> str:
        return f"{self.rule}::{self.path}::{self.line_text}"


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    summary: str
    check: Callable[["ModuleInfo"], Iterable[Finding]]


RULES: Dict[str, Rule] = {}


def rule(name: str, summary: str):
    """Register a rule implementation under `name` (kebab-case)."""

    def deco(fn):
        if name in RULES:
            raise ValueError(f"duplicate rule {name!r}")
        RULES[name] = Rule(name, summary, fn)
        return fn

    return deco


# ---------------------------------------------------------------------------
# shared AST analysis: the captured functions
# ---------------------------------------------------------------------------

# StepGraph(name, key, owner, body, inputs, ...): the body's position
_STEP_BODY_ARG = 3
_CAPTURED_MARK = re.compile(r"#\s*mdi-lint:\s*captured\b")


@dataclasses.dataclass
class CaptureSpec:
    """What a capture site says of its body's parameters."""

    static_names: Set[str] = dataclasses.field(default_factory=set)
    owner_bound: bool = False  # first parameter is the owner, not a tensor
    site: Optional[ast.AST] = None  # the capture call / with / def


@dataclasses.dataclass
class CapturedFn:
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    spec: CaptureSpec

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")

    @property
    def param_names(self) -> List[str]:
        a = self.node.args
        return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]

    def static_params(self) -> Set[str]:
        """Parameters fixed at capture: the site's static names, and the
        owner (a method's `self`, a step body's first argument)."""
        names = set(self.spec.static_names)
        params = self.param_names
        if params and (self.spec.owner_bound or params[0] in ("self", "cls")):
            names.add(params[0])
        return names

    def tensor_params(self) -> Set[str]:
        return set(self.param_names) - self.static_params()


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.graph' for Attribute/Name chains, '' for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _str_keys(node: Optional[ast.AST]) -> Set[str]:
    """Keys of a `dict(a=..., b=...)` call or a `{"a": ...}` literal."""
    out: Set[str] = set()
    if isinstance(node, ast.Call) and _dotted(node.func) == "dict":
        out |= {kw.arg for kw in node.keywords if kw.arg}
    elif isinstance(node, ast.Dict):
        out |= {k.value for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    return out


def is_step_graph_call(call: ast.Call) -> bool:
    d = _dotted(call.func)
    return d == "StepGraph" or d.endswith(".StepGraph")


def is_graph_ctor(call: ast.Call) -> bool:
    """A new CUDA graph: `CudaGraph(...)`, `torch.cuda.CUDAGraph()`."""
    d = _dotted(call.func)
    return d.split(".")[-1] in ("CudaGraph", "CUDAGraph")


def is_graph_block(node: ast.AST) -> bool:
    """`with torch.cuda.graph(...)`: its body is captured."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Call):
            d = _dotted(e.func)
            if d in ("torch.cuda.graph", "cuda.graph"):
                return True
    return False


def _step_body_arg(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "body":
            return kw.value
    if len(call.args) > _STEP_BODY_ARG:
        return call.args[_STEP_BODY_ARG]
    return None


def _step_static(call: ast.Call) -> Set[str]:
    for kw in call.keywords:
        if kw.arg == "static":
            return _str_keys(kw.value)
    return set()


def capture_targets(call: ast.Call) -> List[Tuple[ast.AST, CaptureSpec]]:
    """(function expression, spec) for each body `call` captures."""
    if is_step_graph_call(call):
        body = _step_body_arg(call)
        if body is not None:
            return [(body, CaptureSpec(_step_static(call), True, call))]
        return []
    if (isinstance(call.func, ast.Attribute) and call.func.attr == "capture"
            and len(call.args) == 1 and not call.keywords):
        return [(call.args[0], CaptureSpec(set(), False, call))]
    return []


def _fn_key(expr: ast.AST) -> Optional[str]:
    """The function name a body expression refers to: `f`, `self.f`,
    `cls.f`, `Owner.f` -> 'f'."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


class ModuleInfo:
    """One parsed module plus the pre-computed facts rules share."""

    def __init__(self, path: str, source: str, tree: Optional[ast.Module] = None):
        self.path = path
        self.source = source
        self.tree = tree if tree is not None else ast.parse(source)
        self.lines = source.splitlines()
        # child -> parent links (rules walk up for enclosing context)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        defs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)
        self.captured: List[CapturedFn] = []
        self.graph_blocks: List[ast.AST] = [n for n in ast.walk(self.tree)
                                            if is_graph_block(n)]
        seen: Set[ast.AST] = set()

        def add(fn_node, spec):
            if fn_node not in seen:
                seen.add(fn_node)
                self.captured.append(CapturedFn(fn_node, spec))

        # helpers that hand one of their own parameters on as a body
        relays: Dict[str, Tuple[int, CaptureSpec]] = {}
        sites: List[Tuple[ast.AST, CaptureSpec]] = []
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            for expr, spec in capture_targets(node):
                sites.append((expr, spec))
                fn = self.enclosing_function(node)
                if isinstance(expr, ast.Name) and fn is not None:
                    params = [p.arg for p in fn.args.posonlyargs + fn.args.args]
                    if expr.id in params:
                        relays[fn.name] = (params.index(expr.id), spec)
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in relays):
                i, spec = relays[node.func.id]
                if i < len(node.args):
                    sites.append((node.args[i], CaptureSpec(
                        spec.static_names, spec.owner_bound, node)))
        for expr, spec in sites:
            if isinstance(expr, ast.Lambda):
                add(expr, spec)
                continue
            key = _fn_key(expr)
            if key is None or (isinstance(expr, ast.Name) and key in relays):
                continue
            for fn_node in defs.get(key, ()):
                if not self._is_relay_param(expr, fn_node):
                    add(fn_node, spec)
        for name_nodes in defs.values():
            for fn_node in name_nodes:
                if _CAPTURED_MARK.search(self.line_text(fn_node.lineno, strip=False)):
                    add(fn_node, CaptureSpec(set(), True, fn_node))
        self._captured_nodes: Optional[Set[ast.AST]] = None

    def _is_relay_param(self, expr: ast.AST, fn_node: ast.AST) -> bool:
        """A bare name that is a parameter of the function it appears in
        refers to that parameter, not to a def of the same name."""
        if not isinstance(expr, ast.Name):
            return False
        enclosing = self.enclosing_function(expr)
        if enclosing is None:
            return False
        params = {p.arg for p in enclosing.args.posonlyargs + enclosing.args.args
                  + enclosing.args.kwonlyargs}
        return expr.id in params

    def line_text(self, lineno: int, strip: bool = True) -> str:
        if 1 <= lineno <= len(self.lines):
            line = self.lines[lineno - 1]
            return line.strip() if strip else line
        return ""

    def finding(self, rule_name: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=rule_name,
            path=self.path,
            line=line,
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            line_text=self.line_text(line),
        )

    # -- enclosing-context helpers ------------------------------------------

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        while node in self.parents:
            node = self.parents[node]
            yield node

    def enclosing_function(self, node: ast.AST):
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a
        return None

    def captured_nodes(self) -> Set[ast.AST]:
        """Every AST node lexically inside a captured function or a
        `torch.cuda.graph` block."""
        if self._captured_nodes is None:
            self._captured_nodes = set()
            for c in self.captured:
                self._captured_nodes.update(ast.walk(c.node))
            for block in self.graph_blocks:
                for stmt in block.body:
                    self._captured_nodes.update(ast.walk(stmt))
        return self._captured_nodes

    def in_capture(self, node: ast.AST) -> bool:
        return node in self.captured_nodes()

    def captured_regions(self) -> Iterator[Tuple[str, List[ast.AST]]]:
        """(label, top nodes) of every captured function and graph block."""
        for c in self.captured:
            yield f"captured `{c.name}`", [c.node]
        for block in self.graph_blocks:
            yield f"the `torch.cuda.graph` block at line {block.lineno}", list(block.body)

    def enclosing_loop(self, node: ast.AST) -> Optional[ast.AST]:
        for a in self.ancestors(node):
            if isinstance(a, (ast.For, ast.While, ast.AsyncFor)):
                return a
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return None  # don't escape into an enclosing function's loop
        return None


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*mdi-lint:\s*disable(?P<next>-next-line)?\s*=\s*"
    r"(?P<rules>all|[A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
)


def suppressions(source: str) -> Dict[int, Set[str]]:
    """Map 1-based line number -> rule names suppressed there ('all' wins)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        names = {r.strip() for r in m.group("rules").split(",")}
        target = i + 1 if m.group("next") else i
        out.setdefault(target, set()).update(names)
    return out


def _is_suppressed(f: Finding, sup: Dict[int, Set[str]]) -> bool:
    names = sup.get(f.line, ())
    return "all" in names or f.rule in names


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


class Baseline:
    """Grandfathered findings, keyed by rule + path + source-line text."""

    def __init__(self, counts: Optional[Dict[str, int]] = None):
        self.counts: Dict[str, int] = dict(counts or {})

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not Path(path).exists():
            return cls()
        data = json.loads(Path(path).read_text())
        return cls(data.get("findings", {}))

    @classmethod
    def from_findings(cls, findings: Sequence[Finding]) -> "Baseline":
        b = cls()
        for f in findings:
            b.counts[f.baseline_key] = b.counts.get(f.baseline_key, 0) + 1
        return b

    def save(self, path: Path) -> None:
        data = {
            "note": (
                "mdi-lint grandfathered findings of the port; regenerate with "
                "`python -m mdi_llm_tpu_torch.analysis lint --update-baseline`. "
                "Fix findings rather than baselining them whenever possible."
            ),
            "version": 1,
            "findings": {k: self.counts[k] for k in sorted(self.counts)},
        }
        Path(path).write_text(json.dumps(data, indent=2) + "\n")

    def split(
        self, findings: Sequence[Finding]
    ) -> Tuple[List[Finding], List[Finding]]:
        """(new, grandfathered); at most `count` findings per key pass."""
        remaining = dict(self.counts)
        new: List[Finding] = []
        old: List[Finding] = []
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
            if remaining.get(f.baseline_key, 0) > 0:
                remaining[f.baseline_key] -= 1
                old.append(f)
            else:
                new.append(f)
        return new, old


# ---------------------------------------------------------------------------
# driving
# ---------------------------------------------------------------------------


def _selected_rules(select: Optional[Sequence[str]]) -> List[Rule]:
    import mdi_llm_tpu_torch.analysis.rules  # noqa: F401  (registers RULES)
    import mdi_llm_tpu_torch.analysis.threads  # noqa: F401  (thread-role rules)

    if not select:
        return list(RULES.values())
    missing = [s for s in select if s not in RULES]
    if missing:
        raise KeyError(f"unknown rule(s): {', '.join(missing)}")
    return [RULES[s] for s in select]


def lint_source(
    source: str,
    path: str = "<string>",
    select: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Lint one source string; returns unsuppressed findings."""
    mod = ModuleInfo(path, source)
    sup = suppressions(source)
    findings: List[Finding] = []
    for r in _selected_rules(select):
        findings.extend(r.check(mod))
    findings = [f for f in findings if not _is_suppressed(f, sup)]
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def iter_py_files(paths: Sequence[Path]) -> Iterator[Tuple[Path, Optional[str]]]:
    """Yield (py_file, None) for found files, (path, error) for bad inputs."""
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                # skip hidden dirs BELOW the lint root only (the root itself
                # may live under e.g. ~/.cache without hiding every file)
                if not any(part.startswith(".") for part in f.relative_to(p).parts):
                    yield f, None
        elif p.suffix == ".py" and p.exists():
            yield p, None
        else:
            yield p, (
                "no such file or directory" if not p.exists()
                else "not a .py file or directory"
            )


def lint_paths(
    paths: Sequence[Path],
    root: Optional[Path] = None,
    select: Optional[Sequence[str]] = None,
) -> Tuple[List[Finding], List[str]]:
    """Lint files/directories.  Returns (findings, errors).

    Paths in findings are relative to `root` (default: cwd) so baseline
    keys are stable regardless of how the tool was invoked.
    """
    root = Path(root) if root is not None else Path.cwd()
    findings: List[Finding] = []
    errors: List[str] = []
    for f, err in iter_py_files(paths):
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        if err is not None:
            errors.append(f"{rel}: {err}")
            continue
        try:
            source = f.read_text()
            findings.extend(lint_source(source, path=rel, select=select))
        except SyntaxError as e:
            errors.append(f"{rel}: syntax error: {e}")
        except OSError as e:
            errors.append(f"{rel}: {e}")
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)), errors
