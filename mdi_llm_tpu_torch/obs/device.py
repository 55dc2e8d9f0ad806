"""Step introspection: what each serving step costs ON PAPER.

Port of `mdi_llm_tpu/obs/device.py`.  The JAX package AOT-compiles each
executable on the side and reads XLA's cost and memory analyses.  The
port's compiled steps are `StepGraph`s (`utils/step_graph.py`), captured
once when an engine is built, so a step's report is taken from the run it
already makes before its capture:

- `flops`: `torch.utils.flop_counter.FlopCounterMode` over the step's
  eager warm-up run (the run `CudaGraph` makes before capturing), plus the
  operations the hand-written kernels report from their static shapes
  (`kernels.flop_tally`: they are called through ctypes, where the mode
  cannot see them).  On the CPU, where nothing is captured, the body runs
  once under the probe with every counter and generator put back.  The
  count is the step's cost at its static shapes: attention is counted
  over every packed row against the whole table window (the plain route's
  dense math; the JAX package's cost analysis counts the same);
- `argument_bytes` / `output_bytes`: the step's static input buffers and
  its outputs;
- `temp_bytes`: the growth of the card's reserved memory across the
  capture — the graph's private pool (`torch.cuda.memory_stats`);
- `alias_bytes`: the state the step writes in place (the paged pool or
  the dense cache), given by the caller;
- `transcendentals`, `bytes_accessed`, `generated_code_bytes`: the card
  gives none of them; they stay None, as every number the card cannot
  give does.

Contract, as in the JAX package: a capture happens at most ONCE per
(label, key, variant), when the engine is built (`ServingObserver(
device=True)`), so the steady state does no extra work; and capture never
raises: a probe or capture that fails gives a report with `error` set and
every number None (the engine then captures the step without the probe,
and raises if that fails: it never falls back to eager launches).  Eager
steps (the speculative verify) are measured at their first call
(`introspect_call`), which is the real call.
"""

from __future__ import annotations

import copy
import enum
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

__all__ = [
    "ExecutableReport",
    "DeviceReportRegistry",
    "Probe",
    "StepSpec",
    "abstractify",
    "introspect_step",
    "introspect_call",
    "tensor_bytes",
]

META = torch.device("meta")


class StepSpec(NamedTuple):
    """One serving or generation step, described for tracing on the meta
    device (the JAX `ExecutableSpec`).  Produced by the enumeration seams
    (`ServingEngine.enumerate_executables`, `Generator.
    enumerate_executables`) and consumed by `analysis/ir.py` and
    `analysis/liveness.py`.

    - `body(owner, **static, **{name: args[name] for name not in owned})`
      is the exact function the dispatch site calls (a `StepGraph` body or
      an eager method);
    - `owner` is a meta twin (`abstractify`) of the engine or Generator;
    - `args` names every tensor tree of the step, in order: those in
      `owned` the body reads from the owner (the weights, the pool, the
      sampling operands: the same tensor objects), the others it is passed;
      each becomes graph inputs, so nothing the step reads is a constant;
    - `roles` names the special args: ``{"params": "params", "kv": "kv"}``
      as the JAX argnum roles, so byte attribution need not guess by size;
    - `writes` names the args the step updates in place (the JAX
      `donate_argnums`): the pool for every step that writes it."""

    label: str  # mixed / decode / decode_chunk / verify / prefill / ...
    key: Tuple  # static-shape key, e.g. (B, T)
    body: Callable[..., Any]
    owner: Any
    args: Dict[str, Any]
    static: Optional[Dict[str, Any]]
    roles: Dict[str, str]
    owned: Tuple[str, ...] = ()
    writes: Tuple[str, ...] = ()

    @property
    def name(self) -> str:
        ks = ",".join(str(k) for k in self.key)
        return f"{self.label}({ks})"


def _tensor_twin(x: torch.Tensor, memo: Dict[int, Any]) -> torch.Tensor:
    """A meta tensor of `x`'s shape, strides and dtype; a view's twin is the
    same view of its base's twin, so aliasing survives (a tp rank's slices
    stay views of the one weight tree)."""
    base = x._base
    if base is not None:
        tb = _twin(base, memo)
        return tb.as_strided(x.shape, x.stride(), x.storage_offset())
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=META)


def _twin(x, memo: Dict[int, Any]):
    key = id(x)
    if key in memo:
        return memo[key]
    if isinstance(x, torch.Tensor):
        out = _tensor_twin(x, memo)
    elif isinstance(x, torch.device):
        out = META
    elif isinstance(x, torch.Generator):
        # meta has no generator: draws on meta tensors take a CPU one
        out = torch.Generator().manual_seed(x.initial_seed())
    elif isinstance(x, dict):
        out = type(x)() if type(x) is not dict else {}
        memo[key] = out
        for k, v in x.items():
            out[_twin(k, memo) if isinstance(k, torch.device) else k] = _twin(v, memo)
        return out
    elif isinstance(x, list):
        out = []
        memo[key] = out
        out.extend(_twin(v, memo) for v in x)
        return out
    elif isinstance(x, tuple):
        vals = [_twin(v, memo) for v in x]
        out = type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    elif isinstance(x, functools.partial):
        out = functools.partial(_twin(x.func, memo), *_twin(x.args, memo),
                                **_twin(x.keywords, memo))
    elif type(x).__module__.startswith("mdi_llm_tpu_torch.") and hasattr(x, "__dict__") \
            and type(x).__name__ not in _NOT_TWINNED and not isinstance(x, enum.Enum):
        out = copy.copy(x)
        memo[key] = out
        for k, v in vars(x).items():
            object.__setattr__(out, k, _twin(v, memo))
        return out
    else:
        out = x
    memo[key] = out
    return out


# host-side state a step body never reads: kept as it is (the step graphs
# hold the live device buffers and weak references to their owner)
_NOT_TWINNED = ("StepGraph", "Scheduler", "KVPool", "HostTier", "HostBlockStore",
                "ServingObserver", "ServingStats", "SwapCostModel")


def abstractify(tree, memo: Optional[Dict[int, Any]] = None):
    """The meta twin of a tree (dicts, lists, tuples) of tensors, or of a
    whole owner (an engine with its Generator): every tensor a meta tensor
    of its shape, strides and dtype (a view stays a view of its base's
    twin), every device the meta device, every `torch.Generator` a CPU one
    with its seed; the port's own objects are copied with their attributes
    twinned, host-side bookkeeping (`_NOT_TWINNED`) is shared as it is.  A
    body traced on an owner's twin reads meta tensors, moves no counter of
    the owner and touches no card.  Pass one `memo` to twin an owner and
    trees of its tensors consistently (the same object, the same twin)."""
    return _twin(tree, {} if memo is None else memo)


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested tuple/list/dict of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


@dataclass
class ExecutableReport:
    """One step's static cost sheet (the JAX package's fields and keys;
    `None` means the card does not report that number, `error` says why
    the whole capture failed)."""

    label: str  # step: mixed / decode / decode_chunk / verify / ...
    key: Tuple  # static-shape key, e.g. (B, T)
    variant: str = ""  # e.g. the pool dtype — same shapes, other kernels
    backend: str = ""
    flops: Optional[float] = None
    transcendentals: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    error: Optional[str] = None

    @property
    def name(self) -> str:
        """Stable human/JSON key: `label(k0,k1)[variant]`."""
        ks = ",".join(str(k) for k in self.key)
        tag = f"[{self.variant}]" if self.variant else ""
        return f"{self.label}({ks}){tag}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "label": self.label,
            "key": list(self.key),
            "variant": self.variant,
            "backend": self.backend,
            "flops": self.flops,
            "transcendentals": self.transcendentals,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "error": self.error,
        }


class Probe:
    """Counts one run's operations and, on a CUDA device, measures the
    capture after it (`StepGraph.prime(probe=)` drives it)."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.flops: Optional[float] = None
        self.output_bytes: Optional[int] = None
        self.temp_bytes: Optional[int] = None
        self._reserved: Optional[int] = None

    def measure(self, fn: Callable[[], Any]) -> Any:
        from torch.utils.flop_counter import FlopCounterMode

        from mdi_llm_tpu_torch import kernels

        with FlopCounterMode(display=False) as mode, kernels.flop_tally() as tally:
            out = fn()
        self.flops = float(mode.get_total_flops() + tally.flops)
        self.output_bytes = tensor_bytes(out)
        return out

    @staticmethod
    def _reserved_now() -> int:
        return int(torch.cuda.memory_stats().get("reserved_bytes.all.current", 0))

    def capture_begins(self) -> None:
        if self.cuda:
            # a capture empties the allocator's cache first; do it here, so
            # the growth across the capture is the graph's private pool
            # mdi-lint: disable-next-line=host-sync -- measures the capture's pool growth: the sync is the point
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            self._reserved = self._reserved_now()

    def captured(self) -> None:
        if self.cuda:
            self.temp_bytes = self._reserved_now() - self._reserved


def _report(label, key, variant, device) -> ExecutableReport:
    return ExecutableReport(label=label, key=tuple(key), variant=variant,
                            backend=torch.device(device).type)


def introspect_step(step, label: str, key, variant: str = "",
                    alias_bytes: Optional[int] = None) -> ExecutableReport:
    """Prime (capture) `step` under a `Probe` and report what it measured.
    Call it where a warm-up over the static inputs' present contents has
    no effect (an engine's zero inputs, or a step's first values).  Never
    raises: a failure is a report with `error` set; the step is then left
    uncaptured, and the engine's own capture (or the step's next run)
    captures it again or raises there."""
    inputs = list(step.inputs.values())
    device = inputs[0].device if inputs else "cpu"
    rep = _report(label, key, variant, device)
    probe = Probe(device)
    try:
        step.prime(probe=probe)
    except Exception as exc:  # a failed count or capture is reported, never raised
        rep.error = f"{type(exc).__name__}: {exc}"
        return rep
    rep.flops = probe.flops
    rep.argument_bytes = tensor_bytes(step.inputs)
    rep.output_bytes = probe.output_bytes
    rep.temp_bytes = probe.temp_bytes
    rep.alias_bytes = alias_bytes
    return rep


def introspect_call(fn: Callable[..., Any], args: tuple, label: str, key,
                    variant: str = "", alias_bytes: Optional[int] = None):
    """Run `fn(*args)` (an eager step's real call) under a `Probe`; returns
    (its output, the report).  A failure of the call itself raises, as the
    call would without the probe."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)), "cpu")
    rep = _report(label, key, variant, device)
    probe = Probe(device)
    out = probe.measure(lambda: fn(*args))
    rep.flops = probe.flops
    rep.argument_bytes = tensor_bytes(args)
    rep.output_bytes = probe.output_bytes
    rep.alias_bytes = alias_bytes
    return out, rep


class DeviceReportRegistry:
    """Report store keyed on (label, key, variant), one capture each.

    `capture_enabled=False` builds a publish-only registry: `capture`
    becomes a lookup (nothing is measured), but `add` still accepts
    reports captured elsewhere — how a fresh observer on a warm Generator
    gets the reports of its earlier engines (`ServingEngine` publishes its
    Generator's cache at run end)."""

    def __init__(self, capture_enabled: bool = True):
        self.capture_enabled = capture_enabled
        self._reports: "Dict[Tuple, ExecutableReport]" = {}

    def __len__(self) -> int:
        return len(self._reports)

    def capture(self, label, key, measure: Callable[[], ExecutableReport],
                variant="") -> Optional[ExecutableReport]:
        """The report of (label, key, variant): `measure()` builds it the
        first time, when capture is enabled."""
        k = (label, tuple(key), variant)
        if self.capture_enabled and k not in self._reports:
            self._reports[k] = measure()
        return self._reports.get(k)

    def add(self, report: ExecutableReport) -> None:
        """Publish an externally-captured report (first one wins)."""
        self._reports.setdefault(
            (report.label, report.key, report.variant), report
        )

    def get(self, label, key, variant="") -> Optional[ExecutableReport]:
        return self._reports.get((label, tuple(key), variant))

    def reports(self) -> List[ExecutableReport]:
        return list(self._reports.values())

    def to_dict(self) -> Dict[str, Dict]:
        """{report.name: report dict}, insertion-ordered — the
        `--metrics-out` "device" block."""
        return {r.name: r.to_dict() for r in self._reports.values()}
