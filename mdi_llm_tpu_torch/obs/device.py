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

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = [
    "ExecutableReport",
    "DeviceReportRegistry",
    "Probe",
    "introspect_step",
    "introspect_call",
    "tensor_bytes",
]


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
