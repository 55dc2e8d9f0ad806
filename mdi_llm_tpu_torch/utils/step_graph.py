"""Per-shape steps built once and replayed: the port's counterpart of
`jax.jit` with donation.

The JAX package runs each serving and generation step as one donated,
jitted executable per shape (`ServingEngine._mixed_fn(B, T)`,
`_decode_chunk_fn(B, K)`, `Generator._decode_chunk_fn(B, n_steps)`).  The
port builds each such step as a `StepGraph`:

- static input tensors, allocated once by the owner (outside any graph
  pool) and zero-filled: zeros are inert operands for every step here
  (all-zero tables send every write to the trash block);
- a body, a function of the owner (the engine or the Generator), of
  static Python arguments fixed per key and of the static inputs, that
  reads only those and the model's persistent state (parameters, rope
  tables, the paged pool or the dense cache, sampling operands), writes
  that state in place and returns its outputs.  The step holds its owner
  weakly: an owner that holds its steps is freed as soon as it is
  dropped, device memory and graph pools with it;
- on the card, one `torch.cuda.CUDAGraph` captured over them.

`run(**values)` copies the given values into the static inputs on the
current stream and replays the graph; inputs not named keep their
contents.  On the CPU, or with capture off (the owner's private `_graphs`
switch, used only to compare with eager launches on the card), it calls
the body on the same static buffers: the CPU tests run the plumbing the
card replays.  The outputs of a replay live in the graph's private pool
and are overwritten by the next replay, so a caller enqueues its reads
of them (on the same stream) before it runs the step again.

Capture happens once per step, on the first `run` or on `prime()`: the
body runs once eagerly on a side stream (kernels built and loaded,
library handles made, the allocator warmed), the state of every
registered `torch.Generator` is put back, and the body is captured.  A
failed capture or replay raises, naming the step and its key: a step
never gives way to eager launches.

Counters: the kernel wrappers count launches in plain ints
(`kernel_counters()`), the owner names its own (the engine's
`forward_calls`).  They tick when Python runs the body, which a replay
does not.  So `StepGraph` puts every counter back after the warm-up and
the capture, keeps the change the capture made, and adds it again at
every replay: counts are those of the steps that ran, the same as an
eager run of the same steps.

Every capture is reported to `utils/profiling.note_capture` (the
captures guard and the observability layer's captures counter).
`prime(probe=...)` runs the step's warm-up under a probe that counts its
operations and measures the capture (`obs/device.py`); on the CPU, or
with capture off, the body runs once under the probe with every counter
and generator put back.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdi_llm_tpu_torch.ops import flash
from mdi_llm_tpu_torch.ops import paged_attention as pa
from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention
from mdi_llm_tpu_torch.utils import profiling

__all__ = ["StepGraph", "CudaGraph", "kernel_counters", "summarize"]

Counter = Tuple[Any, str]  # (object, attribute holding an int)


def kernel_counters() -> List[Counter]:
    """The launch and call counters of every kernel wrapper and plain
    route a serving or generation step can reach."""
    return [
        (ragged_paged_attention, "launches"),
        (ragged_paged_attention, "merge_launches"),
        (pa._paged_prefill_plain, "calls"),
        (pa._paged_attention_plain, "calls"),
        (flash.flash_attention, "launches"),
        (flash.flash_attention_plain, "calls"),
    ]


class CudaGraph:
    """One `torch.cuda.CUDAGraph` with its own side stream and private
    memory pool (no pool is shared between steps: a shared pool could hand
    one graph's intermediates the memory of another's outputs while a
    pending copy still reads them).  `generators` are registered, so every
    replay advances their Philox offsets as the eager draws would."""

    def __init__(self, generators: Sequence[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph()
        self.generators = list(generators)
        for g in self.generators:
            self.graph.register_generator_state(g)
        self.stream = torch.cuda.Stream()

    def warm_up(self, fn: Callable[[], Any]) -> None:
        """Run `fn` once on the capture stream, then put the generators'
        states back: the warm-up draws no numbers of the run."""
        states = [g.get_state() for g in self.generators]
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            fn()
        torch.cuda.current_stream().wait_stream(self.stream)
        for g, s in zip(self.generators, states):
            g.set_state(s)

    def capture(self, fn: Callable[[], Any]) -> Any:
        """Capture `fn` (nothing runs); returns its static outputs."""
        with torch.cuda.graph(self.graph, stream=self.stream):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


class StepGraph:
    """One step at one shape key: static inputs, a body, and on the card a
    captured graph (see the module docstring)."""

    def __init__(
        self,
        name: str,
        key: tuple,
        owner: Any,
        body: Callable[..., Any],
        inputs: Dict[str, torch.Tensor],
        *,
        capture: bool,
        static: Optional[Dict[str, Any]] = None,
        generators: Sequence[torch.Generator] = (),
        counters: Iterable[str] = (),
    ):
        """`body(owner, **static, **inputs)` computes the step; `counters`
        names the owner's own int counters."""
        self.name = name
        self.key = key
        self._owner = weakref.ref(owner)
        self.body = body
        self.static = dict(static or {})
        self.inputs = inputs
        self.capturing = bool(capture)
        self.generators = list(generators)
        self.owner_counters = tuple(counters)
        self.graph: Optional[CudaGraph] = None
        self.outputs: Any = None
        self._deltas: List[int] = []
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def load(self, **values) -> None:
        """Copy `values` into the static inputs of the same names, on the
        current stream: a tensor directly, a host array or number through a
        fresh pinned staging copy (the caching host allocator keeps it
        alive until its non-blocking copy has run)."""
        for name, value in values.items():
            dst = self.inputs[name]
            if isinstance(value, torch.Tensor):
                dst.copy_(value, non_blocking=True)
                continue
            src = torch.from_numpy(np.ascontiguousarray(value)).to(dst.dtype)
            if dst.is_cuda:
                src = src.pin_memory()
            dst.copy_(src.reshape(dst.shape), non_blocking=True)

    def call(self) -> Any:
        """The body on the static inputs, run now."""
        return self.body(self._owner(), **self.static, **self.inputs)

    def _counters(self) -> List[Counter]:
        owner = self._owner()
        return kernel_counters() + [(owner, attr) for attr in self.owner_counters]

    def _counts(self) -> List[int]:
        return [getattr(obj, attr) for obj, attr in self._counters()]

    def _set_counts(self, values: Sequence[int]) -> None:
        for (obj, attr), v in zip(self._counters(), values):
            setattr(obj, attr, v)

    def prime(self, probe=None) -> None:
        """Capture now (a no-op on the CPU, with capture off, or when
        captured already), over whatever the static inputs hold.  With a
        `probe` (`obs/device.py`) the warm-up runs under `probe.measure`
        and `probe.capture_begins`/`captured` bracket the capture; without
        capture (or captured already) the body runs once under the probe,
        leaving no trace."""
        if probe is not None and (not self.capturing or self.graph is not None):
            self._held(lambda: probe.measure(self.call))
            return
        if not self.capturing or self.graph is not None:
            return
        t0 = time.perf_counter()
        before = self._counts()
        try:
            graph = CudaGraph(self.generators)
            graph.warm_up(self.call if probe is None else lambda: probe.measure(self.call))
            warm = self._counts()
            if probe is not None:
                probe.capture_begins()
            outputs = graph.capture(self.call)
            if probe is not None:
                probe.captured()
        except Exception as e:
            self._set_counts(before)
            raise RuntimeError(
                f"CUDA graph capture of step {self.name!r} at key {self.key} failed: {e}"
            ) from e
        self._deltas = [b - a for a, b in zip(warm, self._counts())]
        self._set_counts(before)
        self.graph, self.outputs = graph, outputs
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        profiling.note_capture(self)

    def _held(self, fn: Callable[[], Any]) -> None:
        """Run `fn` now, then put every counter and generator back."""
        counts = self._counts()
        states = [g.get_state() for g in self.generators]
        try:
            fn()
        finally:
            self._set_counts(counts)
            for g, st in zip(self.generators, states):
                g.set_state(st)

    def run(self, **values) -> Any:
        """Load `values`, then replay (capturing first if needed); without
        capture, call the body on the static inputs.  Returns the outputs."""
        self.load(**values)
        if not self.capturing:
            return self.call()
        self.prime()
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(
                f"CUDA graph replay of step {self.name!r} at key {self.key} failed: {e}"
            ) from e
        self._set_counts([c + d for c, d in zip(self._counts(), self._deltas)])
        self.replays += 1
        return self.outputs


def summarize(steps: Iterable[StepGraph]) -> Dict[str, Any]:
    """Steps built, graphs captured, replays and capture seconds."""
    steps = list(steps)
    return {
        "steps": len(steps),
        "captures": sum(s.captures for s in steps),
        "replays": sum(s.replays for s in steps),
        "capture_s": sum(s.capture_s for s in steps),
    }
