"""Profiling helpers: a bounded torch.profiler window, host cProfile, and
the captures guard.

Port of `mdi_llm_tpu/utils/profiling.py`.  The JAX package counts jit
traces and XLA compiles through `jax.monitoring`; the port's compiled
steps are `StepGraph`s (`utils/step_graph.py`), whose one costly event is
a CUDA graph capture.  So:

- `CompileGuard` counts StepGraph captures within a region, with a
  warm-up mark: after warm-up a serving run must capture nothing.  An
  engine captures its steps when it is built; a capture after warm-up
  would happen inside the serving loop, and on the engine thread of the
  open-system server (`server/frontend.py`) a global-mode capture also
  forbids pinned-memory allocation from every other thread.  Every
  capture calls `note_capture`, which feeds the active guards and the
  capture listeners (`add_capture_listener`: the observability layer's
  captures counter, `obs/__init__.py`).
- `StepWindowProfiler` bounds a `torch.profiler` trace to N mid-run
  engine steps (`cli.serve --xprof-steps`) and writes a Chrome trace.
- `profile()` is the JAX package's cProfile helper, with a
  `torch.profiler` trace in place of `jax.profiler`'s.
"""

from __future__ import annotations

import cProfile
import contextlib
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

PathLike = Union[str, Path]

_active_guards: List["CompileGuard"] = []
_capture_listeners: List = []  # obs-layer hooks: fn(step) per capture


def note_capture(step) -> None:
    """Called by `StepGraph.prime` after every successful capture."""
    for guard in list(_active_guards):
        guard._observe(step)
    for fn in list(_capture_listeners):
        fn(step)


def add_capture_listener(fn) -> None:
    """Subscribe `fn(step)` to every StepGraph capture.  Pair with
    `remove_capture_listener` (try/finally): the list is process-wide."""
    if fn not in _capture_listeners:
        _capture_listeners.append(fn)


def remove_capture_listener(fn) -> None:
    try:
        _capture_listeners.remove(fn)
    except ValueError:
        pass


def _torch_profile():
    """A torch.profiler session over the CPU and, where there is one, the
    card."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


class RecompileError(RuntimeError):
    """A step was captured again after the warm-up boundary."""


class CompileGuard:
    """Count StepGraph captures within a region, with a warm-up mark.

    Usage::

        guard = CompileGuard(label="serve")
        with guard:
            engine = gen.serve(...)        # captures its steps (warm-up)
            guard.mark_warm()
            engine.run()                   # steady state
        guard.expect_clean()   # raises RecompileError if anything captured

    Counts are process-wide (any step of any engine), which is the
    invariant a serving run wants: NOTHING in the steady-state region may
    capture.  Guards nest; each keeps its own counts."""

    def __init__(self, label: str = "", max_recompiles_after_warmup: int = 0):
        self.label = label
        self.max_recompiles_after_warmup = int(max_recompiles_after_warmup)
        self.captures = 0
        self.captured: List[str] = []  # "name key" of each capture
        self._warm: Optional[int] = None

    def __enter__(self) -> "CompileGuard":
        _active_guards.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _active_guards.remove(self)

    def _observe(self, step) -> None:
        self.captures += 1
        self.captured.append(f"{step.name} {step.key}")

    def mark_warm(self) -> None:
        """Everything captured so far is warm-up; later captures are faults."""
        self._warm = self.captures

    @property
    def captures_after_warmup(self) -> Optional[int]:
        if self._warm is None:
            return None
        return self.captures - self._warm

    def summary(self) -> Dict[str, Optional[int]]:
        return {
            "captures": self.captures,
            "captures_after_warmup": self.captures_after_warmup,
        }

    def expect_clean(self) -> None:
        """Raise RecompileError if the post-warm-up region captured more than
        the allowance (default 0).  No-op if mark_warm was never called."""
        after = self.captures_after_warmup
        if after is None or after <= self.max_recompiles_after_warmup:
            return
        name = f" [{self.label}]" if self.label else ""
        raise RecompileError(
            f"CompileGuard{name}: {after} step capture(s) after warm-up "
            f"({', '.join(self.captured[self._warm:])}): a step was built or "
            "captured inside the steady state; build and prime every step "
            "before serving"
        )


class StepWindowProfiler:
    """Bounded `torch.profiler` capture of N mid-run engine steps.

    The trace starts after `skip` engine steps and stops `n_steps` later,
    so `cli.serve --xprof-steps N` yields a bounded profile whatever the
    run length.  Drive it from `ServingEngine.run(step_hook=prof.on_step)`;
    `close()` (call it in a finally) stops a window left open by an early
    exit.  The window is written as a Chrome trace,
    `<logdir>/steps_<first>-<last>.json` (open in Perfetto)."""

    def __init__(self, logdir: PathLike, n_steps: int, skip: int = 8):
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        self.logdir = Path(logdir)
        self.n_steps = int(n_steps)
        self.skip = max(0, int(skip))
        self.active = False
        self.done = False
        self.window: Optional[tuple] = None  # (first_step, last_step)
        self.path: Optional[Path] = None
        self._prof = None

    def on_step(self, i: int) -> None:
        """Hook for the engine loop: `i` is the 1-based count of COMPLETED
        steps.  The trace spans steps skip+1 .. skip+n_steps inclusive."""
        if self.done:
            return
        self._last = i
        if not self.active and i >= self.skip:
            self._prof = _torch_profile()
            self._prof.__enter__()
            self.active = True
            self._first = i + 1
            return
        if self.active and i >= self.skip + self.n_steps:
            self._stop()

    def _stop(self) -> None:
        self._prof.__exit__(None, None, None)
        self.active = False
        self.done = True
        self.window = (self._first, self._last)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.path = self.logdir / f"steps_{self._first}-{self._last}.json"
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None

    def close(self) -> None:
        """Stop a still-open window (short runs, exceptions)."""
        if self.active:
            self._stop()


@contextlib.contextmanager
def profile(
    logdir: Optional[PathLike] = None,
    host_profile_path: Optional[PathLike] = None,
) -> Iterator[None]:
    """Write a torch.profiler Chrome trace to `<logdir>/trace.json` and/or
    a cProfile dump to `host_profile_path`."""
    prof = None
    if host_profile_path is not None:
        prof = cProfile.Profile()
        prof.enable()
    trace = _torch_profile() if logdir is not None else None
    try:
        with trace if trace is not None else contextlib.nullcontext():
            yield
    finally:
        if trace is not None:
            Path(logdir).mkdir(parents=True, exist_ok=True)
            trace.export_chrome_trace(str(Path(logdir) / "trace.json"))
        if prof is not None:
            prof.disable()
            p = Path(host_profile_path)
            p.parent.mkdir(parents=True, exist_ok=True)
            prof.dump_stats(str(p))
