"""Open-loop load generation and the offered-load SLO sweep.

A copy of `mdi_llm_tpu/server/loadgen.py` (host-only Python).

Open-loop means arrivals follow their OWN clock: the generator submits
request i at its scheduled offset whether or not earlier requests have
finished, exactly like production traffic (a closed loop — next request
after the previous completes — hides queueing collapse, because the
arrival rate politely slows down with the server; the open loop is what
p99-under-load is defined against).

Pieces, all host-side and clock-injectable for deterministic tests:

- `poisson_arrivals` / `replay_arrivals` — build an `ArrivalSpec` list
  from a (rid, prompt, max_new) trace: exponential inter-arrival gaps at
  a target QPS, or replayed timestamps at a speed factor.
- `OpenLoopRunner` — submits the specs through a `ServingFrontend` at
  their offsets (sleeping on the injected clock), counts accepted vs
  rejected (backpressure is DATA in an open system, not an error), then
  waits for the accepted set to finish.
- `sweep_offered_load` — the knee finder: walk an ascending QPS grid,
  measure each point, and report the highest offered load whose p99
  TTFT/TPOT still meet the SLO.  `measure` is a callable so the same
  sweep drives the real engine (chip_smoke.py's `server` phase) and a
  synthetic queueing model (the fake-clock tier-1 test).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ArrivalSpec",
    "OpenLoopReport",
    "OpenLoopRunner",
    "poisson_arrivals",
    "replay_arrivals",
    "sweep_offered_load",
]


@dataclass
class ArrivalSpec:
    """One scheduled arrival: submit `prompt` at offset `at_s` (seconds
    from the run start) with the given budgets and policy attributes."""

    rid: str
    prompt: List[int]
    max_new_tokens: int
    at_s: float
    priority: int = 0
    tenant: str = ""
    ttft_slo_s: Optional[float] = None


def poisson_arrivals(trace: Sequence[Tuple], qps: float,
                     seed: int = 10137) -> List[ArrivalSpec]:
    """Poisson process at rate `qps` over a (rid, prompt, max_new) trace:
    inter-arrival gaps ~ Exp(qps), the memoryless arrival model open
    systems are judged under.  Deterministic per seed."""
    import numpy as np

    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, size=len(trace))
    t, out = 0.0, []
    for (rid, prompt, new), gap in zip(trace, gaps):
        t += float(gap)
        out.append(ArrivalSpec(rid, list(prompt), int(new), at_s=t))
    return out


def replay_arrivals(trace: Sequence[Tuple], speed: float = 1.0) -> List[ArrivalSpec]:
    """Replayed-trace arrivals: items are (rid, prompt, max_new, at_s)
    with recorded offsets, compressed by `speed` (2.0 = twice as fast —
    the knob an offered-load sweep turns on a production trace)."""
    if speed <= 0:
        raise ValueError(f"speed must be positive, got {speed}")
    out = []
    for rid, prompt, new, at_s in trace:
        out.append(ArrivalSpec(rid, list(prompt), int(new),
                               at_s=float(at_s) / speed))
    return out


@dataclass
class OpenLoopReport:
    """What one open-loop run offered and what came back."""

    offered: int = 0
    accepted: int = 0
    rejected: int = 0
    completed: int = 0
    errored: int = 0
    wall_s: float = 0.0
    # offered arrivals / wall between first and last submission
    offered_qps: float = 0.0

    def to_dict(self) -> Dict:
        return {
            "offered": self.offered,
            "accepted": self.accepted,
            "rejected": self.rejected,
            "completed": self.completed,
            "errored": self.errored,
            "wall_s": round(self.wall_s, 3),
            "offered_qps": round(self.offered_qps, 3),
        }


class OpenLoopRunner:
    """Drive one arrival schedule through a `ServingFrontend`.

    `clock`/`sleep` are injectable (tests run on fake time; production
    uses the wall clock).  Rejections (QueueFullError) are counted, not
    raised — an open system SHEDS load at saturation, and the sweep
    reads the shed fraction as data.  `run()` blocks until every
    accepted request completes or `drain_timeout_s` expires."""

    def __init__(self, frontend, arrivals: Sequence[ArrivalSpec],
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 drain_timeout_s: float = 600.0):
        self.frontend = frontend
        self.arrivals = sorted(arrivals, key=lambda a: a.at_s)
        self.clock = clock
        self.sleep = sleep
        self.drain_timeout_s = drain_timeout_s

    def run(self) -> OpenLoopReport:
        from mdi_llm_tpu_torch.server.frontend import (
            FrontendClosedError,
            QueueFullError,
        )

        rep = OpenLoopReport(offered=len(self.arrivals))
        handles = []
        t0 = self.clock()
        for spec in self.arrivals:
            delay = spec.at_s - (self.clock() - t0)
            if delay > 0:
                self.sleep(delay)  # open loop: arrivals keep their OWN
                # schedule; a slow server makes the queue grow (or shed),
                # never the arrival rate drop
            try:
                handles.append(self.frontend.submit(
                    spec.prompt, spec.max_new_tokens, rid=spec.rid,
                    priority=spec.priority, tenant=spec.tenant,
                    ttft_slo_s=spec.ttft_slo_s,
                ))
                rep.accepted += 1
            except QueueFullError:
                rep.rejected += 1
            except FrontendClosedError:
                rep.rejected += 1
        span = self.clock() - t0
        rep.offered_qps = rep.offered / span if span > 0 else 0.0
        deadline = self.clock() + self.drain_timeout_s
        for h in handles:
            remaining = deadline - self.clock()
            if remaining <= 0 or not h.done.wait(timeout=max(0.0, remaining)):
                rep.errored += 1
                continue
            if h.error is not None or h.cancelled:
                rep.errored += 1
            else:
                rep.completed += 1
        rep.wall_s = self.clock() - t0
        return rep


def sweep_offered_load(
    measure: Callable[[float], Dict],
    qps_grid: Sequence[float],
    slo: Dict[str, float],
    stop_after_misses: int = 1,
) -> Dict:
    """Walk `qps_grid` ascending, measure each offered load, and find the
    max QPS meeting the SLO — the headline number of an open system.

    `measure(qps)` returns at least `{"ttft_p99_s", "tpot_p99_s"}`
    (None/missing = no data at that point, treated as a miss only if an
    SLO names it); `slo` maps those keys to ceilings, e.g.
    ``{"ttft_p99_s": 2.0, "tpot_p99_s": 0.5}``.  A point also misses
    when it sheds load (`rejected > 0`): a 429'd arrival never got a
    first token, so counting the survivors' p99 alone would declare a
    saturated server healthy.

    The walk stops after `stop_after_misses` consecutive misses (the
    knee is behind us; measuring deeper collapse just burns wall clock —
    pass len(grid) to measure everything).  Returns ``{"max_qps_ok",
    "knee_qps", "rows"}``: `max_qps_ok` is the highest passing offered
    load (None if even the lowest missed), `knee_qps` the first failing
    one (None if none failed inside the grid).
    """
    rows: List[Dict] = []
    max_ok: Optional[float] = None
    knee: Optional[float] = None
    misses = 0
    for qps in sorted(qps_grid):
        row = dict(measure(qps))
        row["qps"] = qps
        failures = []
        for key, ceiling in slo.items():
            got = row.get(key)
            if got is None or got > ceiling:
                failures.append(
                    f"{key}={'n/a' if got is None else round(got, 4)}"
                    f" > {ceiling}"
                )
        if row.get("rejected"):
            failures.append(f"rejected={row['rejected']}")
        row["slo_ok"] = not failures
        row["slo_failures"] = failures
        rows.append(row)
        if failures:
            misses += 1
            if knee is None:
                knee = qps
            if misses >= stop_after_misses:
                break
        else:
            misses = 0
            knee = None
            max_ok = qps
    return {"max_qps_ok": max_ok, "knee_qps": knee, "slo": dict(slo),
            "rows": rows}
