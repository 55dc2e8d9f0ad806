"""Pluggable scheduling policies for the continuous-batching scheduler.

The policy layer answers the two HOST-SIDE ordering questions the
scheduler asks every step, and nothing else:

1. **admission** — which waiting request gets the next free slot
   (`select_next`), and
2. **prefill packing** — in what order prefilling sequences split the
   unified step's leftover token budget (`order_prefill`).

Everything device-shaped is out of scope by construction: a policy
reorders host-side lists the scheduler already owns, so the engine's
dispatch shapes (`(1, token_budget)` mixed, `(max_batch, decode_chunk)`
scan), the host-sync cadence and the zero-post-warmup-recompile
guarantee are structurally untouched whatever policy runs (pinned by
tests/test_policy.py running the parity engine under every policy).

Shipped policies (`POLICIES` registry, `--policy` on mdi-serve /
mdi-server):

- ``fcfs``      — head-of-line admission + admission-order prefill:
                  bit-identical to the pre-policy scheduler.
- ``priority``  — strict priority classes (higher `Request.priority`
                  admits first; FCFS inside a class).  Starvation of low
                  classes under sustained high-class load is the
                  POINT — pair with quotas where that is unacceptable.
- ``fair``      — per-tenant fair share by token accounting: the next
                  slot goes to the waiting tenant with the least served
                  work (prompt + generated tokens, finished AND live),
                  so one tenant flooding the queue cannot starve the
                  others (deficit-style, O(waiting + slots) per pick).
- ``deadline``  — TTFT-SLO-aware: admission is earliest-deadline-first
                  over `Request.ttft_slo_s`, and prefill packing puts
                  the request with the least deadline slack FIRST, so a
                  request about to miss its TTFT SLO takes the step's
                  prefill budget before relaxed ones.  Requests without
                  a deadline rank behind all deadlines, FCFS among
                  themselves.  Prefill chunks already split to the token
                  budget, so this is a pure reordering — no new
                  dispatch shape.

`clock` is injectable (tests drive fake time); production defaults to
`time.monotonic`.  Policies never preempt on their own — preemption
stays the pool-pressure mechanism it was (`Scheduler.preempt_latest`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "SchedulingPolicy",
    "FCFSPolicy",
    "PriorityPolicy",
    "FairSharePolicy",
    "DeadlinePolicy",
    "POLICIES",
    "make_policy",
]


class SchedulingPolicy:
    """Base policy = FCFS semantics; subclasses override the two hooks.

    The scheduler calls, in order, per step:

    - `on_submitted(req)` once at `Scheduler.add` (stamps arrival time);
    - `select_next(waiting, running)` repeatedly while slots are free —
      return an INDEX into `waiting` (the scheduler admits that request
      or, if it does not fit, stops admission for this step: a pick that
      cannot fit blocks the queue rather than being skipped, so block
      accounting stays conservative and a policy bug cannot starve its
      own pick);
    - `order_prefill(prefilling, now)` once per mixed step — return the
      sequences in packing order (first gets budget first);
    - `on_retired(seq)` at retirement (fair-share usage accounting).
    """

    name = "fcfs"

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock

    # -- hooks ---------------------------------------------------------------

    def on_submitted(self, req) -> None:
        if req.arrival_s is None:
            req.arrival_s = self.clock()

    def select_next(self, waiting: Sequence, running: Sequence) -> Optional[int]:
        return 0 if waiting else None

    def order_prefill(self, prefilling: List, now: float) -> List:
        return sorted(prefilling, key=lambda s: s.admit_order)

    def on_retired(self, seq) -> None:
        pass


class FCFSPolicy(SchedulingPolicy):
    """Head-of-line admission, admission-order prefill packing — the
    scheduler's historical behavior, now spelled as a policy."""

    name = "fcfs"


class PriorityPolicy(SchedulingPolicy):
    """Strict priority classes: the highest `Request.priority` waiting
    admits first; FCFS (arrival order) inside a class.  Prefill packing
    follows the same ranking so a high-priority prompt also takes the
    step's prefill budget first."""

    name = "priority"

    def select_next(self, waiting: Sequence, running: Sequence) -> Optional[int]:
        if not waiting:
            return None
        # max priority, then earliest arrival (enumerate index breaks ties
        # by queue position, which IS arrival order within the deque)
        return max(
            range(len(waiting)),
            key=lambda i: (waiting[i].priority, -i),
        )

    def order_prefill(self, prefilling: List, now: float) -> List:
        return sorted(
            prefilling,
            key=lambda s: (-s.req.priority, s.admit_order),
        )


class FairSharePolicy(SchedulingPolicy):
    """Per-tenant fair share by served-token accounting.

    Each tenant's usage = tokens the engine has served on its behalf —
    prompt tokens prefilled plus tokens generated — summed over retired
    requests (accumulated at `on_retired`) AND currently-running ones
    (read live off the slots, so a tenant cannot hide usage in flight).
    The next free slot goes to the waiting request whose tenant has the
    least usage; ties break FCFS.  A tenant that floods the queue only
    ever gets served up to parity with the others — the classic
    starving-tenant scenario is the pinned test.

    Accounting is windowless by default (usage accumulates for the
    frontend's lifetime); `decay(factor)` lets a long-lived server age
    history so a tenant idle for hours is not owed an unbounded debt.
    """

    name = "fair"

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        super().__init__(clock)
        self.usage: Dict[str, float] = {}

    def _live_usage(self, running: Sequence) -> Dict[str, float]:
        live: Dict[str, float] = {}
        for s in running:
            live[s.req.tenant] = (
                live.get(s.req.tenant, 0.0) + s.fed + s.n_generated
            )
        return live

    def select_next(self, waiting: Sequence, running: Sequence) -> Optional[int]:
        if not waiting:
            return None
        live = self._live_usage(running)

        def owed(i: int):
            t = waiting[i].tenant
            return (self.usage.get(t, 0.0) + live.get(t, 0.0), i)

        return min(range(len(waiting)), key=owed)

    def on_retired(self, seq) -> None:
        t = seq.req.tenant
        self.usage[t] = self.usage.get(t, 0.0) + seq.n_prompt + seq.n_generated

    def decay(self, factor: float) -> None:
        """Age the accounting window: usage *= factor (0 <= factor < 1
        forgives history; a periodic 0.5 gives a half-life of one call
        interval).  Host-side O(tenants)."""
        self.usage = {t: u * factor for t, u in self.usage.items() if u * factor > 1e-9}


class DeadlinePolicy(SchedulingPolicy):
    """TTFT-deadline-aware admission and prefill packing (EDF).

    A request with `ttft_slo_s` carries an absolute deadline
    `arrival_s + ttft_slo_s`; admission picks the earliest deadline
    waiting, and prefill packing orders live prefills by remaining slack
    so the step's token budget flows to the request closest to missing
    its TTFT SLO.  Deadline-free requests rank after every deadline,
    FCFS among themselves — a relaxed request can never displace an
    urgent one, but also never starves once no deadlines are pending.
    """

    name = "deadline"

    _FAR = float("inf")

    @staticmethod
    def _deadline(req) -> float:
        if req.ttft_slo_s is None or req.arrival_s is None:
            return DeadlinePolicy._FAR
        return req.arrival_s + req.ttft_slo_s

    def select_next(self, waiting: Sequence, running: Sequence) -> Optional[int]:
        if not waiting:
            return None
        return min(
            range(len(waiting)),
            key=lambda i: (self._deadline(waiting[i]), i),
        )

    def order_prefill(self, prefilling: List, now: float) -> List:
        return sorted(
            prefilling,
            key=lambda s: (self._deadline(s.req) - now, s.admit_order),
        )


POLICIES: Dict[str, type] = {
    "fcfs": FCFSPolicy,
    "priority": PriorityPolicy,
    "fair": FairSharePolicy,
    "deadline": DeadlinePolicy,
}


def make_policy(name: Optional[str],
                clock: Callable[[], float] = time.monotonic) -> SchedulingPolicy:
    """Build a policy by registry name (None/"fcfs" → FCFS).  Raises
    ValueError naming the known policies on an unknown name — the same
    wall `--policy` hits at the CLI."""
    if name is None:
        return FCFSPolicy(clock)
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {name!r}: choose from "
            f"{sorted(POLICIES)}"
        ) from None
    return cls(clock)
