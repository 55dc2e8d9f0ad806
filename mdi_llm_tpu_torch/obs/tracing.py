"""Request-lifecycle + engine-step tracing over a bounded ring buffer.

A copy of `mdi_llm_tpu/obs/tracing.py` (host-only Python).

The timeline half of the serving observability layer (`obs/`): a
`TraceRecorder` captures two event families —

- **request lifecycle**: submitted → admitted → prefill chunk(s) → first
  token → decode/verify → retired | preempted → resumed, one
  `RequestTiming` per request carrying the timestamps the latency
  metrics derive from (TTFT, TPOT, E2E, queue-wait);
- **engine steps**: every mixed/decode-chunk/verify dispatch as a span
  with its packed token width and live-lane count.

Timestamp contract (the reason this is a serving feature, not a logger):
every timestamp is taken on the HOST at a boundary the engine already
synchronizes at — request queue operations (pure host bookkeeping) and
the one host read each step already performs.  Recording never
touches a device tensor, adds no host syncs, and captures no graph
(pinned by tests/test_torch_obs.py's captures guard + host_syncs test).

Memory contract: the event ring and the completed-request ring are both
`deque(maxlen=...)` — a long-lived engine holds O(ring) trace state no
matter how many requests flow through; only LIVE requests keep an open
`RequestTiming` outside the rings.

Readers on other threads (the HTTP server's `/v1/stats` while the engine
thread serves) iterate snapshots of the rings, `list(deque)`, taken in
one step under the GIL: iterating a deque that another thread appends to
raises "deque mutated during iteration" (the JAX package's recorder
iterates the live deque; tests/test_torch_obs.py pins the difference).

Export: `to_chrome_trace()` emits Chrome Trace Event JSON (the
`traceEvents` array format) loadable in Perfetto (https://ui.perfetto.dev)
or chrome://tracing.  Requests render as one track each — track rank ==
scheduler admission order — with a complete-event span from admission to
retirement and instant events for the lifecycle edges; engine steps
render on a separate process track.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Deque, Dict, List, Optional

__all__ = ["RequestTiming", "TraceRecorder"]

# Chrome trace pid lanes (arbitrary ids; named via metadata events)
_PID_REQUESTS = 1
_PID_ENGINE = 2


@dataclass
class RequestTiming:
    """One request's lifecycle timestamps (seconds on the recorder clock).

    Derived latencies (`None` until the inputs exist):

    - queue_wait  = admitted - submitted         (first admission)
    - ttft        = first_token - submitted      (time to first token)
    - tpot        = (last_token - first_token) / (n_tokens - 1)
                                                 (steady decode cadence)
    - e2e         = finished - submitted
    """

    rid: str
    submitted_ts: float
    n_prompt: int = 0
    max_new_tokens: int = 0
    admitted_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    last_token_ts: Optional[float] = None
    finished_ts: Optional[float] = None
    n_tokens: int = 0
    prefill_chunks: int = 0
    preemptions: int = 0
    admit_order: int = -1
    slot: int = -1

    @property
    def queue_wait(self) -> Optional[float]:
        if self.admitted_ts is None:
            return None
        return self.admitted_ts - self.submitted_ts

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submitted_ts

    @property
    def tpot(self) -> Optional[float]:
        if self.first_token_ts is None or self.n_tokens < 2:
            return None
        return (self.last_token_ts - self.first_token_ts) / (self.n_tokens - 1)

    @property
    def e2e(self) -> Optional[float]:
        if self.finished_ts is None:
            return None
        return self.finished_ts - self.submitted_ts

    def to_dict(self) -> Dict[str, object]:
        return {
            "rid": self.rid,
            "admit_order": self.admit_order,
            "n_prompt": self.n_prompt,
            "n_tokens": self.n_tokens,
            "prefill_chunks": self.prefill_chunks,
            "preemptions": self.preemptions,
            "queue_wait_s": self.queue_wait,
            "ttft_s": self.ttft,
            "tpot_s": self.tpot,
            "e2e_s": self.e2e,
        }


class TraceRecorder:
    """Bounded ring of trace events + per-request timing records.

    `clock` is injectable (tests drive a fake clock; production uses
    `time.perf_counter`).  All mutating methods are plain host-side
    appends/dict writes — no locks (the serving loop is single-threaded),
    no device access, O(1) per call.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = capacity
        self.clock = clock
        # event ring: dicts already shaped like Chrome trace events, with
        # ts in recorder-clock SECONDS (export converts to relative µs)
        self.events: Deque[Dict] = deque(maxlen=capacity)
        # completed-request ring: the window percentile metrics read
        self.completed: Deque[RequestTiming] = deque(maxlen=capacity)
        # open requests: submitted/admitted but not yet retired (bounded by
        # requests in flight through the system, not by traffic history)
        self.open: Dict[str, RequestTiming] = {}
        self.t0 = clock()  # trace epoch: export rebases ts to this
        self.dropped = 0  # events pushed out of the ring (bounding proof)

    # -- low-level event append ---------------------------------------------

    def _push(self, ev: Dict) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    def instant(self, name: str, ts: float, pid: int, tid: int,
                args: Optional[Dict] = None) -> None:
        self._push({"name": name, "ph": "i", "ts": ts, "pid": pid,
                    "tid": tid, "s": "t", "args": args or {}})

    def span(self, name: str, ts: float, dur: float, pid: int, tid: int,
             args: Optional[Dict] = None) -> None:
        self._push({"name": name, "ph": "X", "ts": ts, "dur": max(0.0, dur),
                    "pid": pid, "tid": tid, "args": args or {}})

    # -- request lifecycle ---------------------------------------------------

    def request_submitted(self, rid: str, n_prompt: int,
                          max_new_tokens: int) -> None:
        now = self.clock()
        self.open[rid] = RequestTiming(
            rid=rid, submitted_ts=now, n_prompt=n_prompt,
            max_new_tokens=max_new_tokens,
        )
        self.instant("submitted", now, _PID_REQUESTS, 0, {"rid": rid})

    def request_admitted(self, rid: str, slot: int, admit_order: int,
                         n_cached: int = 0, resumed: bool = False,
                         restored: bool = False) -> None:
        now = self.clock()
        t = self.open.get(rid)
        if t is None:  # admitted without a submit record: synthesize one
            t = RequestTiming(rid=rid, submitted_ts=now)
            self.open[rid] = t
        if t.admitted_ts is None:
            t.admitted_ts = now  # queue-wait measures the FIRST admission
            t.admit_order = admit_order
        t.slot = slot
        # host-tier resumes (serving/host_tier.py) render as their own
        # lifecycle edge: the KV came back from host slots, not re-prefill
        name = ("resumed_restored" if restored
                else "resumed" if resumed else "admitted")
        self.instant(name, now,
                     _PID_REQUESTS, max(0, t.admit_order),
                     {"rid": rid, "slot": slot, "admit_order": admit_order,
                      "prefix_cached_tokens": n_cached})

    def request_preempted(self, rid: str, n_generated: int,
                          swapped: bool = False) -> None:
        now = self.clock()
        t = self.open.get(rid)
        if t is not None:
            t.preemptions += 1
        self.instant("preempted_swapped" if swapped else "preempted",
                     now, _PID_REQUESTS,
                     max(0, t.admit_order) if t else 0,
                     {"rid": rid, "n_generated": n_generated})

    def prefill_chunk(self, rid: str, n_tokens: int, ts: float) -> None:
        t = self.open.get(rid)
        if t is not None:
            t.prefill_chunks += 1
        self.instant("prefill_chunk", ts, _PID_REQUESTS,
                     max(0, t.admit_order) if t else 0,
                     {"rid": rid, "n_tokens": n_tokens})

    def tokens(self, rid: str, n: int, ts: float) -> None:
        """Credit `n` generated tokens at host-sync time `ts` (one stamp
        per sync, shared by every token drained at that boundary)."""
        t = self.open.get(rid)
        if t is None:
            return
        if t.first_token_ts is None:
            t.first_token_ts = ts
            self.instant("first_token", ts, _PID_REQUESTS,
                         max(0, t.admit_order), {"rid": rid})
        t.last_token_ts = ts
        t.n_tokens += n

    def request_finished(self, rid: str, ts: Optional[float] = None) -> None:
        t = self.open.pop(rid, None)
        if t is None:
            return
        t.finished_ts = self.clock() if ts is None else ts
        self.completed.append(t)
        start = t.admitted_ts if t.admitted_ts is not None else t.submitted_ts
        self.span(
            rid, start, t.finished_ts - start, _PID_REQUESTS,
            max(0, t.admit_order),
            {"admit_order": t.admit_order, "n_prompt": t.n_prompt,
             "n_tokens": t.n_tokens, "preemptions": t.preemptions,
             "ttft_s": t.ttft, "tpot_s": t.tpot,
             "queue_wait_s": t.queue_wait},
        )

    # -- engine steps --------------------------------------------------------

    def step(self, kind: str, t_start: float, t_end: float, width: int,
             live: int, extra: Optional[Dict] = None) -> None:
        """One engine dispatch span: `kind` in {mixed, decode,
        decode_chunk, verify}, `width` the packed device token-axis
        positions, `live` the lanes that carried a real sequence."""
        args = {"packed_width": width, "live_lanes": live}
        if extra:
            args.update(extra)
        self.span(kind, t_start, t_end - t_start, _PID_ENGINE, 0, args)

    # -- latency windows -----------------------------------------------------

    def latencies(self) -> Dict[str, List[float]]:
        """Per-metric value lists over the completed-request window (the
        inputs to `metrics.latency_summary`)."""
        out: Dict[str, List[float]] = {
            "ttft_s": [], "tpot_s": [], "e2e_s": [], "queue_wait_s": [],
        }
        for t in list(self.completed):
            if t.ttft is not None:
                out["ttft_s"].append(t.ttft)
            if t.tpot is not None:
                out["tpot_s"].append(t.tpot)
            if t.e2e is not None:
                out["e2e_s"].append(t.e2e)
            if t.queue_wait is not None:
                out["queue_wait_s"].append(t.queue_wait)
        return out

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self) -> Dict:
        """Chrome Trace Event JSON: ts/dur in MICROSECONDS rebased to the
        trace epoch, request tracks sorted by admission order, still-open
        requests exported as spans up to "now" so a live engine snapshot
        is viewable too."""
        now = self.clock()
        events: List[Dict] = [
            {"name": "process_name", "ph": "M", "pid": _PID_REQUESTS,
             "tid": 0, "args": {"name": "requests"}},
            {"name": "process_name", "ph": "M", "pid": _PID_ENGINE,
             "tid": 0, "args": {"name": "engine steps"}},
        ]
        # request tracks: name + explicit sort rank == admission order
        tracks: Dict[int, str] = {}
        for t in list(self.completed) + list(self.open.values()):
            if t.admit_order >= 0:
                tracks[t.admit_order] = t.rid
        for order in sorted(tracks):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": _PID_REQUESTS, "tid": order,
                           "args": {"name": f"{order:04d} {tracks[order]}"}})
            events.append({"name": "thread_sort_index", "ph": "M",
                           "pid": _PID_REQUESTS, "tid": order,
                           "args": {"sort_index": order}})

        def us(ts: float) -> float:
            return round((ts - self.t0) * 1e6, 3)

        for ev in list(self.events):
            out = dict(ev)
            out["ts"] = us(out["ts"])
            if "dur" in out:
                out["dur"] = round(out["dur"] * 1e6, 3)
            events.append(out)
        # still-open requests: partial spans so the snapshot renders
        for t in list(self.open.values()):
            if t.admitted_ts is None:
                continue
            events.append({
                "name": t.rid, "ph": "X", "ts": us(t.admitted_ts),
                "dur": round((now - t.admitted_ts) * 1e6, 3),
                "pid": _PID_REQUESTS, "tid": max(0, t.admit_order),
                "args": {"admit_order": t.admit_order, "open": True,
                         "n_tokens": t.n_tokens},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"ring_capacity": self.capacity,
                              "events_dropped": self.dropped}}

    def write_chrome_trace(self, path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_chrome_trace()) + "\n")
