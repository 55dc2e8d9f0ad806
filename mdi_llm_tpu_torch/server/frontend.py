"""Thread bridge between an open request stream and the serving engine.

A copy of `mdi_llm_tpu/server/frontend.py` over the port's engine.

`ServingEngine` is single-threaded by contract: the scheduler's host
bookkeeping, the pool free-lists and the donated device arrays all
assume one caller.  `ServingFrontend` keeps that contract while turning
the engine into an open system, by pinning ALL engine work to one
dedicated thread and exchanging data with it only through two seams the
engine already exposes:

- **in**: `submit()` (any thread) appends to a bounded channel under a
  lock; the ENGINE thread drains the channel into `Scheduler.add` at
  every `step_hook` firing and between `run()` calls.  The bound covers
  accepted-but-not-yet-seated work (channel + scheduler waiting queue);
  arrivals past it raise `QueueFullError` — the HTTP layer's 429.
- **out**: the engine's `stream_cb` fires per generated token on the
  engine thread; the frontend routes it to the request's
  `RequestHandle`, which appends host-side and forwards to an optional
  `sink` callable (the HTTP layer passes a
  `loop.call_soon_threadsafe` bridge; tests pass a plain list append).

Zero interference contract (pinned by tests/test_torch_server.py): with every
request submitted before the engine thread starts, the scheduler sees
exactly the sequence of `add` calls a replay would have made, so token
streams, host-sync counts and compile behavior are bit-identical to
`engine.run()` offline — the front-end adds threads around the loop,
never inside it.

Lifecycle: `start()` → serve → `drain()` (stop accepting, let in-flight
finish) → `stop()` (join; with `hard=True` abort the loop at the next
step boundary).  `cancel(rid)` retires a live request at the next step
boundary and completes its handle with the tokens emitted so far.

Concurrency contract: every mutable attribute shared between the
engine thread and submitters is touched only under `self._lock` (the
`mdi-thread` role comments and `mdi-lint` suppressions are the JAX
package's static thread rules, kept as they are).  The `_yield_point()`
calls below are the schedule explorer's seams —
no-ops in production (one global read), but the deterministic schedule
explorer (`server/explorer.py`) installs a seeded scheduler there to
force adversarial interleavings in tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "FrontendClosedError",
    "QueueFullError",
    "RequestHandle",
    "ServingFrontend",
]

#: mdi-race hook: tests install a callable via
#: `server.explorer.ScheduleExplorer.install()`; production never does.
_YIELD: Optional[Callable[[str], None]] = None


def _yield_point(tag: str) -> None:
    """A named interleaving seam.  With no explorer installed this is a
    single global load — zero overhead on the serving path."""
    y = _YIELD
    if y is not None:
        y(tag)


class QueueFullError(RuntimeError):
    """Admission queue at its bound — backpressure (HTTP 429)."""


class FrontendClosedError(RuntimeError):
    """Frontend draining or stopped — no new work (HTTP 503)."""


class _HardStop(Exception):
    """Raised from the step hook to abort `engine.run` mid-queue."""


class RequestHandle:
    """One submitted request's streaming state and completion latch.

    `tokens` grows on the ENGINE thread; `done` is a `threading.Event`
    any thread may wait on.  `sink(event)` — when given — is called on
    the engine thread with `("token", tok)`, then exactly one of
    `("done", result_tokens)` / `("cancelled", tokens_so_far)` /
    `("error", message)`; sinks must be cheap and non-blocking (the HTTP
    layer hands a threadsafe asyncio bridge, never a direct writer).
    """

    def __init__(self, rid: str, n_prompt: int, max_new_tokens: int,
                 sink: Optional[Callable[[Tuple], None]] = None):
        self.rid = rid
        self.n_prompt = n_prompt
        self.max_new_tokens = max_new_tokens
        self.tokens: List[int] = []
        self.result: Optional[List[int]] = None  # prompt + kept generation
        self.error: Optional[str] = None
        self.cancelled = False
        self.done = threading.Event()
        self.submitted_s = time.perf_counter()
        self._sink = sink

    def _event(self, kind: str, payload) -> None:  # mdi-thread: engine
        if self._sink is not None:
            self._sink((kind, payload))

    def _on_token(self, tok: int) -> None:  # mdi-thread: engine
        # single writer (engine thread); mid-flight readers get a
        # GIL-atomic snapshot of streaming progress by design
        # mdi-lint: disable-next-line=unguarded-shared-state -- lock-free by design, see above
        self.tokens.append(tok)
        self._event("token", tok)

    def _complete(self, result: List[int]) -> None:  # mdi-thread: engine
        # written once, strictly before done.set(): Event.set()/wait()
        # is the publication barrier readers synchronize on
        # mdi-lint: disable-next-line=unguarded-shared-state -- published via done Event, see above
        self.result = result
        self._event("done", result)
        self.done.set()

    def _cancel(self) -> None:  # mdi-thread: engine
        self.cancelled = True
        self._event("cancelled", list(self.tokens))
        self.done.set()

    def _fail(self, msg: str) -> None:  # mdi-thread: engine
        self.error = msg
        self._event("error", msg)
        self.done.set()

    def generated(self) -> List[int]:  # mdi-thread: any
        """Kept generated tokens: the stop-trimmed result suffix once
        finished, else the stream so far."""
        if self.result is not None:
            return self.result[self.n_prompt:]
        return list(self.tokens)


class ServingFrontend:
    """Open-system front door for one `ServingEngine`.

    Build from a fresh engine (nothing queued), `start()` the engine
    thread, `submit()` from any thread, `drain()`/`stop()` to land it::

        front = ServingFrontend(gen.serve(max_batch=8, obs=obs))
        front.start()
        h = front.submit(prompt_tokens, max_new_tokens=64)
        h.done.wait()
        front.drain(); front.stop()

    `max_queue` bounds accepted-but-unseated requests (None → the
    engine config's `resolved_admission_queue()`, 4 × max_batch).
    """

    #: engine-thread idle wait between wake checks (seconds); the wake
    #: event short-circuits it on every submit/drain/stop
    IDLE_WAIT_S = 0.05

    def __init__(self, engine, max_queue: Optional[int] = None):
        self.engine = engine
        self.max_queue = (
            int(max_queue) if max_queue is not None
            else engine.cfg.resolved_admission_queue()
        )
        if self.max_queue < 1:
            raise ValueError(
                f"max_queue {self.max_queue} must be >= 1: a server that "
                "can never accept a request serves nothing (mdi-audit: "
                "bad-server-config)"
            )
        self._lock = threading.Lock()
        self._channel: List[Tuple] = []  # (handle, request kwargs)
        self._handles: Dict[str, RequestHandle] = {}  # live (unfinished)
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._draining = False
        self._stopped = False
        self._hard_stop = False
        self._cancels: List[str] = []
        self._rid_counter = 0
        self._offered = 0  # accepted + rejected arrivals
        self._t_first: Optional[float] = None

    # -- submission side (any thread) ----------------------------------------

    def queue_depth(self) -> int:
        """Accepted-but-not-yet-seated requests: the submission channel
        plus the scheduler's waiting queue.  `len()` on both is a GIL
        atomic read and the count is only used for admission control, so
        a stale-by-one view is acceptable by design.  MUST stay lock-free:
        `submit()` calls it while already holding the non-reentrant
        `self._lock`."""
        # mdi-lint: disable-next-line=unguarded-shared-state -- GIL-atomic len(); locking here would deadlock submit()
        return len(self._channel) + len(self.engine.scheduler.waiting)

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        rid: Optional[str] = None,
        stop_sequences: Sequence[Sequence[int]] = (),
        priority: int = 0,
        tenant: str = "",
        ttft_slo_s: Optional[float] = None,
        sink: Optional[Callable[[Tuple], None]] = None,
    ) -> RequestHandle:
        """Accept one request or raise: `ValueError` for requests that can
        never fit (the scheduler's add-time wall, checked HERE so the
        caller gets it synchronously — HTTP 400), `QueueFullError` at the
        admission bound (429), `FrontendClosedError` when draining or
        stopped (503)."""
        from mdi_llm_tpu_torch.serving.scheduler import Request

        prompt = [int(t) for t in prompt]
        _yield_point("submit:enter")
        with self._lock:
            # the closed check comes FIRST: an arrival that loses the
            # race with drain() gets a deterministic 503 with zero side
            # effects — it is not offered load against a closed server
            # (pinned by the drain-window explorer seeds)
            if self._draining or self._stopped:
                raise FrontendClosedError(
                    "frontend is draining/stopped; not accepting requests"
                )
            now = time.perf_counter()
            if self._t_first is None:
                self._t_first = now
            self._offered += 1
            elapsed = max(now - self._t_first, 1e-9)
            # offered-rate-so-far: arrivals (accepted + rejected) per
            # second since the first one — the denominator of every
            # open-system claim; replay runs never touch it
            self.engine.stats.offered_qps = (
                self._offered / elapsed if self._offered > 1 else 0.0
            )
            if rid is None:
                rid = f"req{self._rid_counter}"
                self._rid_counter += 1
            if rid in self._handles:
                raise ValueError(f"request id {rid!r} already in flight")
            req = Request(
                rid=rid, prompt=prompt,
                max_new_tokens=int(max_new_tokens),
                stop_sequences=stop_sequences, priority=int(priority),
                tenant=str(tenant), ttft_slo_s=ttft_slo_s,
            )
            # feasibility wall BEFORE the bound check: an impossible
            # request is a 400, not a 429, and must not count as load
            self.engine.scheduler.validate(req)
            if self.queue_depth() >= self.max_queue:
                self.engine.stats.requests_rejected += 1
                if self.engine.obs is not None:
                    self.engine.obs.request_rejected(rid)
                raise QueueFullError(
                    f"admission queue full ({self.max_queue} waiting); "
                    "retry later"
                )
            handle = RequestHandle(rid, len(prompt), int(max_new_tokens),
                                   sink=sink)
            self._handles[rid] = handle
            self._channel.append((handle, req))
        _yield_point("submit:queued")
        self._wake.set()
        return handle

    def cancel(self, rid: str) -> bool:
        """Request cancellation (client went away): queued requests drop
        before admission, live ones retire at the next step boundary,
        keeping the tokens already generated.  Returns False for unknown/
        finished rids.  The handle completes via its "cancelled" event."""
        _yield_point("cancel:enter")
        with self._lock:
            if rid not in self._handles:
                return False
            self._cancels.append(rid)
        _yield_point("cancel:queued")
        self._wake.set()
        return True

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._thread = threading.Thread(
            target=self._pump, name="mdi-serving-engine", daemon=True
        )
        self._thread.start()
        return self

    @property
    def idle(self) -> bool:
        """No channel entries, no scheduler work, no live handles."""
        with self._lock:
            return (
                not self._channel
                and not self.engine.scheduler.has_work
                and not self._handles
            )

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop accepting (submit → FrontendClosedError),
        let everything in flight finish.  Returns True when idle within
        `timeout` (None = wait forever)."""
        _yield_point("drain:enter")
        with self._lock:
            self._draining = True
        _yield_point("drain:flagged")
        self._wake.set()
        deadline = None if timeout is None else time.perf_counter() + timeout
        while not self.idle:
            if self._thread is None or not self._thread.is_alive():
                break
            if deadline is not None and time.perf_counter() > deadline:
                return False
            time.sleep(0.01)
        return self.idle

    def stop(self, hard: bool = False) -> None:
        """Stop the engine thread.  `hard=True` aborts at the next step
        boundary, failing unfinished handles; the default lets the
        current `run()` finish its queue first (call `drain()` before
        `stop()` for a clean shutdown)."""
        _yield_point("stop:enter")
        with self._lock:
            self._stopped = True
            self._draining = True
            self._hard_stop = self._hard_stop or hard
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)

    # -- engine thread -------------------------------------------------------

    def _drain_channel(self) -> None:
        """ENGINE THREAD: hand queued submissions to the scheduler.  The
        channel entry was validated at submit time, so add() can only
        fail on a racing geometry change — fail the handle, not the
        loop."""
        _yield_point("engine:drain-channel")
        with self._lock:
            batch, self._channel = self._channel, []
        for handle, req in batch:
            try:
                self.engine.scheduler.add(req)
            except ValueError as e:  # pragma: no cover - validated at submit
                with self._lock:
                    self._handles.pop(handle.rid, None)
                handle._fail(str(e))

    def _apply_cancels(self) -> None:
        """ENGINE THREAD: drop queued / retire live cancelled requests."""
        _yield_point("engine:cancels")
        with self._lock:
            cancels, self._cancels = self._cancels, []
            # snapshot the handles in the same critical section as the
            # swap: a lone `_handles.get` outside it races submit/collect
            handles = {rid: self._handles.get(rid) for rid in cancels}
        if not cancels:
            return
        sched = self.engine.scheduler
        for rid in cancels:
            handle = handles.get(rid)
            if handle is None:
                continue
            # not yet handed over: drop from the channel
            with self._lock:
                for i, (h, _req) in enumerate(self._channel):
                    if h.rid == rid:
                        del self._channel[i]
                        break
            # waiting in the scheduler: remove before admission
            for i, req in enumerate(sched.waiting):
                if req.rid == rid:
                    del sched.waiting[i]
                    break
            for i, (req, _toks) in enumerate(sched.preempted):
                if req.rid == rid:
                    del sched.preempted[i]
                    # host tier: a swapped-out entry also holds host slots
                    sched.drop_swap_record(rid)
                    break
            # live in a slot: retire, releasing its blocks
            for seq in sched.running():
                if seq.req.rid == rid:
                    sched.retire(seq)
                    self.engine.pop_result(rid)  # retire() never filled it
                    break
            with self._lock:
                self._handles.pop(rid, None)
            handle._cancel()

    def _collect_finished(self) -> None:
        """ENGINE THREAD: complete handles whose requests retired."""
        _yield_point("engine:collect")
        with self._lock:
            live = list(self._handles.items())
        for rid, handle in live:
            result = self.engine.pop_result(rid)
            if result is not None:
                with self._lock:
                    self._handles.pop(rid, None)
                handle._complete(result)
        # the scheduler's finished list is write-only bookkeeping for the
        # replay path; a long-lived server must not let it grow forever
        self.engine.scheduler.finished.clear()

    def _on_token(self, rid: str, tok: int) -> None:
        _yield_point("engine:token")
        with self._lock:
            handle = self._handles.get(rid)
        if handle is not None:
            handle._on_token(tok)

    def _on_step(self, _i: int) -> None:
        """The engine's `step_hook` seam: admissions, cancellations and
        completions all land here, ON the engine thread, BETWEEN steps —
        exactly where the replay loop does its own scheduler work."""
        self._apply_cancels()
        self._drain_channel()
        self._collect_finished()
        with self._lock:
            hard = self._hard_stop
        if hard:
            raise _HardStop

    def _pump(self) -> None:
        eng = self.engine
        try:
            while True:
                self._apply_cancels()
                self._drain_channel()
                if eng.scheduler.has_work:
                    try:
                        eng.run(stream_cb=self._on_token,
                                step_hook=self._on_step)
                    except _HardStop:
                        break  # unfinished handles fail in the finally
                    self._collect_finished()
                    continue
                with self._lock:
                    should_exit = self._stopped or (
                        self._draining and not self._channel
                        and not self._handles
                    )
                if should_exit:
                    break
                self._wake.wait(self.IDLE_WAIT_S)
                self._wake.clear()
        except Exception as e:  # engine died: fail every live handle
            msg = f"{type(e).__name__}: {e}"
            with self._lock:
                dead = list(self._handles.values())
                self._handles.clear()
            for handle in dead:
                handle._fail(msg)
            raise
        finally:
            self._collect_finished()
            with self._lock:
                orphans = list(self._handles.values())
                self._handles.clear()
            for handle in orphans:
                handle._fail("frontend stopped before completion")
