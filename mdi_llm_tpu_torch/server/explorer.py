"""A deterministic schedule explorer for `ServingFrontend`.

A copy of `mdi_llm_tpu/server/explorer.py` over the port's frontend.
The JAX package's thread rules prove the locking discipline statically;
this module hammers it dynamically.  `ServingFrontend`
exposes named *yield points* (`frontend._yield_point(tag)`) at every
channel/lock/event seam — one global load each, no-ops in production.
A `ScheduleExplorer` installs a seeded visitor there that perturbs the
thread schedule (short sleeps and forced GIL drops), driving the
submit/cancel/drain/stop threads and the engine thread through
adversarial interleavings that a quiet CI box would otherwise never
produce.

What "deterministic" buys here: each seed fixes the perturbation
stream, so a seed that shakes out a bug keeps applying the same
pressure run after run — failing seeds are committed as regression
fixtures (tests/test_torch_server.py).  The correctness oracle is seed-
independent by design: for every seed, token streams must be identical
to the offline `engine.run()` replay, every handle must complete, and
the frontend must land idle.  (The OS still owns the scheduler, so a
seed replays a pressure pattern, not an exact thread trace.)

Three entry points:

- `ScheduleExplorer` — the seeded visitor; `install()`/`uninstall()` or
  use as a context manager.
- `run_episode()` — one full adversarial episode against a live CPU
  engine: N submitter threads, optional cancels, optional racing
  drain, final drain+stop.  Returns handles/errors for the caller's
  asserts.
- `doctor_burst()` — self-contained short burst on a throwaway tiny
  model on the CPU, JSON-able result, for triaging hosts whose
  concurrency behaviour is broken (exotic GIL builds, pathological
  schedulers).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mdi_llm_tpu_torch.server import frontend as _frontend
from mdi_llm_tpu_torch.server.frontend import RequestHandle, ServingFrontend

__all__ = [
    "ScheduleExplorer",
    "run_episode",
    "doctor_burst",
]


class ScheduleExplorer:
    """Seeded schedule perturbation at the frontend's yield points.

    At each visit the explorer draws from its own `random.Random(seed)`
    (under an internal lock, so the draw sequence is shared across
    threads) and either sleeps a sub-millisecond pause — widening the
    current race window — or calls `time.sleep(0)` to force a GIL drop,
    or falls through untouched.  `record=True` keeps a
    `(thread_name, tag)` trace for debugging a caught seed.
    """

    def __init__(self, seed: int, p_pause: float = 0.35,
                 p_switch: float = 0.35, max_pause_s: float = 0.0008,
                 record: bool = False):
        self.seed = seed
        self.p_pause = p_pause
        self.p_switch = p_switch
        self.max_pause_s = max_pause_s
        self.record = record
        self.visits = 0
        self.trace: List[Tuple[str, str]] = []
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def visit(self, tag: str) -> None:  # mdi-thread: any
        with self._lock:
            self.visits += 1
            roll = self._rng.random()
            pause = self._rng.uniform(0.0, self.max_pause_s)
            if self.record:
                self.trace.append((threading.current_thread().name, tag))
        if roll < self.p_pause:
            time.sleep(pause)
        elif roll < self.p_pause + self.p_switch:
            time.sleep(0)  # drop the GIL: invite a context switch

    # -- installation --------------------------------------------------------

    def install(self) -> "ScheduleExplorer":
        if _frontend._YIELD is not None:
            raise RuntimeError("another schedule explorer is installed")
        _frontend._YIELD = self.visit
        return self

    def uninstall(self) -> None:
        _frontend._YIELD = None

    def __enter__(self) -> "ScheduleExplorer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def run_episode(
    engine,
    trace: Sequence[Tuple[str, Sequence[int], int]],
    seed: int,
    *,
    live: bool = True,
    cancel: Sequence[str] = (),
    drain_race: bool = False,
    submit_threads: int = 2,
    max_queue: Optional[int] = None,
    drain_timeout_s: float = 60.0,
    frontend_cls: Callable[..., ServingFrontend] = ServingFrontend,
    explorer_kwargs: Optional[Dict] = None,
) -> Dict:
    """One seeded adversarial episode against a live CPU engine.

    `trace` is `[(rid, prompt_tokens, max_new_tokens), ...]`.  Requests
    are shuffled across `submit_threads` submitter threads (assignment
    and all structural choices come from the episode seed).  Modes:

    - ``live=False``: every request is submitted BEFORE `start()` — the
      zero-interference shape, where token streams, host-sync counts
      and compile behaviour must be bit-identical to offline
      `engine.run()` whatever the seed does to the submit ordering.
    - ``live=True``: submitters race the running engine thread; with
      `cancel`, a canceller thread cancels those rids as soon as their
      handles exist; with `drain_race=True`, a drainer thread calls
      `drain()` concurrently with the submitters, so arrivals race the
      drain flag (each must deterministically complete OR raise
      `FrontendClosedError` — never hang, never half-admit).

    Returns ``{"handles", "errors", "drained", "frontend", "explorer"}``
    where `errors` maps rid -> raised exception instance for rejected
    submissions.  The frontend is always stopped (and the explorer
    uninstalled) on exit, even when an assert-worthy anomaly occurred.
    """
    rng = random.Random(seed + 1000003)  # structural choices, not pacing
    exp = ScheduleExplorer(seed, **(explorer_kwargs or {}))
    front = frontend_cls(engine, max_queue=max_queue)

    order = list(trace)
    rng.shuffle(order)
    parts: List[List] = [order[i::submit_threads]
                         for i in range(submit_threads)]
    handles: Dict[str, RequestHandle] = {}
    errors: Dict[str, BaseException] = {}
    book = threading.Lock()
    submitted = threading.Event()  # all submitter threads finished

    def submitter(part) -> None:
        for rid, prompt, max_new in part:
            try:
                h = front.submit(prompt, max_new, rid=rid)
            except Exception as e:  # 429/503/400: recorded, not raised
                with book:
                    errors[rid] = e
                continue
            with book:
                handles[rid] = h

    def canceller() -> None:
        for rid in cancel:
            # wait for the handle to exist (or its submit to fail), then
            # cancel — the request may be queued, live, or already done
            while True:
                with book:
                    ready = rid in handles or rid in errors
                if ready or submitted.is_set():
                    break
                time.sleep(0.0002)
            front.cancel(rid)

    def drainer(delay_s: float) -> None:
        time.sleep(delay_s)
        front.drain(timeout=drain_timeout_s)

    threads = [
        threading.Thread(target=submitter, args=(part,),
                         name=f"mdi-submit-{i}", daemon=True)
        for i, part in enumerate(parts) if part
    ]
    if cancel:
        threads.append(threading.Thread(target=canceller,
                                        name="mdi-cancel", daemon=True))
    if drain_race:
        threads.append(threading.Thread(
            target=drainer, args=(rng.uniform(0.0, 0.002),),
            name="mdi-drain", daemon=True))

    drained = False
    with exp:
        try:
            if live:
                front.start()
            for t in threads:
                t.start()
            for t in threads:
                if t.name.startswith("mdi-submit"):
                    t.join()
            submitted.set()
            for t in threads:
                t.join()
            if not live:
                front.start()
            drained = front.drain(timeout=drain_timeout_s)
        finally:
            front.stop(hard=not drained)

    return {
        "handles": handles,
        "errors": errors,
        "drained": drained,
        "frontend": front,
        "explorer": exp,
    }


def doctor_burst(n_seeds: int = 4, n_requests: int = 3,
                 max_new: int = 4) -> Dict:
    """A short self-contained explorer burst.

    Builds a throwaway tiny model on the CPU, replays the same request trace
    offline once for the oracle, then runs `n_seeds` pre-start episodes
    and reports every parity mismatch.  Everything in the result is
    JSON-clean; ``ok`` is the stage's health verdict.
    """
    import numpy as np
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer

    cfg = Config(
        name="doctor-tiny", block_size=64, vocab_size=64,
        padded_vocab_size=64, n_layer=1, n_head=2, n_embd=16,
        n_query_groups=2, rotary_percentage=1.0, parallel_residual=False,
        bias=False, norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP",
        intermediate_size=32,
    )
    params = transformer.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    gen = Generator(cfg, params, cache_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(7)
    trace = [
        (f"d{i}", [int(t) for t in rng.integers(1, cfg.vocab_size, 5)],
         max_new)
        for i in range(n_requests)
    ]

    def fresh_engine():
        return gen.serve(block_size=4, max_batch=n_requests,
                         prefill_chunk=8)

    offline = fresh_engine()
    for rid, prompt, m in trace:
        offline.add_request(rid, prompt, m)
    want, stats = offline.run()

    mismatches: List[Dict] = []
    visits = 0
    for seed in range(n_seeds):
        ep = run_episode(fresh_engine(), trace, seed, live=False)
        visits += ep["explorer"].visits
        if not ep["drained"]:
            mismatches.append({"seed": seed, "rid": None,
                               "why": "drain timed out"})
        for rid, prompt, m in trace:
            h = ep["handles"].get(rid)
            if h is None:
                why = f"submit failed: {ep['errors'].get(rid)!r}"
                mismatches.append({"seed": seed, "rid": rid, "why": why})
            elif h.result != want[rid]:
                mismatches.append({"seed": seed, "rid": rid,
                                   "why": "token stream diverged from "
                                          "offline replay"})
    return {
        "seeds": n_seeds,
        "requests": n_requests,
        "offline_host_syncs": stats.host_syncs,
        "yield_point_visits": visits,
        "mismatches": mismatches,
        "ok": not mismatches,
    }
