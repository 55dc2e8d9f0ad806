"""Open-system serving front-end over the paged-KV engine.

Port of `mdi_llm_tpu/server/`: turns the replay-a-trace-and-exit
`ServingEngine` into a live system:

- `frontend.ServingFrontend` — the concurrency bridge: the engine loop
  runs in ONE dedicated thread (the only thread that ever touches the
  scheduler, pool or device arrays), arrivals flow through a bounded
  thread-safe submission channel drained at the engine's `step_hook`
  seam, tokens stream out per request through the `stream_cb` seam, and
  backpressure/drain/cancel are first-class.
- `http.ServingHTTPServer` — an asyncio HTTP/1.1 front door over the
  frontend: JSON POST completions with SSE token streaming, 429
  admission backpressure, health/metrics endpoints, graceful drain on
  shutdown.  Stdlib only (asyncio streams).
- `loadgen` — open-loop arrival generation (Poisson, replayed-trace)
  and the offered-load sweep that finds the max QPS meeting a p99
  TTFT/TPOT SLO.
- `explorer` — the deterministic schedule explorer: seeded adversarial
  interleavings through the frontend's yield points, with
  offline-replay token parity as the oracle.

On the card the engine's steps are CUDA graphs captured when the engine
is built, on the building thread; the engine thread only replays them.
Build (and so capture) every step before `start()`: a global-mode
capture while the engine thread runs would also forbid pinned-memory
allocation from every other thread (`utils/profiling.CompileGuard` pins
that no capture happens after warm-up).
"""

from mdi_llm_tpu_torch.server.explorer import (
    ScheduleExplorer,
    doctor_burst,
    run_episode,
)
from mdi_llm_tpu_torch.server.frontend import (
    FrontendClosedError,
    QueueFullError,
    RequestHandle,
    ServingFrontend,
)
from mdi_llm_tpu_torch.server.loadgen import (
    ArrivalSpec,
    OpenLoopRunner,
    poisson_arrivals,
    replay_arrivals,
    sweep_offered_load,
)

__all__ = [
    "ArrivalSpec",
    "FrontendClosedError",
    "OpenLoopRunner",
    "QueueFullError",
    "RequestHandle",
    "ScheduleExplorer",
    "ServingFrontend",
    "doctor_burst",
    "poisson_arrivals",
    "replay_arrivals",
    "run_episode",
    "sweep_offered_load",
]
