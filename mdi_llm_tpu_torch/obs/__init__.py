"""Serving observability: metrics, request tracing, latency percentiles.

Port of `mdi_llm_tpu/obs/__init__.py`.  `ServingObserver` is the one
object the serving stack talks to — build it, pass it to
`Generator.serve(obs=...)` (or `ServingEngine` directly), and the
engine/scheduler feed it at the host-sync boundaries they already own:

    from mdi_llm_tpu_torch.obs import ServingObserver

    obs = ServingObserver()
    engine = gen.serve(block_size=16, max_batch=8, obs=obs)
    ...
    results, stats = engine.run()
    json.dump(obs.metrics_dict(stats), open("metrics.json", "w"))
    obs.tracer.write_chrome_trace("trace.json")     # open in Perfetto

It bundles four parts:

- `obs.metrics`  — `MetricsRegistry`: counters/gauges/fixed-bucket
  histograms with JSON + Prometheus exposition (`obs/metrics.py`);
- `obs.tracer`   — `TraceRecorder`: bounded ring of request-lifecycle
  and engine-step events, Chrome-trace/Perfetto export
  (`obs/tracing.py`);
- latency derivation — per-request TTFT/TPOT/E2E/queue-wait over the
  completed-request window, aggregated to p50/p95/p99
  (`latency_summary`);
- `obs.device`   — `DeviceReportRegistry`: one `ExecutableReport` per
  captured step (`obs/device.py`: counted FLOPs, input/output/pool
  bytes, the graph's private pool).  Pass `device=True` to CAPTURE (when
  the engine is built); the default observer still RECEIVES reports
  captured earlier on the same Generator.

Overhead contract (pinned by tests/test_torch_obs.py): every hook is a
plain host-side append called outside the captured step bodies, after
the step's one host read — enabling the observer adds ZERO host syncs,
ZERO device ops and ZERO graph captures to a serving run, and holds
O(ring) memory however long the engine lives.  Timestamps are taken once
per host-sync boundary and shared by everything drained there.

Metric names: every `serving_*` name is the JAX observer's.  The
JAX-named ones are renamed (`JAX_NAMES` maps each port name to the JAX
one(s)):

- `jax_jit_traces_total` and `jax_backend_compiles_total` (jit cache
  misses, XLA compiles) become one counter, `graph_captures_total`
  (StepGraph captures while the engine runs);
- the `xla_<label>_{flops,bytes_accessed,temp_bytes}` gauges become
  `step_<label>_{flops,bytes_accessed,temp_bytes}`.

The host-tier hooks (`tier_swap_out`, `tier_swap_in`, `restore_wait`)
are the JAX observer's: the engine calls them as it queues a swap-out,
as it restores a swapped victim or a spilled prefix block
(`serving/host_tier.py`).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Dict, Optional

from mdi_llm_tpu_torch.obs.device import DeviceReportRegistry, ExecutableReport
from mdi_llm_tpu_torch.obs.metrics import (
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    latency_summary,
    percentiles,
)
from mdi_llm_tpu_torch.obs.tracing import RequestTiming, TraceRecorder

__all__ = [
    "Counter",
    "DeviceReportRegistry",
    "ExecutableReport",
    "Gauge",
    "Histogram",
    "JAX_NAMES",
    "MetricsRegistry",
    "RequestTiming",
    "ServingObserver",
    "TraceRecorder",
    "LATENCY_BUCKETS_S",
    "latency_summary",
    "percentiles",
]

LATENCY_METRICS = ("ttft_s", "tpot_s", "e2e_s", "queue_wait_s")

# host-tier restore-issue wait histogram bounds, in MILLISECONDS (restores
# are issued at host-sync boundaries and run behind the next step, so the
# interesting range sits well under the request-latency buckets)
RESTORE_WAIT_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0,
)

# port metric name (or prefix) -> the JAX observer's name(s) for it
JAX_NAMES = {
    "graph_captures_total": ("jax_jit_traces_total", "jax_backend_compiles_total"),
    "step_": ("xla_",),
}


class ServingObserver:
    """Observability hub for one serving engine (or several sharing it).

    `clock` is injectable for deterministic tests; `ring` bounds both the
    trace-event and completed-request windows; `rss_interval_s` (None =
    off) samples the host process tree's RSS via
    `cli.mem_monitor.sample_rss` at most once per interval, at sync
    boundaries only (`cli.serve --sample-rss`).  `device=True` enables
    step CAPTURE (`obs/device.py`): the engine measures each step once,
    when it is built, caching reports on its Generator — the default
    (False) observer never measures but still receives reports already
    cached there.
    """

    def __init__(self, ring: int = 65536,
                 clock: Callable[[], float] = time.perf_counter,
                 rss_interval_s: Optional[float] = None,
                 device: bool = False):
        self.clock = clock
        self.metrics = MetricsRegistry()
        self.device = DeviceReportRegistry(capture_enabled=device)
        self.tracer = TraceRecorder(capacity=ring, clock=clock)
        self.rss_interval_s = rss_interval_s
        self._last_rss_ts: Optional[float] = None
        self._rss_peak = 0
        self._rss_broken = False  # psutil missing/unusable: warn once
        self._now: Optional[float] = None  # last host-sync stamp
        self._capture_hook = None
        # pre-register the latency histograms so an idle engine still
        # exposes the full catalog
        for name in LATENCY_METRICS:
            self.metrics.histogram(
                f"serving_request_{name.replace('_s', '_seconds')}",
                f"per-request {name[:-2].replace('_', ' ')} distribution",
            )

    # -- host-sync boundary --------------------------------------------------

    @property
    def now(self) -> float:
        """The last sync-boundary stamp (falls back to the clock so
        lifecycle hooks fired outside a step still get a timestamp)."""
        return self._now if self._now is not None else self.clock()

    def step(self, kind: str, width: int, live: int,
             t_start: Optional[float] = None,
             kv_utilization: Optional[float] = None,
             queue_depth: Optional[int] = None,
             **extra) -> float:
        """Record one engine step at its host-sync boundary: stamps "now"
        ONCE (all tokens/retirements drained at this boundary share it),
        appends the step span, and refreshes the step gauges.  Returns the
        stamp."""
        prev = self._now
        now = self.clock()
        self._now = now
        start = t_start if t_start is not None else (prev if prev is not None else now)
        self.tracer.step(kind, start, now, width, live, extra or None)
        m = self.metrics
        m.counter("serving_steps_total",
                  "engine dispatches (all kinds)").inc()
        m.counter(f"serving_steps_{kind}_total",
                  f"{kind} dispatches").inc()
        m.counter("serving_host_syncs_total",
                  "host reads of device results").inc()
        m.counter("serving_tokens_dispatched_total",
                  "device token-axis positions computed").inc(width)
        m.gauge("serving_live_lanes", "slots carrying a sequence").set(live)
        if kv_utilization is not None:
            m.gauge("serving_kv_utilization",
                    "fraction of pool blocks held by live sequences"
                    ).set(kv_utilization)
            peak = m.gauge("serving_kv_utilization_peak",
                           "high-water pool utilization")
            peak.set(max(peak.value, kv_utilization))
        if queue_depth is not None:
            m.gauge("serving_queue_depth",
                    "requests waiting or preempted").set(queue_depth)
        self._maybe_sample_rss(now)
        return now

    def _maybe_sample_rss(self, now: float) -> None:
        if self.rss_interval_s is None or self._rss_broken:
            return
        if (self._last_rss_ts is not None
                and now - self._last_rss_ts < self.rss_interval_s):
            return
        self._last_rss_ts = now
        try:
            from mdi_llm_tpu_torch.cli.mem_monitor import sample_rss

            rss = sample_rss(os.getpid())
        except Exception as exc:  # psutil missing: no gauge, one warning
            self._rss_broken = True
            print(f"ServingObserver: RSS sampling off ({type(exc).__name__}: "
                  f"{exc}); host_rss_bytes is not reported", file=sys.stderr)
            return
        self._rss_peak = max(self._rss_peak, rss)
        self.metrics.gauge("host_rss_bytes",
                           "process-tree resident set size").set(rss)
        self.metrics.gauge("host_rss_peak_bytes",
                           "high-water process-tree RSS").set(self._rss_peak)

    # -- request lifecycle (scheduler/engine hooks) --------------------------

    def request_submitted(self, rid: str, n_prompt: int,
                          max_new_tokens: int) -> None:
        self.tracer.request_submitted(rid, n_prompt, max_new_tokens)
        self.metrics.counter("serving_requests_submitted_total",
                             "requests queued").inc()

    def request_admitted(self, rid: str, slot: int, admit_order: int,
                         n_cached: int = 0, resumed: bool = False,
                         restored: bool = False) -> None:
        self.tracer.request_admitted(rid, slot, admit_order,
                                     n_cached=n_cached, resumed=resumed,
                                     restored=restored)
        name = ("serving_requests_resumed_total" if resumed
                else "serving_requests_admitted_total")
        self.metrics.counter(name, "admissions into decode slots").inc()
        if restored:
            self.metrics.counter("serving_requests_restored_total",
                                 "resumes served from host-tier swap "
                                 "payloads (zero re-prefill)").inc()
        if n_cached and not restored:
            self.metrics.counter("serving_prefix_cached_tokens_total",
                                 "prompt tokens served from the prefix "
                                 "cache").inc(n_cached)

    def request_rejected(self, rid: str) -> None:
        """Open-system backpressure: an arrival bounced at the admission
        queue bound (server/frontend.py → HTTP 429).  Counter only — a
        rejected request never opens a timing record, so the latency
        percentiles describe SERVED traffic."""
        self.metrics.counter("serving_requests_rejected_total",
                             "arrivals rejected by admission "
                             "backpressure").inc()

    def request_preempted(self, rid: str, n_generated: int,
                          swapped: bool = False) -> None:
        self.tracer.request_preempted(rid, n_generated, swapped=swapped)
        self.metrics.counter("serving_preemptions_total",
                             "recompute-style preemptions").inc()
        if swapped:
            self.metrics.counter("serving_preemptions_swapped_total",
                                 "preemptions resolved by host-tier swap "
                                 "instead of recompute").inc()

    # -- host-tier transfers (serving/host_tier.py) --------------------------

    def tier_swap_out(self, n_blocks: int, nbytes: int) -> None:
        """One victim's blocks gathered toward host slots (bytes counted
        at issue time; the copies are waited for at a later sync
        boundary)."""
        self.metrics.counter("serving_swap_out_bytes_total",
                             "KV bytes swapped HBM → host").inc(nbytes)
        self.metrics.counter("serving_swap_out_blocks_total",
                             "KV blocks swapped HBM → host").inc(n_blocks)

    def tier_swap_in(self, n_blocks: int, nbytes: int) -> None:
        self.metrics.counter("serving_swap_in_bytes_total",
                             "KV bytes restored host → HBM").inc(nbytes)
        self.metrics.counter("serving_swap_in_blocks_total",
                             "KV blocks restored host → HBM").inc(n_blocks)

    def restore_wait(self, seconds: float) -> None:
        """Host time spent issuing one restore (staging read, upload and
        in-place write queued: the part not hidden behind the next step)."""
        self.metrics.histogram(
            "serving_restore_wait_ms",
            "host-side wait per host→HBM restore issue",
            buckets=RESTORE_WAIT_BUCKETS_MS,
        ).observe(seconds * 1e3)

    def spec(self, drafted: int, accepted: int, source: str) -> None:
        """One lane's speculative verify outcome, split by draft source
        (``"ngram"`` prompt lookup vs ``"model"`` draft model): per-source
        and total drafted/accepted counters plus the lifetime
        `serving_spec_accept_rate` gauge."""
        m = self.metrics
        m.counter(f"serving_spec_drafted_{source}_total",
                  f"draft tokens proposed by the {source} drafter"
                  ).inc(drafted)
        m.counter(f"serving_spec_accepted_{source}_total",
                  f"{source}-drafted tokens accepted by verify"
                  ).inc(accepted)
        d = m.counter("serving_spec_drafted_total",
                      "draft tokens scored by speculative verify")
        a = m.counter("serving_spec_accepted_total",
                      "draft tokens accepted by speculative verify")
        d.inc(drafted)
        a.inc(accepted)
        if d.value:
            m.gauge("serving_spec_accept_rate",
                    "accepted/drafted over the observer's lifetime"
                    ).set(a.value / d.value)

    def prefill_chunk(self, rid: str, n_tokens: int) -> None:
        self.tracer.prefill_chunk(rid, n_tokens, self.now)
        self.metrics.counter("serving_prefill_tokens_total",
                             "prompt tokens fed").inc(n_tokens)

    def tokens(self, rid: str, n: int = 1) -> None:
        self.tracer.tokens(rid, n, self.now)
        self.metrics.counter("serving_tokens_generated_total",
                             "tokens emitted to streams").inc(n)

    def request_finished(self, rid: str) -> None:
        self.tracer.request_finished(rid, self.now)
        self.metrics.counter("serving_requests_finished_total",
                             "requests retired complete").inc()
        t = self.tracer.completed[-1] if self.tracer.completed else None
        if t is None or t.rid != rid:
            return
        for name, v in (("ttft_s", t.ttft), ("tpot_s", t.tpot),
                        ("e2e_s", t.e2e), ("queue_wait_s", t.queue_wait)):
            if v is not None:
                self.metrics.histogram(
                    f"serving_request_{name.replace('_s', '_seconds')}"
                ).observe(v)

    # -- step captures (the captures guard's companion) ----------------------

    def attach_compile_hook(self) -> None:
        """Count StepGraph captures into `graph_captures_total` while the
        engine runs (the event stream the captures guard consumes,
        `utils/profiling.py`).  An engine captures when it is built, so
        inside a run the counter must stay 0."""
        if self._capture_hook is not None:
            return
        from mdi_llm_tpu_torch.utils import profiling

        captures = self.metrics.counter(
            "graph_captures_total", "step graph captures while serving")

        def hook(_step) -> None:
            captures.inc()

        profiling.add_capture_listener(hook)
        self._capture_hook = hook

    def detach_compile_hook(self) -> None:
        if self._capture_hook is None:
            return
        from mdi_llm_tpu_torch.utils import profiling

        profiling.remove_capture_listener(self._capture_hook)
        self._capture_hook = None

    # -- device-side introspection (obs/device.py) ---------------------------

    def publish_device_report(self, report) -> None:
        """Register an `ExecutableReport` and mirror its headline numbers
        into the metrics registry (`step_<label>_{flops,bytes_accessed,
        temp_bytes}` gauges, one per step; the full per-shape fidelity
        lives in `metrics_dict()["device"]`).  A host-side append."""
        self.device.add(report)
        for suffix, value in (
            ("flops", report.flops),
            ("bytes_accessed", report.bytes_accessed),
            ("temp_bytes", report.temp_bytes),
        ):
            if value is not None:
                self.metrics.gauge(
                    f"step_{report.label}_{suffix}",
                    f"{suffix.replace('_', ' ')} of the {report.label} "
                    "step (obs/device.py)",
                ).set(value)

    # -- exposition ----------------------------------------------------------

    def latency_summaries(self) -> Dict[str, Dict[str, float]]:
        """{metric: {count,p50,p95,p99,mean,max}} over the
        completed-request window — EXACT percentiles over the ring."""
        lats = self.tracer.latencies()
        return {name: latency_summary(lats[name]) for name in LATENCY_METRICS}

    def metrics_dict(self, stats=None) -> Dict:
        """The `--metrics-out` JSON: latency percentile block + registry
        snapshot (+ the engine's canonical `ServingStats.to_dict()` and
        the per-request detail rows still in the window)."""
        out: Dict = {
            "latency": self.latency_summaries(),
            "metrics": self.metrics.to_dict(),
            "requests": [t.to_dict() for t in list(self.tracer.completed)],
            "ring": {"capacity": self.tracer.capacity,
                     "events": len(self.tracer.events),
                     "events_dropped": self.tracer.dropped,
                     "completed_window": len(self.tracer.completed)},
        }
        if len(self.device):
            out["device"] = self.device.to_dict()
        if stats is not None:
            out["serving_stats"] = stats.to_dict()
        return out
