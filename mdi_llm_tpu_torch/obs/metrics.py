"""Host-side metrics registry: counters, gauges, fixed-bucket histograms.

A copy of `mdi_llm_tpu/obs/metrics.py` (host-only Python; the port keeps
its own copy so that nothing of the JAX package is imported).  The
measurement half of the serving observability layer (`obs/`): the
engine, scheduler, KV pool and the captures guard feed a
`MetricsRegistry` entirely from host-side bookkeeping they already
maintain — recording a metric never touches a device tensor, so enabling
metrics adds zero host syncs and zero graph captures (pinned by
tests/test_torch_obs.py).

Memory contract for long-lived engines: every metric is O(1) state — a
counter is one int, a gauge one float, a histogram a FIXED bucket vector
plus sum/count.  Exact per-request percentiles (TTFT/TPOT/...) come from
`percentiles()` over the tracer's bounded completed-request ring
(`obs/tracing.py`), not from unbounded value lists here; the histograms
exist for the Prometheus-style exposition where a scraper wants
monotonic cumulative buckets.

Exposition: `MetricsRegistry.to_dict()` (JSON, what `cli.serve
--metrics-out` writes) and `MetricsRegistry.render_prometheus()`
(text/plain; version 0.0.4 — `metric_bucket{le="..."}` cumulative
buckets, `_sum`/`_count`, the `+Inf` bucket always present).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS_S",
    "percentiles",
    "latency_summary",
]

# default histogram buckets for second-valued serving latencies: log-ish
# spread from 1 ms to 2 min, fixed so a long-lived engine's memory never
# grows with traffic (the O(1) contract above)
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


class Counter:
    """Monotonically increasing count (requests, tokens, compiles).

    Mutations take an internal lock: counters cross the thread seam —
    e.g. `requests_rejected` increments on the submitting thread while
    the engine thread bumps token counters — and `self.value += n` is a
    read-modify-write that would lose updates.
    Reading `value` is a single GIL-atomic load and stays lock-free."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: float = 0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self.value += n

    def set_to(self, v: float) -> None:
        """Advance to an externally-maintained running total (the engine's
        `ServingStats` aggregates) — still monotonic, never backwards."""
        with self._lock:
            if v < self.value:
                raise ValueError(
                    f"counter {self.name} cannot move backwards "
                    f"({self.value} -> {v})"
                )
            self.value = v


class Gauge:
    """Point-in-time value (KV utilization, live lanes, host RSS)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: float = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: counts per upper bound + sum + count.

    Buckets are non-cumulative internally; `cumulative()` produces the
    Prometheus-style `le` view.  `percentile(q)` interpolates inside the
    containing bucket — approximate by construction (use
    `metrics.percentiles` over raw values when exactness matters)."""

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be ascending")
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +overflow
        self.sum: float = 0.0
        self.count: int = 0
        self._lock = threading.Lock()  # observe is a multi-field RMW

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ...] ending with (+inf, count)."""
        out: List[Tuple[float, int]] = []
        acc = 0
        with self._lock:
            counts, total = list(self.counts), self.count
        for b, c in zip(self.bounds, counts):
            acc += c
            out.append((b, acc))
        out.append((math.inf, total))
        return out

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) by linear
        interpolation within the containing bucket (0 lower edge for the
        first; the overflow bucket reports its lower bound)."""
        if not 0 <= q <= 100:
            raise ValueError("q must be in [0, 100]")
        with self._lock:
            counts, total = list(self.counts), self.count
        if total == 0:
            return 0.0
        rank = q / 100.0 * total
        acc = 0
        lo = 0.0
        for b, c in zip(self.bounds, counts):
            if acc + c >= rank and c > 0:
                frac = (rank - acc) / c
                return lo + (b - lo) * min(1.0, max(0.0, frac))
            acc += c
            lo = b
        return lo  # overflow bucket: best available bound


def percentiles(values: Sequence[float], qs: Sequence[float]) -> List[float]:
    """Exact percentiles over `values` with linear interpolation between
    order statistics (numpy's default 'linear' method, reimplemented so
    the math under test is THIS module's, not numpy's)."""
    if not values:
        return [0.0 for _ in qs]
    xs = sorted(float(v) for v in values)
    n = len(xs)
    out: List[float] = []
    for q in qs:
        if not 0 <= q <= 100:
            raise ValueError("q must be in [0, 100]")
        pos = q / 100.0 * (n - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, n - 1)
        out.append(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))
    return out


def latency_summary(values: Sequence[float]) -> Dict[str, float]:
    """The canonical percentile block: p50/p95/p99 + mean/max/count, the
    shape `cli.serve --metrics-out`, the stats line and `/v1/stats`
    embed."""
    if not values:
        return {"count": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                "mean": 0.0, "max": 0.0}
    p50, p95, p99 = percentiles(values, (50, 95, 99))
    return {
        "count": len(values),
        "p50": p50,
        "p95": p95,
        "p99": p99,
        "mean": sum(values) / len(values),
        "max": max(values),
    }


class MetricsRegistry:
    """Name-keyed metric store with get-or-create accessors.

    One registry per observer; the engine/scheduler/pool never hold
    metric objects directly — they go through `ServingObserver`'s hooks
    so a disabled observer costs one `is None` check."""

    def __init__(self) -> None:
        self._metrics: "Dict[str, object]" = {}
        self._lock = threading.Lock()  # get-or-create races across threads

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    # -- exposition ----------------------------------------------------------

    def to_dict(self) -> Dict[str, Dict]:
        """JSON-ready snapshot: {"counters", "gauges", "histograms"}."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                gauges[name] = m.value
            elif isinstance(m, Histogram):
                hists[name] = {
                    "buckets": [
                        ["+Inf" if math.isinf(le) else le, c]
                        for le, c in m.cumulative()
                    ],
                    "sum": m.sum,
                    "count": m.count,
                }
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {name} histogram")
                for le, c in m.cumulative():
                    tag = "+Inf" if math.isinf(le) else _fmt(le)
                    lines.append(f'{name}_bucket{{le="{tag}"}} {c}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))
