"""Minimal metrics registry (codahale-style: meters, timers, gauges, counters).

Reference parity: MonitoringService (services/api/MonitoringService.kt:11) and
the named verification metrics of OutOfProcessTransactionVerifierService.kt:33-45
("Verification.Duration/Success/Failure/InFlight"). Thread-safe; snapshot-able
for export (the JMX analog is `snapshot()` → dict, consumable by any exporter).
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from collections import defaultdict


class Meter:
    """Monotone event counter with a rate since creation."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self._t0 = time.monotonic()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def mean_rate(self) -> float:
        dt = time.monotonic() - self._t0
        return self.count / dt if dt > 0 else 0.0


class Timer:
    """Duration accumulator; use as a context manager."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.update(time.perf_counter() - self._start)
        return False

    def update(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.max_s = max(self.max_s, seconds)

    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


#: Fixed log-scaled bucket upper bounds: quarter-decade steps (×~1.78)
#: from 1e-6 to 1e7 — one layout covers microsecond latencies AND 32k-item
#: batch sizes, so every histogram snapshot/exposition has identical shape
#: and two registries' histograms are directly comparable.
_HIST_BOUNDS = tuple(10.0 ** (e / 4.0) for e in range(-24, 29))


class Histogram:
    """Fixed-bucket log-scaled histogram with quantile snapshots.

    Quantiles are bucket-resolution estimates (within ×10^0.25 ≈ 1.78 of
    the true value), clamped to the observed max — the standard
    fixed-bucket trade: O(1) update, O(buckets) snapshot, no per-sample
    storage, mergeable across processes by summing counts.

    Observations may carry a ``trace_id`` (the tracer's, observability/
    tracing.py): the histogram keeps the LAST exemplar per bucket, so a
    slow p99 bucket in /metrics links directly to a concrete span in the
    trace ring — the Dapper "exemplar" pattern, one dict write per traced
    observation, nothing stored for untraced ones."""

    BOUNDS = _HIST_BOUNDS

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.BOUNDS) + 1)  # +1 overflow bucket
        self.count = 0
        self.total = 0.0
        self.max_value = 0.0
        # bucket index -> (trace_id, value, unix ts): last exemplar only
        self._exemplars: dict[int, tuple] = {}

    def update(self, value: float, trace_id: str | None = None) -> None:
        v = float(value)
        idx = bisect.bisect_left(self.BOUNDS, v)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += v
            if v > self.max_value:
                self.max_value = v
            if trace_id is not None:
                self._exemplars[idx] = (trace_id, v, time.time())

    def _bucket_le(self, idx: int) -> str:
        return (f"{self.BOUNDS[idx]:.6g}" if idx < len(self.BOUNDS)
                else "+Inf")

    def exemplars(self) -> dict:
        """Last exemplar per bucket: {le: {trace_id, value, ts}} — the
        /metrics JSON + Prometheus exposition surface."""
        with self._lock:
            items = list(self._exemplars.items())
        return {self._bucket_le(i): {"trace_id": t, "value": v, "ts": ts}
                for i, (t, v, ts) in sorted(items)}

    def bucket_counts(self) -> list:
        """Cumulative (le, count) pairs for non-empty buckets plus +Inf —
        the Prometheus histogram exposition shape."""
        with self._lock:
            counts = list(self._counts)
            total = self.count
        out = []
        cum = 0
        for i, c in enumerate(counts[:-1]):
            cum += c
            if c:
                out.append((self._bucket_le(i), cum))
        out.append(("+Inf", total))
        return out

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.update(time.perf_counter() - self._start)
        return False

    def quantile(self, q: float) -> float:
        """q-quantile estimate, linearly interpolated WITHIN the bucket
        holding the target sample (0 when empty), clamped to the observed
        maximum. Snapping to the bucket's upper edge — the previous
        behaviour — overstates tails by up to one quarter-decade (×1.78)
        whenever the target rank lands early in a log bucket; the rank
        fraction positions the estimate between the bucket's edges
        instead."""
        with self._lock:
            counts = list(self._counts)
            count = self.count
            max_v = self.max_value
        if count == 0:
            return 0.0
        target = max(1, math.ceil(q * count))
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                if i >= len(self.BOUNDS):
                    return max_v     # overflow bucket: max is all we know
                lo = self.BOUNDS[i - 1] if i > 0 else 0.0
                hi = self.BOUNDS[i]
                frac = (target - (cum - c)) / c
                return min(lo + frac * (hi - lo), max_v)
        return max_v

    def snapshot_fields(self) -> dict:
        with self._lock:
            count, total, max_v = self.count, self.total, self.max_value
            has_exemplars = bool(self._exemplars)
        out = {"count": count, "sum": total, "max": max_v,
               "mean": total / count if count else 0.0,
               "p50": self.quantile(0.50), "p90": self.quantile(0.90),
               "p99": self.quantile(0.99),
               "buckets": self.bucket_counts()}
        if has_exemplars:
            out["exemplars"] = self.exemplars()
        return out


class Counter:
    """Up/down counter (the in-flight gauge analog)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: int = 1) -> None:
        self.inc(-n)


class Gauge:
    """Settable instantaneous level with a high-water mark.

    Counter tracks net increments; Gauge records observed *levels* and the
    maximum ever seen — the shape of the batcher's prep-pool concurrency
    metric, where the high-water mark (how many scheme preps actually
    overlapped) is the interesting number and the instantaneous value is
    usually zero by the time anyone snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0
        self.max_value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value
            if value > self.max_value:
                self.max_value = value


class MetricRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: list = []

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {type(m).__name__}")
            return m

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def settable_gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def gauge(self, name: str, fn) -> None:
        with self._lock:
            self._metrics[name] = fn

    def register(self, name: str, metric) -> None:
        """Install an EXISTING metric object under ``name`` — the seam the
        kernel profiler uses to share its process-wide histograms with
        every registry that exports them (node monitoring + bench's
        private registry see the same distribution)."""
        with self._lock:
            self._metrics[name] = metric

    def get_metric(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def add_collector(self, fn) -> None:
        """Register a zero-arg callable returning ``{name: fields}`` whose
        entries ride every ``snapshot()`` — the seam federated (per-worker
        labeled) families use to appear on /metrics without being local
        metric objects. Locally-registered metrics win on name collision;
        a raising collector is skipped, never kills the snapshot."""
        with self._lock:
            self._collectors.append(fn)

    def snapshot(self) -> dict:
        """Registry → {name: fields} with a ``type`` discriminator per
        metric, so exporters (prometheus_text) can render each family
        correctly instead of guessing from field names."""
        out = {}
        with self._lock:
            items = list(self._metrics.items())
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                extra = fn()
            except Exception:
                continue
            if isinstance(extra, dict):
                out.update(extra)
        for name, m in items:
            if isinstance(m, Meter):
                out[name] = {"type": "meter", "count": m.count,
                             "mean_rate": m.mean_rate()}
            elif isinstance(m, Timer):
                out[name] = {"type": "timer", "count": m.count,
                             "mean_s": m.mean_s(), "max_s": m.max_s}
            elif isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value}
            elif isinstance(m, Histogram):
                out[name] = {"type": "histogram", **m.snapshot_fields()}
            elif isinstance(m, Gauge):
                out[name] = {"type": "gauge", "value": m.value,
                             "max": m.max_value}
            else:
                try:
                    value = m()
                except Exception:   # a dead gauge fn must not kill /metrics
                    value = None
                out[name] = {"type": "gauge_fn", "value": value}
        return out
