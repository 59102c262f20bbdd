"""Worker → node metrics federation for the verifier fleet.

Each ``VerifierWorker`` attaches its batcher registry's snapshot to every
``WorkerLoadReport``; the node folds those into a
``FleetMetricsFederation`` that the node's own ``MetricRegistry`` exports
through an ``add_collector`` hook. Two kinds of derived families come out:

- **per-worker**: every reported family re-keyed as
  ``Family{worker="w0"}`` with ``family``/``labels`` metadata so
  ``prometheus_text`` renders it as a labeled sample of one family — the
  2-worker smoke fleet's ``SigBatcher.*`` / ``Breaker.*`` series appear on
  the NODE's /metrics, one series per worker.
- **fleet aggregates** under ``Fleet.agg.<Family>``: counter-like counts
  (meters, timers, counters, histogram counts) accumulate as DELTAS
  against the previous report from that worker — monotone on the node
  even across a worker restart (a count going backwards is treated as a
  fresh start, contributing its full new value). Gauges federate as
  last-value and aggregate as the sum over currently-attached workers.
  Histograms merge bucket-by-bucket: the fixed log-bucket layout
  (utils/metrics._HIST_BOUNDS) is identical in every process, so merging
  is per-``le`` addition of decumulated counts, re-accumulated after the
  sum; quantiles are recomputed from the merged buckets and the LATEST
  exemplar per bucket survives, still resolvable against /traces once the
  matching spans were ingested.

Snapshots arrive over the wire as a tuple of ``(family, fields)`` pairs
(msgpack round-trips dicts and lists); this module tolerates lists where
the registry emits tuples.
"""
from __future__ import annotations

import math
import threading

#: Counter-like metric types whose monotone count federates as deltas.
_COUNTED = {"meter": "count", "timer": "count", "histogram": "count",
            "counter": "value"}


def _le_key(le: str) -> float:
    return math.inf if le == "+Inf" else float(le)


def _merge_buckets(instances: list[dict]) -> tuple[list, dict]:
    """Merge cumulative ``(le, cum)`` bucket lists from several workers:
    decumulate each, sum per ``le``, re-accumulate in bound order. Returns
    the merged cumulative pairs and the merged exemplars (latest ts wins
    per bucket)."""
    per_le: dict[str, int] = {}
    exemplars: dict[str, dict] = {}
    for fields in instances:
        prev = 0
        for pair in fields.get("buckets", ()):
            le, cum = str(pair[0]), int(pair[1])
            per_le[le] = per_le.get(le, 0) + max(0, cum - prev)
            prev = cum
        for le, ex in (fields.get("exemplars") or {}).items():
            if not isinstance(ex, dict):
                continue
            best = exemplars.get(str(le))
            if best is None or ex.get("ts", 0) >= best.get("ts", 0):
                exemplars[str(le)] = dict(ex)
    merged, cum = [], 0
    for le in sorted(per_le, key=_le_key):
        cum += per_le[le]
        merged.append((le, cum))
    return merged, exemplars


def _bucket_quantile(buckets: list, count: int, max_v: float,
                     q: float) -> float:
    """q-quantile upper bound from merged cumulative buckets, clamped to
    the observed max — same estimate Histogram.quantile gives locally."""
    if count <= 0:
        return 0.0
    target = max(1, math.ceil(q * count))
    for le, cum in buckets:
        if cum >= target:
            bound = _le_key(le)
            return max_v if bound is math.inf else min(bound, max_v)
    return max_v


class FleetMetricsFederation:
    """Node-side accumulator for worker metric snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        # worker -> {family: fields} (latest report, attached workers only)
        self._latest: dict[str, dict[str, dict]] = {}
        # (worker, family) -> last seen monotone count (delta baseline)
        self._last_counts: dict[tuple, float] = {}
        # family -> accumulated delta count (survives worker restarts)
        self._agg_counts: dict[str, float] = {}

    def ingest(self, worker: str, entries) -> None:
        """Fold one worker's snapshot in. ``entries`` is the wire form: an
        iterable of (family, fields) pairs (or a plain {family: fields}
        dict from in-process callers)."""
        pairs = entries.items() if isinstance(entries, dict) else entries
        snap: dict[str, dict] = {}
        for pair in pairs:
            try:
                family, fields = pair
            except (TypeError, ValueError):
                continue
            if isinstance(fields, dict):
                snap[str(family)] = dict(fields)
        with self._lock:
            self._latest[worker] = snap
            for family, fields in snap.items():
                count_field = _COUNTED.get(fields.get("type"))
                if count_field is None:
                    continue
                c = fields.get(count_field)
                if isinstance(c, bool) or not isinstance(c, (int, float)):
                    continue
                key = (worker, family)
                last = self._last_counts.get(key, 0)
                delta = c - last if c >= last else c   # restart => fresh
                self._last_counts[key] = c
                self._agg_counts[family] = (
                    self._agg_counts.get(family, 0) + max(0, delta))

    def detach(self, worker: str) -> None:
        """Stop exporting a detached worker's series (aggregate counter
        deltas it contributed remain — they happened)."""
        with self._lock:
            self._latest.pop(worker, None)
            for key in [k for k in self._last_counts if k[0] == worker]:
                del self._last_counts[key]

    def worker_count(self) -> int:
        with self._lock:
            return len(self._latest)

    def snapshot(self) -> dict:
        """Collector payload for MetricRegistry.snapshot(): per-worker
        labeled entries plus ``Fleet.agg.*`` aggregate families."""
        with self._lock:
            latest = {w: dict(s) for w, s in self._latest.items()}
            agg_counts = dict(self._agg_counts)
        out: dict = {}
        families: dict[str, list[dict]] = {}
        for worker in sorted(latest):
            for family, fields in sorted(latest[worker].items()):
                entry = dict(fields)
                entry["family"] = family
                entry["labels"] = {"worker": worker}
                out[f'{family}{{worker="{worker}"}}'] = entry
                families.setdefault(family, []).append(fields)
        for family in sorted(families):
            agg = self._aggregate(families[family], agg_counts.get(family))
            if agg is not None:
                out[f"Fleet.agg.{family}"] = agg
        return out

    def _aggregate(self, instances: list[dict], agg_count) -> dict | None:
        mtype = instances[0].get("type")
        instances = [f for f in instances if f.get("type") == mtype]

        def total(field, default=0.0):
            return sum(f.get(field) or default for f in instances)

        if mtype == "meter":
            return {"type": "meter",
                    "count": agg_count if agg_count is not None
                    else total("count"),
                    "mean_rate": total("mean_rate")}
        if mtype == "timer":
            count = total("count")
            weighted = sum((f.get("count") or 0) * (f.get("mean_s") or 0.0)
                           for f in instances)
            return {"type": "timer",
                    "count": agg_count if agg_count is not None else count,
                    "mean_s": weighted / count if count else 0.0,
                    "max_s": max((f.get("max_s") or 0.0)
                                 for f in instances)}
        if mtype == "counter":
            return {"type": "counter",
                    "value": agg_count if agg_count is not None
                    else total("value")}
        if mtype == "gauge":
            return {"type": "gauge", "value": total("value"),
                    "max": max((f.get("max") or 0.0) for f in instances)}
        if mtype == "gauge_fn":
            vals = [f.get("value") for f in instances
                    if isinstance(f.get("value"), (int, float))
                    and not isinstance(f.get("value"), bool)]
            return {"type": "gauge_fn", "value": sum(vals) if vals else None}
        if mtype == "histogram":
            buckets, exemplars = _merge_buckets(instances)
            count = int(total("count"))
            total_sum = total("sum")
            max_v = max((f.get("max") or 0.0) for f in instances)
            agg = {"type": "histogram", "count": count, "sum": total_sum,
                   "max": max_v,
                   "mean": total_sum / count if count else 0.0,
                   "p50": _bucket_quantile(buckets, count, max_v, 0.50),
                   "p90": _bucket_quantile(buckets, count, max_v, 0.90),
                   "p99": _bucket_quantile(buckets, count, max_v, 0.99),
                   "buckets": buckets}
            if exemplars:
                agg["exemplars"] = exemplars
            return agg
        return None
