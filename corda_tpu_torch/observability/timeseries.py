"""Retained time-series plane: memory-bounded, downsampled metric history.

Every other metric surface in the repo is point-in-time — a snapshot says
where a gauge IS, not where it has BEEN, so multi-minute soak behaviour
(raft log growth, SLO budget burn over windows, shard-skew drift) is
invisible at exactly the moment it matters. This module keeps a bounded
history per named series as a cascade of rings: a fine ring of recent
buckets whose evicted buckets downsample into the next, coarser ring, and
so on — old data loses resolution, never existence (within the coarsest
ring's horizon), and memory stays O(sum of ring capacities) per series
forever.

Each bucket is an aggregate ``[t, n, min, max, mean, last]`` so a consumer
can render envelopes (min/max band) as well as trends. The store is
stdlib-only and thread-safe; the ``/api/timeseries`` endpoint
(tools/webserver.py) and the ``consensus_stat`` CLI read the same
snapshot. A process-global store rides the same get/set seam as the
tracer so the raft pump (producer) and the webserver (consumer) meet
without plumbing.
"""
from __future__ import annotations

import threading
import time as _time

#: (bucket_seconds, ring_capacity) finest-first: 2 min at 0.5 s, 20 min at
#: 5 s, 4 h at 60 s. Per series that is ≤ 720 buckets of 6 floats — a soak
#: run can sample forever without growing memory.
DEFAULT_RESOLUTIONS: tuple = ((0.5, 240), (5.0, 240), (60.0, 240))

#: bucket column order in every snapshot (see ``TimeSeriesStore.snapshot``)
COLUMNS: tuple = ("t", "n", "min", "max", "mean", "last")


class _Bucket:
    """One open aggregation bucket."""

    __slots__ = ("start", "n", "vmin", "vmax", "total", "last")

    def __init__(self, start: float):
        self.start = start
        self.n = 0
        self.vmin = 0.0
        self.vmax = 0.0
        self.total = 0.0
        self.last = 0.0

    def merge(self, n: int, vmin: float, vmax: float, total: float,
              last: float) -> None:
        if self.n == 0:
            self.vmin, self.vmax = vmin, vmax
        else:
            self.vmin = min(self.vmin, vmin)
            self.vmax = max(self.vmax, vmax)
        self.n += n
        self.total += total
        self.last = last

    def row(self) -> list:
        mean = self.total / self.n if self.n else 0.0
        return [self.start, self.n, self.vmin, self.vmax, mean, self.last]


class _Ring:
    """One resolution: a FIFO of closed buckets plus the open one."""

    __slots__ = ("bucket_s", "capacity", "closed", "cur")

    def __init__(self, bucket_s: float, capacity: int):
        if bucket_s <= 0 or capacity <= 0:
            raise ValueError("bucket_s and capacity must be positive")
        self.bucket_s = bucket_s
        self.capacity = capacity
        self.closed: list = []          # rows, oldest first, bounded
        self.cur: _Bucket | None = None

    def add(self, t: float, n: int, vmin: float, vmax: float, total: float,
            last: float) -> "_Bucket | None":
        """Merge an aggregate into this ring; returns the bucket this
        merge CLOSED (to cascade into the next, coarser ring) or None."""
        start = (t // self.bucket_s) * self.bucket_s
        closed = None
        if self.cur is not None and start > self.cur.start:
            closed = self._close()
        if self.cur is None:
            self.cur = _Bucket(start)
        self.cur.merge(n, vmin, vmax, total, last)
        return closed

    def _close(self) -> "_Bucket | None":
        b, self.cur = self.cur, None
        if b is None or b.n == 0:
            return None
        self.closed.append(b.row())
        if len(self.closed) > self.capacity:
            del self.closed[: len(self.closed) - self.capacity]
        return b

    def rows(self, include_open: bool = True) -> list:
        out = list(self.closed)
        if include_open and self.cur is not None and self.cur.n:
            out.append(self.cur.row())
        return out


class TimeSeries:
    """The ring cascade for one named series."""

    def __init__(self, resolutions=DEFAULT_RESOLUTIONS):
        self.rings = [_Ring(b, c) for b, c in resolutions]

    def record(self, t: float, value: float) -> None:
        agg = (t, 1, value, value, value, value)
        for ring in self.rings:
            closed = ring.add(*agg)
            if closed is None:
                break
            # the evicted fine bucket downsamples into the coarser ring
            agg = (closed.start, closed.n, closed.vmin, closed.vmax,
                   closed.total, closed.last)

    def flush(self) -> None:
        """Close every open bucket, cascading each into the next ring —
        end-of-run sealing so every resolution holds the final samples."""
        for i, ring in enumerate(self.rings):
            closed = ring._close()
            if closed is not None and i + 1 < len(self.rings):
                self.rings[i + 1].add(closed.start, closed.n, closed.vmin,
                                      closed.vmax, closed.total, closed.last)

    def snapshot(self, limit: int | None = None,
                 since: float | None = None,
                 resolution: float | None = None) -> list:
        """``since`` keeps only buckets starting at/after that absolute
        time (an incremental poller sends its last-seen ``t``; a bucket
        straddling the cutoff while still open reappears, sealed, in the
        next poll — at-least-once, never silently dropped). ``resolution``
        keeps only the ring whose ``bucket_s`` matches; an unknown value
        matches nothing and returns an empty list rather than erroring."""
        out = []
        for ring in self.rings:
            if resolution is not None and ring.bucket_s != resolution:
                continue
            rows = ring.rows()
            if since is not None:
                rows = [r for r in rows if r[0] >= since]
            if limit is not None and len(rows) > limit:
                rows = rows[-limit:]
            out.append({"bucket_s": ring.bucket_s,
                        "capacity": ring.capacity, "points": rows})
        return out


class TimeSeriesStore:
    """Named series, each a ring cascade; bounded in series count too."""

    def __init__(self, resolutions=DEFAULT_RESOLUTIONS,
                 max_series: int = 256):
        self.resolutions = tuple(resolutions)
        self.max_series = max_series
        self._series: dict = {}
        self._lock = threading.Lock()
        self.dropped_series = 0

    def record(self, name: str, value, t: float | None = None) -> None:
        """Append one sample. Non-numeric values are ignored (a collector
        handing over a malformed gauge must not poison the plane)."""
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        t = _time.time() if t is None else t
        with self._lock:
            series = self._series.get(name)
            if series is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                series = self._series[name] = TimeSeries(self.resolutions)
            series.record(t, float(value))

    def record_many(self, values: dict, t: float | None = None) -> None:
        t = _time.time() if t is None else t
        for name, value in values.items():
            self.record(name, value, t=t)

    def flush(self) -> None:
        with self._lock:
            for series in self._series.values():
                series.flush()

    def names(self) -> list:
        with self._lock:
            return sorted(self._series)

    def snapshot(self, names=None, limit: int | None = None,
                 since: float | None = None,
                 resolution: float | None = None) -> dict:
        """{"columns": COLUMNS, "series": {name: [{bucket_s, capacity,
        points: [[t, n, min, max, mean, last], ...]}, ...]}} — resolutions
        finest-first; ``limit`` caps points per resolution (most recent
        kept), ``since`` drops buckets starting before that absolute time,
        ``resolution`` keeps only the matching ring (soak pollers ask for
        the 60 s ring alone). Unknown requested names are simply absent,
        never an error."""
        with self._lock:
            wanted = sorted(self._series) if names is None else \
                [n for n in names if n in self._series]
            series = {n: self._series[n].snapshot(
                limit=limit, since=since, resolution=resolution)
                for n in wanted}
        return {"columns": list(COLUMNS), "series": series,
                "dropped_series": self.dropped_series}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self.dropped_series = 0


_global_lock = threading.Lock()
_global_store: TimeSeriesStore | None = None


def get_timeseries() -> TimeSeriesStore:
    """The process-global store (created on first use) — same seam shape
    as get_tracer/get_profiler so producers and consumers meet."""
    global _global_store
    with _global_lock:
        if _global_store is None:
            _global_store = TimeSeriesStore()
        return _global_store


def set_timeseries(store: TimeSeriesStore | None) -> "TimeSeriesStore | None":
    """Swap the process-global store (tests/harness); returns the old one."""
    global _global_store
    with _global_lock:
        prev, _global_store = _global_store, store
        return prev
