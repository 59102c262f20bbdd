"""Per-request lifecycle timelines for the verifier fleet.

Every out-of-process verification request leaves an append-only event
trail — submitted → routed{worker, reason, est-load vector} → parked →
stolen{victim} → dispatched{worker, batch} → resolved / requeued — kept in
a bounded structure (oldest REQUEST evicted whole, never a partial
timeline) and exposed two ways:

- ``GET /debug/requests`` (tools/webserver.py) returns the newest
  timelines as JSON, so "why did request 841 land on w3?" is answerable
  after the fact with the router's reason and the estimated-load vector it
  saw at decision time.
- every append also emits a ``request.<event>`` jlog line carrying the
  request's trace id (slog.py), so the timeline correlates with /traces
  and survives the ring's bounded retention in the log stream.

The log is always on: appends are O(1) dict/list work under one lock and
the jlog call is gated on the logger level, so the untraced hot path pays
a few dict writes per request, not serialization.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict

from .slog import _trace_ids, jlog

log = logging.getLogger(__name__)

#: Events that end a request's lifecycle — used by chaos tests to assert
#: exactly-once terminal resolution even across steals and crash-detaches.
TERMINAL_EVENTS = frozenset({"resolved"})


class RequestLog:
    """Bounded append-only map of verification_id → event list."""

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._timelines: "OrderedDict[int, list[dict]]" = OrderedDict()
        #: vids whose timeline already carries a TERMINAL_EVENTS event, in
        #: the order they resolved — the eviction queue of first resort.
        self._terminal: "OrderedDict[int, None]" = OrderedDict()
        self.dropped = 0   # whole timelines evicted by the bound

    def append(self, vid: int, event: str, trace=None, **fields) -> None:
        rec: dict = {"event": event, "t": round(time.time(), 6)}
        trace_id, _sid = _trace_ids(trace)
        if trace_id is not None:
            rec["trace_id"] = trace_id
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            tl = self._timelines.get(vid)
            if tl is None:
                while len(self._timelines) >= self.capacity:
                    self._evict_one_locked()
                tl = self._timelines[vid] = []
            tl.append(rec)
            if event in TERMINAL_EVENTS:
                self._terminal[vid] = None
        jlog(log, f"request.{event}", ctx=trace, vid=vid, **fields)

    def _evict_one_locked(self) -> None:
        """Evict one whole timeline, preferring requests that already
        resolved. Blind FIFO eviction could drop an in-flight request
        while resolved ones inserted later survive; its later events
        would then re-open a fresh partial timeline, leaking an extra
        entry per churn cycle and losing the routing history the debug
        surface exists for."""
        while self._terminal:
            vid, _ = self._terminal.popitem(last=False)
            if self._timelines.pop(vid, None) is not None:
                self.dropped += 1
                return
        self._timelines.popitem(last=False)
        self.dropped += 1

    def __len__(self) -> int:
        """Live timeline count — the bounded size the resource accounting
        plane probes (``Requests.Timelines``); ``dropped`` is the matching
        cumulative eviction counter it differentiates into a rate."""
        with self._lock:
            return len(self._timelines)

    def timeline(self, vid: int) -> list[dict]:
        with self._lock:
            return list(self._timelines.get(vid, ()))

    def events(self, vid: int) -> list[str]:
        return [e["event"] for e in self.timeline(vid)]

    def terminal_count(self, vid: int) -> int:
        """How many terminal (resolution) events this request has — the
        exactly-once invariant says 1 for every completed request."""
        return sum(1 for e in self.timeline(vid)
                   if e["event"] in TERMINAL_EVENTS)

    def snapshot(self, limit: int | None = None) -> dict:
        """Newest-first {vid: [events...]} — the /debug/requests payload.
        ``limit`` caps the number of REQUESTS returned (not events)."""
        with self._lock:
            items = list(self._timelines.items())
        items.reverse()
        if limit is not None:
            items = items[:max(0, limit)]
        return {str(vid): list(tl) for vid, tl in items}
