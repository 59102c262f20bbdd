"""Bounded in-memory span ring buffer with JSONL export.

The storage half of the tracer (tracing.py): completed spans land here as
plain dicts, oldest-first, capped at ``capacity`` — a long-running node can
trace forever without growing memory, at the cost of losing the oldest
spans (``dropped`` counts them). Everything is stdlib and thread-safe; the
/traces endpoint (tools/webserver.py) and the JSONL exporter read the same
snapshot.
"""
from __future__ import annotations

import json
import threading
from collections import deque


class SpanRing:
    """Fixed-capacity FIFO of completed-span dicts."""

    def __init__(self, capacity: int = 8192):
        if capacity <= 0:
            raise ValueError("SpanRing capacity must be positive")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self.dropped = 0

    def record(self, span_dict: dict) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(span_dict)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def snapshot(self, trace_id: str | None = None,
                 limit: int | None = None) -> list[dict]:
        """Buffered spans oldest-first, optionally filtered to one trace
        and/or truncated to the most recent ``limit``."""
        with self._lock:
            spans = list(self._buf)
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        if limit is not None and len(spans) > limit:
            spans = spans[-limit:]
        return spans

    def traces(self, limit_spans: int | None = None) -> dict:
        """Spans grouped by trace id (insertion order preserved within and
        across traces). ``limit_spans`` bounds how many of the most recent
        spans are considered."""
        grouped: dict = {}
        for s in self.snapshot(limit=limit_spans):
            grouped.setdefault(s.get("trace_id"), []).append(s)
        return grouped

    def export_jsonl(self, path: str, trace_id: str | None = None) -> int:
        """Write buffered spans as one-JSON-object-per-line; returns the
        span count written."""
        spans = self.snapshot(trace_id=trace_id)
        with open(path, "w", encoding="utf-8") as f:
            for s in spans:
                f.write(json.dumps(s, sort_keys=True) + "\n")
        return len(spans)

    def to_jsonl(self, trace_id: str | None = None,
                 limit: int | None = None) -> str:
        return "".join(json.dumps(s, sort_keys=True) + "\n"
                       for s in self.snapshot(trace_id=trace_id, limit=limit))
