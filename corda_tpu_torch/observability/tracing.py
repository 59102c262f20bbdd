"""Span-based tracer with explicit context propagation.

Design (SURVEY.md §5 tracing; the reference's analog is YourKit/JMX on the
verifier JVM — this is the in-framework replacement):

- A *trace* is one logical operation end-to-end (a transaction's verify, a
  flow run) identified by a random ``trace_id``; a *span* is one timed step
  inside it (enqueue wait, batch flush, device dispatch, resolve).
- Context propagation is EXPLICIT: a ``SpanContext`` (or its wire-friendly
  ``(trace_id, span_id)`` tuple) is passed as an argument across threads
  and components — the flow state machine hands it to the verifier service,
  the service hands it to the SignatureBatcher, the batcher carries it from
  the dispatcher thread to the finisher thread. No thread-locals, so spans
  never mis-attach when work hops threads (the whole pipeline is
  cross-thread).
- The default tracer is a NO-OP singleton: every instrumentation site costs
  one module-global read plus a method call returning a shared singleton,
  no allocation, no locks, no threads. ``enable_tracing()`` swaps in a real
  ``Tracer`` backed by a bounded ``SpanRing`` (ring.py).

Zero-dependency, thread-safe, stdlib-only.
"""
from __future__ import annotations

import os
import time

from .ring import SpanRing


def _new_id() -> str:
    return os.urandom(8).hex()


class SpanContext:
    """Immutable (trace_id, span_id) pair — the unit that travels across
    threads, futures, and (in-memory) messages."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        object.__setattr__(self, "trace_id", trace_id)
        object.__setattr__(self, "span_id", span_id)

    def __setattr__(self, *a):
        raise AttributeError("SpanContext is immutable")

    def as_tuple(self) -> tuple:
        return (self.trace_id, self.span_id)

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id})"


def _parent_ids(parent) -> tuple[str | None, str | None]:
    """Accept a SpanContext, a Span, a (trace_id, span_id) tuple (the
    messaging wire form), or None."""
    if parent is None:
        return None, None
    if isinstance(parent, SpanContext):
        return parent.trace_id, parent.span_id
    if isinstance(parent, Span):
        return parent.trace_id, parent.span_id
    if isinstance(parent, (tuple, list)) and len(parent) == 2:
        return parent[0], parent[1]
    raise TypeError(f"Bad span parent: {parent!r}")


class Span:
    """One timed operation. Use as a context manager, or call ``finish()``
    explicitly for spans that outlive a lexical scope (a flow's run span,
    a raft submission awaiting commit). Recording happens at finish time —
    an unfinished span is never visible in the ring."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_s",
                 "duration_s", "tags", "_ring", "_t0", "_done")

    def __init__(self, ring: SpanRing, name: str, trace_id: str,
                 parent_id: str | None, tags: dict):
        self._ring = ring
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.tags = tags
        self.start_s = time.time()
        self._t0 = time.perf_counter()
        self.duration_s = 0.0
        self._done = False

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        self.duration_s = time.perf_counter() - self._t0
        self._ring.record(self.to_dict())

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_s": self.start_s, "duration_s": self.duration_s,
                "tags": dict(self.tags)}

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.tags.setdefault("error", f"{exc_type.__name__}: {exc}")
        self.finish()
        return False


class _NoopSpan:
    """Shared do-nothing span: every method is a constant-time no-op and
    ``context()`` is None, so disabled tracing propagates nothing."""

    __slots__ = ()

    def context(self):
        return None

    def set_tag(self, key, value):
        return self

    def finish(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """The default: near-free when tracing is off. All span factories return
    the shared NOOP_SPAN; nothing is ever recorded."""

    enabled = False
    ring = None

    def span(self, name, parent=None, **tags):
        return NOOP_SPAN

    def record(self, name, parent=None, start_s=None, duration_s=0.0, **tags):
        return None

    def ingest(self, span_dict) -> None:
        return None

    def spans(self, trace_id=None, limit=None):
        return []

    def trace(self, trace_id):
        return []

    def traces(self, limit_spans=None):
        return {}


NOOP_TRACER = NoopTracer()


class Tracer:
    """Recording tracer over a bounded SpanRing."""

    enabled = True

    def __init__(self, capacity: int = 8192):
        self.ring = SpanRing(capacity)

    def span(self, name: str, parent=None, **tags) -> Span:
        """Open a live span. ``parent`` is a SpanContext / Span /
        (trace_id, span_id) tuple, or None to start a fresh trace."""
        trace_id, parent_id = _parent_ids(parent)
        if trace_id is None:
            trace_id = _new_id()
        return Span(self.ring, name, trace_id, parent_id, tags)

    def record(self, name: str, parent=None, start_s: float | None = None,
               duration_s: float = 0.0, **tags) -> SpanContext:
        """Record an already-completed span retroactively (e.g. enqueue
        waits, measured between timestamps taken under a lock). Returns its
        context so children can still be parented to it."""
        trace_id, parent_id = _parent_ids(parent)
        if trace_id is None:
            trace_id = _new_id()
        span_id = _new_id()
        self.ring.record({
            "name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent_id,
            "start_s": time.time() if start_s is None else start_s,
            "duration_s": duration_s, "tags": dict(tags)})
        return SpanContext(trace_id, span_id)

    def ingest(self, span_dict) -> None:
        """Record a FINISHED span produced in another process (a verifier
        worker's dict-built span, shipped back piggybacked on a reply or a
        load report). The dict is normalized defensively — a malformed or
        truncated span from an old worker is dropped, never raises."""
        if not isinstance(span_dict, dict):
            return
        d = dict(span_dict)
        if not d.get("trace_id") or not d.get("span_id"):
            return
        d.setdefault("name", "?")
        d.setdefault("parent_id", None)
        d.setdefault("start_s", 0.0)
        d.setdefault("duration_s", 0.0)
        if not isinstance(d.get("tags"), dict):
            d["tags"] = {}
        self.ring.record(d)

    def spans(self, trace_id=None, limit=None) -> list[dict]:
        return self.ring.snapshot(trace_id=trace_id, limit=limit)

    def trace(self, trace_id: str) -> list[dict]:
        return self.ring.snapshot(trace_id=trace_id)

    def traces(self, limit_spans=None) -> dict:
        return self.ring.traces(limit_spans=limit_spans)


def make_span_dict(name: str, parent, start_s: float, duration_s: float,
                   **tags) -> dict:
    """Build a finished span AS A DICT, bypassing the process tracer — the
    worker half of cross-process stitching. A worker process (whose own
    tracer is usually the no-op default) still produces real spans for any
    request that arrived carrying a trace context; they ship back over the
    wire and the node's tracer ``ingest``s them into its ring. ``parent``
    is the wire ``(trace_id, span_id)`` tuple from the request."""
    trace_id, parent_id = _parent_ids(parent)
    if trace_id is None:
        trace_id = _new_id()
    return {"name": name, "trace_id": trace_id, "span_id": _new_id(),
            "parent_id": parent_id, "start_s": start_s,
            "duration_s": duration_s,
            "tags": {k: v for k, v in tags.items() if v is not None}}


# ---------------------------------------------------------------------------
# Process-global tracer seam
# ---------------------------------------------------------------------------

_TRACER = NOOP_TRACER


def get_tracer():
    """The process tracer — instrumentation sites call this per operation
    (NOT at import time) so enable/disable takes effect immediately."""
    return _TRACER


def set_tracer(tracer) -> None:
    global _TRACER
    _TRACER = tracer


def enable_tracing(capacity: int = 8192) -> Tracer:
    """Install (and return) a recording tracer."""
    tracer = Tracer(capacity)
    set_tracer(tracer)
    return tracer


def disable_tracing() -> None:
    """Back to the no-op tracer; previously recorded spans are dropped with
    the old tracer's ring."""
    set_tracer(NOOP_TRACER)
