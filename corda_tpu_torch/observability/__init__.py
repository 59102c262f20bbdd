"""Observability for the port's verification path: the span tracer
(tracing.py, ring.py), structured log lines (slog.py) and the kernel flight
recorder (profiling.py). Copies of corda_tpu.observability's modules of the
same names; profiling counts kernel launches instead of jit compiles."""
from .profiling import (KernelProfiler, OverlapTracker, get_profiler,
                        set_profiler)
from .ring import SpanRing
from .slog import jlog
from .tracing import (NOOP_SPAN, NOOP_TRACER, NoopTracer, Span, SpanContext,
                      Tracer, disable_tracing, enable_tracing, get_tracer,
                      set_tracer)

__all__ = ["KernelProfiler", "OverlapTracker", "get_profiler", "set_profiler",
           "SpanRing", "jlog", "NOOP_SPAN", "NOOP_TRACER", "NoopTracer", "Span",
           "SpanContext", "Tracer", "disable_tracing", "enable_tracing",
           "get_tracer", "set_tracer"]
