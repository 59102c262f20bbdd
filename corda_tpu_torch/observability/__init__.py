"""Observability for the port's verification path: the span tracer
(tracing.py, ring.py), structured log lines (slog.py), the kernel flight
recorder (profiling.py), the verifier fleet's per-request timelines
(lifecycle.py), worker-metrics federation (federation.py), service-level
objectives (slo.py), and the resource accounting plane with its subsystem
CPU sampler (resprof.py, which every node's ServiceHub registers its probes
with). Copies of the reference package's observability modules of the same
names; profiling counts kernel launches instead of jit compiles."""
from .federation import FleetMetricsFederation
from .lifecycle import RequestLog
from .profiling import (KernelProfiler, OverlapTracker, get_profiler,
                        set_profiler)
from .resprof import (COMMIT_PATH_COMPONENTS, CPU_COMPONENTS,
                      ResourceRegistry, SubsystemProfiler, classify_stack,
                      get_resources, leak_verdict, process_rss_bytes,
                      set_resources, theil_sen_slope)
from .ring import SpanRing
from .slo import DEFAULT_OBJECTIVES, SLObjective, SLOTracker
from .slog import jlog
from .tracing import (NOOP_SPAN, NOOP_TRACER, NoopTracer, Span, SpanContext,
                      Tracer, disable_tracing, enable_tracing, get_tracer,
                      make_span_dict, set_tracer)

__all__ = ["COMMIT_PATH_COMPONENTS", "CPU_COMPONENTS", "ResourceRegistry",
           "SubsystemProfiler", "classify_stack", "get_resources",
           "leak_verdict", "process_rss_bytes", "set_resources",
           "theil_sen_slope", "DEFAULT_OBJECTIVES", "FleetMetricsFederation", "KernelProfiler",
           "OverlapTracker", "RequestLog", "SLObjective", "SLOTracker",
           "get_profiler", "set_profiler", "SpanRing", "jlog", "NOOP_SPAN",
           "NOOP_TRACER", "NoopTracer", "Span", "SpanContext", "Tracer",
           "disable_tracing", "enable_tracing", "get_tracer",
           "make_span_dict", "set_tracer"]
