"""Observability for the port: the span tracer (tracing.py, ring.py),
structured log lines (slog.py), the kernel flight recorder (profiling.py),
the verifier fleet's per-request timelines (lifecycle.py), worker-metrics
federation (federation.py), service-level objectives (slo.py), the resource
accounting plane with its subsystem CPU sampler (resprof.py, which every
node's ServiceHub registers its probes with), per-stage percentiles of the
commit path (stages.py), critical-path blame over stitched span trees
(critpath.py), the retained time-series plane (timeseries.py), the consensus
observatory (consensus_obs.py), the open-loop ledger scenario harness
(ledger_harness.py) and the drift-gated soak (soak.py). Copies of the
reference package's observability modules of the same names; profiling
counts kernel launches instead of jit compiles, and the harness and the soak
take the device of their nodes and shared verifier (``device=``, default
"cuda")."""
from .consensus_obs import (ATTRIBUTION_COMPONENTS, GrowthWatch,
                            install_raft_collector, ledger_raft_fields,
                            raft_report, sample_timeseries)
from .critpath import (COMPONENTS, WAIT_KINDS, aggregate_critpaths,
                       component_of, critical_path, critpath_report,
                       flow_kind, ledger_critpath_fields)
from .federation import FleetMetricsFederation
from .lifecycle import RequestLog
from .profiling import (KernelProfiler, OverlapTracker, get_profiler,
                        set_profiler)
from .resprof import (COMMIT_PATH_COMPONENTS, CPU_COMPONENTS,
                      ResourceRegistry, SubsystemProfiler, classify_stack,
                      get_resources, leak_verdict, process_rss_bytes,
                      set_resources, theil_sen_slope)
from .ring import SpanRing
from .slog import jlog
from .soak import SoakConfig, SoakObserver, run_soak, soak_report
from .slo import DEFAULT_OBJECTIVES, SLObjective, SLOTracker
from .stages import (LEDGER_STAGE_METRICS, STAGE_METRICS,
                     ledger_stage_percentiles, stage_percentiles)
from .timeseries import (TimeSeries, TimeSeriesStore, get_timeseries,
                         set_timeseries)
from .tracing import (NOOP_SPAN, NOOP_TRACER, NoopTracer, Span, SpanContext,
                      Tracer, disable_tracing, enable_tracing, get_tracer,
                      make_span_dict, set_tracer)

__all__ = [
    "ATTRIBUTION_COMPONENTS", "COMMIT_PATH_COMPONENTS", "COMPONENTS",
    "CPU_COMPONENTS", "DEFAULT_OBJECTIVES",
    "FleetMetricsFederation", "GrowthWatch",
    "KernelProfiler", "LEDGER_STAGE_METRICS", "NOOP_SPAN", "NOOP_TRACER",
    "NoopTracer", "OverlapTracker", "RequestLog", "ResourceRegistry",
    "SLObjective",
    "SLOTracker", "SoakConfig", "SoakObserver", "Span", "SpanContext",
    "SpanRing", "STAGE_METRICS", "SubsystemProfiler",
    "TimeSeries", "TimeSeriesStore",
    "Tracer", "WAIT_KINDS", "aggregate_critpaths", "classify_stack",
    "component_of",
    "critical_path", "critpath_report", "disable_tracing",
    "enable_tracing", "flow_kind", "get_profiler", "get_resources",
    "get_timeseries",
    "get_tracer", "install_raft_collector", "jlog", "leak_verdict",
    "ledger_critpath_fields", "ledger_raft_fields",
    "ledger_stage_percentiles", "make_span_dict", "process_rss_bytes",
    "raft_report", "run_soak",
    "sample_timeseries", "set_profiler", "set_resources",
    "set_timeseries", "set_tracer", "soak_report",
    "stage_percentiles", "theil_sen_slope",
]
