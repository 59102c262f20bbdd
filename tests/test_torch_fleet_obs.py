"""The port's fleet observability plane against the JAX package's: the
same event sequences, on explicit clocks, into RequestLog,
FleetMetricsFederation and SLOTracker of both packages give equal
``snapshot()`` / ``status()`` / ``alerts()``. The cases of
tests/test_lifecycle.py and tests/test_slo.py run here as parametrised
cases on both packages, with their assertions held on each."""
import json
import logging
import types

import pytest

from corda_tpu.observability import federation as j_federation
from corda_tpu.observability import lifecycle as j_lifecycle
from corda_tpu.observability import slo as j_slo
from corda_tpu.utils import metrics as j_metrics
from corda_tpu_torch import observability as t_observability
from corda_tpu_torch.observability import federation as t_federation
from corda_tpu_torch.observability import lifecycle as t_lifecycle
from corda_tpu_torch.observability import slo as t_slo
from corda_tpu_torch.utils import metrics as t_metrics

for _name in ("corda_tpu.observability.lifecycle",
              "corda_tpu_torch.observability.lifecycle"):
    logging.getLogger(_name).setLevel(logging.CRITICAL)


class Clock:
    """A hand-stepped clock, as tests/test_slo.py's."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture
def lifecycles(monkeypatch):
    """Both packages' lifecycle modules, their wall clock replaced by one
    stepped clock each (0.5 s an event), so the timelines' ``t`` fields
    compare too."""
    mods = []
    for mod in (j_lifecycle, t_lifecycle):
        tick = iter(range(10**6))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda tick=tick: 1700000000.0 + 0.5 * next(tick)))
        mods.append(mod)
    return mods


# -- RequestLog: the cases of tests/test_lifecycle.py -----------------------

def _run(log, vid):
    log.append(vid, "submitted")
    log.append(vid, "routed", worker="w0", reason="least-loaded")
    log.append(vid, "resolved", ok=True)


def _capacity_bound_and_whole_timeline_eviction(mod):
    log = mod.RequestLog(capacity=3)
    for vid in range(5):
        _run(log, vid)
    snap = log.snapshot()
    assert len(snap) == 3
    assert log.dropped == 2
    for tl in snap.values():
        assert [e["event"] for e in tl] == ["submitted", "routed", "resolved"]
    return log


def _resolved_timelines_evicted_before_in_flight(mod):
    log = mod.RequestLog(capacity=3)
    log.append(100, "submitted")
    _run(log, 101)
    _run(log, 102)
    _run(log, 103)
    snap = log.snapshot()
    assert "100" in snap and "101" not in snap
    assert "102" in snap and "103" in snap
    assert log.dropped == 1
    return log


def _in_flight_survives_heavy_churn_with_full_history(mod):
    cap = 8
    log = mod.RequestLog(capacity=cap)
    pinned = [1000, 1001, 1002]
    for vid in pinned:
        log.append(vid, "submitted")
    for i in range(200):
        _run(log, i)
        if i % 50 == 0:
            for vid in pinned:
                log.append(vid, "dispatched", worker=f"w{i % 3}", batch=i)
    for vid in pinned:
        log.append(vid, "resolved", ok=True)
    snap = log.snapshot()
    assert len(snap) <= cap
    for vid in pinned:
        events = [e["event"] for e in snap[str(vid)]]
        assert events[0] == "submitted" and events[-1] == "resolved"
        assert events.count("dispatched") == 4
        assert log.terminal_count(vid) == 1
    assert log.dropped == 200 + len(pinned) - cap
    return log


def _fifo_fallback_when_nothing_resolved(mod):
    log = mod.RequestLog(capacity=2)
    log.append(1, "submitted")
    log.append(2, "submitted")
    log.append(3, "submitted")
    snap = log.snapshot()
    assert sorted(snap) == ["2", "3"]
    assert log.dropped == 1
    return log


def _terminal_count_tracks_terminal_events(mod):
    log = mod.RequestLog(capacity=4)
    _run(log, 7)
    assert log.terminal_count(7) == 1
    assert mod.TERMINAL_EVENTS
    assert log.terminal_count(999) == 0
    return log


def _traced_events_and_limits(mod):
    """Events carrying a trace context record its trace id; None fields
    are left out; ``snapshot(limit)`` caps requests, newest first."""
    log = mod.RequestLog(capacity=16)
    for vid in range(6):
        log.append(vid, "submitted", trace=(f"{vid:032x}", "ab" * 8),
                   n_sigs=vid, worker=None)
        log.append(vid, "routed", est_load={"w0": 1.5, "w1": 0.0})
    with pytest.raises(ValueError):
        mod.RequestLog(capacity=0)
    assert list(log.snapshot(limit=2)) == ["5", "4"]
    assert log.snapshot(limit=-1) == {}
    assert log.events(3) == ["submitted", "routed"]
    assert len(log) == 6
    return log


LIFECYCLE_CASES = [_capacity_bound_and_whole_timeline_eviction,
                   _resolved_timelines_evicted_before_in_flight,
                   _in_flight_survives_heavy_churn_with_full_history,
                   _fifo_fallback_when_nothing_resolved,
                   _terminal_count_tracks_terminal_events,
                   _traced_events_and_limits]


@pytest.mark.parametrize("case", LIFECYCLE_CASES,
                         ids=[c.__name__.strip("_") for c in LIFECYCLE_CASES])
def test_request_log_matches_reference(case, lifecycles):
    want, got = (case(mod) for mod in lifecycles)
    assert got.snapshot() == want.snapshot()
    assert (len(got), got.dropped) == (len(want), want.dropped)
    assert t_lifecycle.TERMINAL_EVENTS == j_lifecycle.TERMINAL_EVENTS


# -- FleetMetricsFederation -------------------------------------------------

def _hist(count, total, mx, buckets, exemplars=None):
    out = {"type": "histogram", "count": count, "sum": total, "max": mx,
           "buckets": buckets}
    if exemplars is not None:
        out["exemplars"] = exemplars
    return out


#: (action, worker, entries) in order: reports, a restart whose counts go
#: backwards, a detach, and malformed pairs the federation skips.
FEDERATION_EVENTS = [
    ("ingest", "w0", {
        "SigBatcher.Checked": {"type": "meter", "count": 10,
                               "mean_rate": 2.5},
        "SigBatcher.Duration": {"type": "timer", "count": 4, "mean_s": 0.25,
                                "max_s": 0.5},
        "Verification.InFlight": {"type": "counter", "value": 3},
        "SigBatcher.ed25519.QueueDepth": {"type": "gauge", "value": 7,
                                          "max": 9},
        "Breaker.State.ed25519": {"type": "gauge_fn", "value": 0},
        "verifier_batch_size": _hist(
            5, 40.0, 16.0, [["1", 1], ["4", 2], ["16", 5], ["+Inf", 5]],
            {"16": {"trace_id": "aa", "value": 16.0, "ts": 10.0}}),
    }),
    ("ingest", "w1", [
        ["SigBatcher.Checked", {"type": "meter", "count": 6,
                                "mean_rate": 1.0}],
        ["SigBatcher.Duration", {"type": "timer", "count": 2,
                                 "mean_s": 0.5, "max_s": 0.75}],
        ["Verification.InFlight", {"type": "counter", "value": 1}],
        ["SigBatcher.ed25519.QueueDepth", {"type": "gauge", "value": 2,
                                           "max": 11}],
        ["Breaker.State.ed25519", {"type": "gauge_fn", "value": None}],
        ["verifier_batch_size", _hist(
            3, 100.0, 64.0, [["4", 1], ["64", 3], ["+Inf", 3]],
            {"64": {"trace_id": "bb", "value": 64.0, "ts": 12.0},
             "4": "not-a-dict"})],
        ["malformed"],
        ["no_fields", 7],
    ]),
    ("ingest", "w0", {
        "SigBatcher.Checked": {"type": "meter", "count": 25,
                               "mean_rate": 3.0},
        "SigBatcher.Duration": {"type": "timer", "count": 9, "mean_s": 0.2,
                                "max_s": 0.5},
        "verifier_batch_size": _hist(
            8, 60.0, 16.0, [["1", 2], ["4", 4], ["16", 8], ["+Inf", 8]],
            {"16": {"trace_id": "cc", "value": 12.0, "ts": 20.0}}),
    }),
    # w1 restarted: its counts went backwards and count in full
    ("ingest", "w1", {
        "SigBatcher.Checked": {"type": "meter", "count": 2,
                               "mean_rate": 0.5},
        "Verification.InFlight": {"type": "counter", "value": True},
    }),
    ("detach", "w0", None),
    ("ingest", "w2", {
        "SigBatcher.Checked": {"type": "meter", "count": 4,
                               "mean_rate": 4.0},
        "Unknown.Kind": {"type": "mystery", "count": 3},
    }),
]


def _federate(mod, events):
    fed = mod.FleetMetricsFederation()
    out = []
    for action, worker, entries in events:
        if action == "ingest":
            # over the wire: the JSON of the worker's snapshot
            fed.ingest(worker, json.loads(json.dumps(entries)))
        else:
            fed.detach(worker)
        out.append((fed.worker_count(), fed.snapshot()))
    return out


@pytest.mark.parametrize("upto", range(1, len(FEDERATION_EVENTS) + 1))
def test_federation_matches_reference(upto):
    events = FEDERATION_EVENTS[:upto]
    want = _federate(j_federation, events)
    got = _federate(t_federation, events)
    assert got == want
    assert want[-1][1]


def test_federation_of_live_registries_matches_reference():
    """Each package's own MetricRegistry snapshot, after the same marks,
    federates to the same aggregate families."""
    snaps = []
    for metrics, federation in ((j_metrics, j_federation),
                                (t_metrics, t_federation)):
        fed = federation.FleetMetricsFederation()
        for worker, n in (("w0", 3), ("w1", 5)):
            reg = metrics.MetricRegistry()
            reg.meter("SigBatcher.Checked").mark(n)
            reg.counter("Verification.InFlight").inc(n)
            reg.settable_gauge("SigBatcher.PrepActive").set(n)
            for v in range(n):
                reg.histogram("verifier_batch_size").update(2 ** v)
            fed.ingest(worker, json.loads(json.dumps(reg.snapshot())))
        snap = fed.snapshot()
        snaps.append({k: {f: v for f, v in e.items()
                          if f not in ("mean_rate", "exemplars")}
                      for k, e in snap.items()})
    assert snaps[1] == snaps[0]
    assert snaps[1]["Fleet.agg.SigBatcher.Checked"]["count"] == 8


# -- SLOTracker: the cases of tests/test_slo.py -----------------------------

def _make(mod, objectives=None, **kw):
    clock = Clock()
    kw.setdefault("windows_s", (10.0, 100.0))
    tracker = mod.SLOTracker(objectives=objectives or mod.DEFAULT_OBJECTIVES,
                             clock=clock, **kw)
    return tracker, clock


def _untouched_budget_is_100(mod):
    tracker, _ = _make(mod)
    for obj in tracker.objectives:
        assert tracker.error_budget_pct(obj) == 100.0
    assert tracker.alerts() == []
    assert tracker.status()["alerting"] is False
    return tracker


def _availability_budget_burns_with_failures(mod):
    avail = mod.SLObjective("availability", 0.9)
    tracker, _ = _make(mod, objectives=(avail,))
    for i in range(100):
        tracker.record(ok=(i % 10 != 0), latency_s=0.01)
    assert tracker.burn_rates(avail)[100.0] == pytest.approx(1.0)
    assert tracker.error_budget_pct(avail) == pytest.approx(0.0)
    return tracker


def _latency_objective_counts_slow_commits_as_bad(mod):
    lat = mod.SLObjective("latency_p99", 0.99, latency_ms=100.0)
    tracker, _ = _make(mod, objectives=(lat,))
    tracker.record(ok=True, latency_s=0.05)
    tracker.record(ok=True, latency_s=0.5)
    tracker.record(ok=False, latency_s=None)
    assert lat.is_bad(True, 0.5) and lat.is_bad(False, None)
    assert not lat.is_bad(True, 0.05)
    assert tracker.error_budget_pct(lat) < 100.0
    return tracker


def _events_age_out_of_the_window(mod):
    avail = mod.SLObjective("availability", 0.9)
    tracker, clock = _make(mod, objectives=(avail,))
    tracker.record(ok=False)
    assert tracker.error_budget_pct(avail) < 100.0
    clock.t += 101.0
    tracker.record(ok=True)
    assert tracker.error_budget_pct(avail) == 100.0
    return tracker


def _page_needs_both_windows_burning(mod):
    avail = mod.SLObjective("availability", 0.999)
    tracker, clock = _make(mod, objectives=(avail,))
    for _ in range(20):
        tracker.record(ok=False)
    clock.t += 50.0
    for _ in range(20):
        tracker.record(ok=True, latency_s=0.001)
    assert [a["severity"] for a in tracker.alerts()] == ["ticket"]
    for _ in range(20):
        tracker.record(ok=False)
    alerts = tracker.alerts()
    assert alerts and alerts[0]["severity"] == "page"
    assert tracker.status()["alerting"] is True
    return tracker


def _capacity_and_three_windows(mod):
    """A bounded event ring and a middle window: the oldest events fall
    out by capacity before the long window would drop them."""
    tracker, clock = _make(mod, windows_s=(5.0, 20.0, 60.0), capacity=50,
                           fast_burn=2.0, slow_burn=1.5)
    for i in range(80):
        clock.t += 0.5
        tracker.record(ok=i % 3 != 0, latency_s=0.002 * i)
    return tracker


SLO_CASES = [_untouched_budget_is_100,
             _availability_budget_burns_with_failures,
             _latency_objective_counts_slow_commits_as_bad,
             _events_age_out_of_the_window,
             _page_needs_both_windows_burning,
             _capacity_and_three_windows]


def _slo_view(mod, tracker):
    registry = (j_metrics if mod is j_slo else t_metrics).MetricRegistry()
    tracker.publish(registry)
    t = tracker.clock()
    return {"status": tracker.status(), "alerts": tracker.alerts(),
            "status_later": tracker.status(t + 30.0),
            "burn": [tracker.burn_rates(o) for o in tracker.objectives],
            "budget": [tracker.error_budget_pct(o, t + 7.0)
                       for o in tracker.objectives],
            "gauges": {k: v for k, v in registry.snapshot().items()
                       if k.startswith("SLO.")}}


@pytest.mark.parametrize("case", SLO_CASES,
                         ids=[c.__name__.strip("_") for c in SLO_CASES])
def test_slo_tracker_matches_reference(case):
    want = _slo_view(j_slo, case(j_slo))
    got = _slo_view(t_slo, case(t_slo))
    assert got == want
    assert "SLO.Alerting" in got["gauges"]


def test_publish_exports_gauges():
    tracker, _ = _make(t_slo)
    registry = t_metrics.MetricRegistry()
    tracker.publish(registry)
    tracker.record(ok=False)
    snap = registry.snapshot()
    assert "SLO.availability.ErrorBudgetPct" in snap
    assert "SLO.Alerting" in snap
    names = {n for n in snap if n.startswith("SLO.")}
    assert any("BurnRateShort" in n for n in names)
    assert any("BurnRateLong" in n for n in names)


@pytest.mark.parametrize("windows", [(60.0,), (300.0, 60.0)])
def test_window_validation(windows):
    for mod in (j_slo, t_slo):
        with pytest.raises(ValueError):
            mod.SLOTracker(windows_s=windows)


def test_package_exports():
    """The port's observability package exports the fleet plane and the
    span-dict helper the out-of-process worker builds its spans with."""
    assert t_observability.RequestLog is t_lifecycle.RequestLog
    assert t_observability.FleetMetricsFederation is \
        t_federation.FleetMetricsFederation
    assert t_observability.SLOTracker is t_slo.SLOTracker
    assert t_observability.SLObjective is t_slo.SLObjective
    assert t_observability.DEFAULT_OBJECTIVES == tuple(
        t_slo.SLObjective(o.name, o.target, o.latency_ms)
        for o in j_slo.DEFAULT_OBJECTIVES)
    span = t_observability.make_span_dict("worker.host_verify",
                                          ("a" * 32, "b" * 16), 1.0, 0.5,
                                          worker="w0")
    assert span["name"] == "worker.host_verify" and span["duration_s"] == 0.5
