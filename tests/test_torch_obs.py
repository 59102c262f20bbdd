"""The port's observability plane and bench tools against the JAX
package's: every case of the reference's tests of the time-series plane,
the critical-path extractor, the consensus observatory, the resource
accounting plane and the tools (tests/test_{timeseries,critpath,
consensus_obs,resprof,consensus_stat,fleetstat,benchguard,benchtrend}.py)
run on the port's twin of the file, and the two packages' functions
compared on the same inputs.

A twin is the reference test's source executed with every ``corda_tpu.``
module naming ``corda_tpu_torch.`` (tests/test_torch_raft.py's ``twin``);
a case takes its parameters from the reference's grid and its pytest
fixtures (``tmp_path``, ``caplog``, ``capsys``, ...) from this run
(``run_port_case``). The comparisons feed both packages the same span
trees (seeded), metric snapshots, replica stats, time series and bench
artifacts (the repository's ``*_r0N.json`` records), and require equal
outputs. The helpers serve tests/test_torch_ledger.py and
tests/test_torch_soak.py too."""
import copy
import inspect
import json
import random

import pytest

from test_torch_finance import reference_cases
from test_torch_flow_framework import PKGS, mod
from test_torch_raft import twin


def run_port_case(name: str, attr: str, params: dict, request,
                  subs: tuple = ()) -> None:
    """Case ``attr`` of tests/<name>.py on the port's twin (``subs`` as in
    ``twin``): parameters from ``params``, every other argument from this
    run's pytest fixtures."""
    fn = getattr(twin(name, subs), attr)
    kwargs = {p: params[p] if p in params else request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    fn(**kwargs)


PURE = ("test_timeseries", "test_critpath", "test_consensus_obs",
        "test_resprof", "test_consensus_stat", "test_fleetstat",
        "test_benchguard", "test_benchtrend")


@pytest.mark.parametrize("name,attr,params",
                         [c for name in PURE for c in reference_cases(name)])
def test_reference_case_on_the_port(name, attr, params, request):
    run_port_case(name, attr, params, request)


# -- the same inputs through both packages ------------------------------------

def both_call(path: str, fn: str, *args, **kwargs) -> dict:
    """{pkg: ``pkg``'s ``path.fn`` on deep copies of the same arguments}."""
    return {pkg: getattr(mod(pkg, path), fn)(*copy.deepcopy(args),
                                            **copy.deepcopy(kwargs))
            for pkg in PKGS}


def assert_equal_outputs(path: str, fn: str, *args, **kwargs):
    out = both_call(path, fn, *args, **kwargs)
    assert out["corda_tpu_torch"] == out["corda_tpu"], (path, fn)
    return out["corda_tpu"]


FLOWS = ("corda_tpu.finance.cash.CashIssueFlow",
         "corda_tpu.finance.cash.CashPaymentFlow",
         "corda_tpu.finance.trade.SellerFlow",
         "corda_tpu.flows.library.FinalityFlow")
NAMES = ("tx.verify", "notary.uniqueness", "raft.commit", "raft.submit",
         "vault.update", "wait.await_future", "wait.scheduler_admission",
         "wait.group_commit_queue", "wait.group_commit_round",
         "wait.verify_park", "batcher.flush", "session.send", "notary.commit")
WAIT_KINDS = (None, "scheduler.admission", "notary.commit", "verify",
              "group_commit.queue", "group_commit.round", "bogus")


def random_traces(seed: int, n: int = 40) -> dict:
    """``n`` seeded span trees: a flow.run root (sometimes missing or
    doubled), children and grandchildren at random offsets (overlapping,
    pre-root, zero-length), wait kinds, orphans and a parent cycle."""
    rng = random.Random(seed)
    traces = {}
    for t in range(n):
        tid = f"t{t}"
        spans = []
        if rng.random() > 0.05:
            spans.append({"name": "flow.run", "trace_id": tid,
                          "span_id": f"{tid}r", "parent_id": None,
                          "start_s": 0.0,
                          "duration_s": rng.uniform(0.0, 5.0),
                          "tags": {"flow_type": rng.choice(FLOWS)}})
        for i in range(rng.randrange(0, 12)):
            parent = rng.choice([s["span_id"] for s in spans] or [None])
            if rng.random() < 0.05:
                parent = f"{tid}missing"
            tags = {}
            kind = rng.choice(WAIT_KINDS)
            if kind is not None:
                tags["wait_kind"] = kind
            spans.append({"name": rng.choice(NAMES), "trace_id": tid,
                          "span_id": f"{tid}s{i}", "parent_id": parent,
                          "start_s": rng.uniform(-1.0, 4.0),
                          "duration_s": rng.choice(
                              [0.0, rng.uniform(0.0, 3.0)]),
                          "tags": tags})
        if len(spans) > 2 and rng.random() < 0.1:
            spans[1]["parent_id"] = spans[2]["span_id"]
            spans[2]["parent_id"] = spans[1]["span_id"]
        traces[tid] = spans
    return traces


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_critpath_equal_on_seeded_span_trees(seed):
    traces = random_traces(seed)
    for spans in traces.values():
        assert_equal_outputs("observability.critpath", "critical_path",
                             spans)
        for span in spans:
            assert_equal_outputs("observability.critpath", "component_of",
                                 span)
    for top_k in (1, 5):
        assert_equal_outputs("observability.critpath",
                             "aggregate_critpaths", traces, top_k=top_k)
        assert_equal_outputs("observability.critpath",
                             "ledger_critpath_fields", traces, top_k=top_k)
    report = assert_equal_outputs("observability.critpath",
                                  "critpath_report", traces)
    assert report["traces"] > 0
    assert_equal_outputs("tools.critpath", "render", report)
    for flow in FLOWS + (None, "", 7):
        assert_equal_outputs("observability.critpath", "flow_kind", flow)


def registry_snapshot(seed: int) -> dict:
    """A snapshot of the reference's MetricRegistry after seeded updates
    of every stage histogram and group-commit, shard and cross-shard
    family the stage functions read."""
    from corda_tpu.observability import stages
    from corda_tpu.utils.metrics import MetricRegistry
    rng = random.Random(seed)
    reg = MetricRegistry()
    names = [*stages.STAGE_METRICS.values(),
             *stages.LEDGER_STAGE_METRICS.values(), "verifier_batch_size",
             "ledger_commit_batch_size", "ledger_commit_batch_wait_seconds",
             "group_commit_round_seconds"]
    for name in names:
        hist = reg.histogram(name)
        for _ in range(rng.randrange(0, 40)):
            hist.update(rng.expovariate(50.0))
    for name in ("GroupCommit.Committed", "GroupCommit.RaftAppends",
                 "GroupCommit.Rejected", "GroupCommit.PreScreened",
                 "GroupCommit.Deferred", 'GroupCommit.Committed{shard="s0"}',
                 'GroupCommit.Committed{shard="s1"}',
                 'GroupCommit.Committed{shard="s3"}', "CrossShard.Committed",
                 "CrossShard.Aborted", "CrossShard.FinalizeConflict",
                 "CrossShard.Recovered"):
        reg.meter(name).mark(rng.randrange(0, 50))
    return reg.snapshot()


@pytest.mark.parametrize("seed", [4, 5])
def test_stage_fields_equal_on_one_snapshot(seed):
    snap = registry_snapshot(seed)
    assert_equal_outputs("observability.stages", "stage_percentiles", snap)
    out = assert_equal_outputs("observability.stages",
                               "ledger_stage_percentiles", snap)
    assert out
    assert_equal_outputs("observability.stages", "group_commit_fields",
                         snap)
    for n in (1, 2, 4):
        assert_equal_outputs("observability.stages", "ledger_shard_fields",
                             snap, n)
    for name in ("STAGE_METRICS", "LEDGER_STAGE_METRICS"):
        assert getattr(mod("corda_tpu_torch", "observability.stages"),
                       name) == getattr(mod("corda_tpu",
                                            "observability.stages"), name)


class FakeReplica:
    """A replica as the observatory reads it: ``stats()`` and
    ``attribution_samples()`` over fixed seeded values."""

    def __init__(self, rng, role: str, attributing: bool = True):
        self._stats = {
            "node": f"n{rng.randrange(100)}", "role": role,
            "term": rng.randrange(1, 9), "log_entries": rng.randrange(90),
            "elections_total": rng.randrange(4),
            "leader_tenure_s": rng.uniform(0, 30),
            "peer_lag": {"a": rng.randrange(5), "b": rng.randrange(5)},
            "snapshot_index": rng.randrange(64),
            "snapshots_taken": rng.randrange(5),
            "installs_sent": rng.randrange(3),
            "installs_received": rng.randrange(3),
            "snapshot_bytes": rng.randrange(1 << 16)}
        self._samples = None
        if attributing:
            n = rng.randrange(0, 30)
            comps = mod("corda_tpu", "observability.consensus_obs") \
                .ATTRIBUTION_COMPONENTS
            self._samples = {c: [rng.uniform(0, 0.01) for _ in range(n)]
                             for c in comps}
            self._samples["total"] = [
                sum(self._samples[c][i] for c in comps) for i in range(n)]

    def stats(self):
        return dict(self._stats)

    def attribution_samples(self):
        if self._samples is None:
            raise AttributeError("native replicas attribute nothing")
        return {k: list(v) for k, v in self._samples.items()}


class FakeSharded:
    def __init__(self, rng):
        self._heat = {"skew_index": rng.uniform(1, 2),
                      "coordinator_log_bytes": rng.randrange(1 << 14),
                      "shards": [], "touch_matrix": {}}

    def heat_stats(self):
        return dict(self._heat)


@pytest.mark.parametrize("seed", [6, 7])
def test_consensus_observatory_equal_on_the_same_replicas(seed):
    rng = random.Random(seed)
    groups = {f"s{s}": [FakeReplica(rng, role, attributing=s != 2)
                        for role in ("leader", "follower", "candidate")]
              for s in range(3)}
    sharded = FakeSharded(rng)
    rounds = [rng.uniform(0, 0.02) for _ in range(25)] + [None, "x"]
    assert_equal_outputs("observability.consensus_obs", "raft_report",
                         groups, sharded)
    assert_equal_outputs("observability.consensus_obs", "ledger_raft_fields",
                         groups, rounds)
    for nodes in groups.values():
        pooled = assert_equal_outputs("observability.consensus_obs",
                                      "pool_attribution", nodes)
        assert_equal_outputs("observability.consensus_obs",
                             "pooled_percentiles", pooled)
    stores = {pkg: mod(pkg, "observability.timeseries").TimeSeriesStore()
              for pkg in PKGS}
    watches = {pkg: mod(pkg, "observability.consensus_obs").GrowthWatch(
        floor=10.0) for pkg in PKGS}
    values = {}
    for tick in range(40):
        for replicas in groups.values():
            for r in replicas:
                r._stats["log_entries"] += rng.randrange(0, 20)
        for pkg in PKGS:
            values[pkg] = mod(pkg, "observability.consensus_obs") \
                .sample_timeseries(stores[pkg], groups, sharded,
                                   watch=watches[pkg], t=0.25 * tick)
        assert values["corda_tpu_torch"] == values["corda_tpu"]
    for pkg in PKGS:
        stores[pkg].flush()
    assert stores["corda_tpu_torch"].snapshot() == \
        stores["corda_tpu"].snapshot()
    assert watches["corda_tpu_torch"].warnings == \
        watches["corda_tpu"].warnings > 0
    raft = both_call("observability.consensus_obs", "raft_report", groups,
                     sharded)["corda_tpu"]
    assert_equal_outputs("tools.consensus_stat", "render", raft,
                         stores["corda_tpu"].snapshot())


def test_timeseries_equal_on_one_series():
    rng = random.Random(8)
    stores = {pkg: mod(pkg, "observability.timeseries").TimeSeriesStore(
        resolutions=((0.5, 16), (4.0, 8), (32.0, 4))) for pkg in PKGS}
    for step in range(600):
        t = step * 0.1
        name = rng.choice(["a", "b", 'c{x="1"}'])
        value = rng.choice([rng.uniform(-5, 5), 0, None, "junk", True])
        for store in stores.values():
            store.record(name, value, t=t)
    for limit in (None, 3):
        assert stores["corda_tpu_torch"].snapshot(limit=limit) == \
            stores["corda_tpu"].snapshot(limit=limit)
    for store in stores.values():
        store.flush()
    assert stores["corda_tpu_torch"].snapshot() == \
        stores["corda_tpu"].snapshot()
    assert stores["corda_tpu_torch"].names() == stores["corda_tpu"].names()


def test_fleetstat_renders_alike():
    import test_fleetstat as ref
    for fleet, metrics in ((ref.FLEET, ref.METRICS), ({}, {}),
                           ({**ref.FLEET, "degraded": True}, ref.METRICS)):
        assert_equal_outputs("tools.fleetstat", "render", fleet, metrics)


def test_benchguard_verdicts_equal_on_the_repo_records():
    """Both packages' gates on the repository's BENCH, MULTICHIP and LEDGER
    records: the same trajectories, fitted floors and verdicts, round by
    round against the rounds before it."""
    paths = both_call("tools.benchguard", "default_trajectory_paths")
    assert paths["corda_tpu_torch"] == paths["corda_tpu"] != []
    traj = assert_equal_outputs("tools.benchguard", "load_trajectory",
                                paths["corda_tpu"])
    for i, run in enumerate(traj):
        guards = assert_equal_outputs("tools.benchguard", "fit_guards",
                                      traj[:i])
        assert_equal_outputs("tools.benchguard", "check", run, guards)
        assert_equal_outputs("tools.benchguard", "schema_violations", run)
    mc = assert_equal_outputs("tools.benchguard",
                              "multichip_trajectory_paths")
    ledger = assert_equal_outputs("tools.benchguard",
                                  "ledger_trajectory_paths")
    assert mc and ledger
    for i, path in enumerate(mc):
        with open(path) as f:
            art = json.load(f)
        assert_equal_outputs("tools.benchguard", "guard_multichip",
                             art, mc[:i])
    for i, path in enumerate(ledger):
        with open(path) as f:
            art = json.load(f)
        run = art.get("parsed", art)
        assert_equal_outputs("tools.benchguard", "guard_ledger", run,
                             ledger[:i])
        assert_equal_outputs("tools.benchguard", "ledger_schema_violations",
                             run)
        assert_equal_outputs("tools.benchguard", "ledger_critpath_violations",
                             run)
        assert_equal_outputs("tools.benchguard", "guard_hot_state", run, [])


def test_benchtrend_tables_equal_on_the_repo_records():
    families = mod("corda_tpu", "tools.benchtrend").FAMILIES
    assert set(mod("corda_tpu_torch", "tools.benchtrend").FAMILIES) == \
        set(families)
    for family, (_, metrics) in families.items():
        rounds = assert_equal_outputs("tools.benchtrend", "load_rounds",
                                      family)
        assert_equal_outputs("tools.benchtrend", "trend_rows", rounds,
                             metrics)
        assert_equal_outputs("tools.benchtrend", "render_table", family,
                             rounds, metrics)
