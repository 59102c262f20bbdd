"""The port's ledger scenario harness against the JAX package's: every case
of tests/test_ledger_harness.py and tests/test_chaos_ledger.py on the
port's twin of the file (tests/test_torch_obs.py's ``run_port_case``),
with each scenario's nodes and shared verifier on the CPU (``device=
"cpu"``: the batcher's host route below its crossover, as the reference
tests leave it), and the two packages compared where a run allows it.

A scenario runs on the wall clock and on threads: its latencies, rates,
chaos ``faults_fired`` and critical-path blame differ from run to run, so
they are not compared across packages. What is compared exactly: the
operation list ``_build_ops`` makes for a seed and preset; the report's key
set and field types; the invariants; the span chains of the commit path
in a stitched trace; and the stage, critical-path and consensus fields
that both packages' functions compute from the inputs the port's run
handed its own (its tracer's traces, its registry's snapshot, its
replicas). The port's report must also pass the reference's schema gates
(``ledger_schema_violations``, ``ledger_critpath_violations``).

The smoke shape offers its first payments 0.4 s after the first
funding issue. In a process that has not yet imported the flow, vault
and host-verify modules, the first verifications take longer than that,
and in either package two or three payments then fail for want of cash
(``ops_failed`` 2-3 in a fresh process, 0 after). The reference test
passes in the suite because earlier files warmed its worker; here a
module fixture warms the process the same way (``_warm``) before any
scenario runs."""
import dataclasses
import importlib

import pytest

from test_torch_flow_framework import PKGS, mod
from test_torch_finance import reference_cases
from test_torch_obs import run_port_case

LEDGER_SUBS = (("    return LedgerScenarioConfig(**kw)\n",
                '    return LedgerScenarioConfig(device="cpu", **kw)\n'),
               ("    cfg = LedgerScenarioConfig.hot_state()\n",
                "    cfg = LedgerScenarioConfig.hot_state()\n"
                '    cfg.device = "cpu"\n'))
CHAOS_SUBS = (("LedgerScenarioConfig(seed=seed, chaos=True,\n",
               'LedgerScenarioConfig(seed=seed, chaos=True, device="cpu",\n'),)


@pytest.fixture(autouse=True, scope="module")
def _warm():
    """Import what a scenario imports at its first verification and run
    one host verify in each package (see the module docstring)."""
    for pkg in PKGS:
        for path in ("finance", "finance.trade", "node.vault", "node.audit",
                     "node.notary", "node.statemachine", "flows.library",
                     "consensus.raft_uniqueness", "consensus.commit_pipeline",
                     "consensus.sharded_uniqueness", "verifier.service",
                     "testing"):
            mod(pkg, path)
        crypto = mod(pkg, "core.crypto")
        key = crypto.generate_keypair(entropy=b"warm" * 8)
        sig = crypto.Crypto.do_sign(key.private, b"warm")
        assert crypto.Crypto.is_valid(key.public, sig, b"warm")


@pytest.mark.ledger
@pytest.mark.parametrize("name,attr,params",
                         reference_cases("test_ledger_harness"))
def test_ledger_case_on_the_port(name, attr, params, request):
    run_port_case(name, attr, params, request, LEDGER_SUBS)


@pytest.mark.chaos
@pytest.mark.ledger
@pytest.mark.parametrize("name,attr,params",
                         reference_cases("test_chaos_ledger"))
def test_chaos_ledger_case_on_the_port(name, attr, params, request):
    run_port_case(name, attr, params, request, CHAOS_SUBS)


def _presets(pkg: str, seed: int) -> dict:
    cfg = mod(pkg, "observability.ledger_harness").LedgerScenarioConfig
    return {"default": cfg(seed=seed), "full": cfg.full(seed=seed),
            "full_quiet": cfg.full(seed=seed, chaos=False),
            "sharded": cfg.sharded(seed=seed),
            "sharded_full": cfg.sharded(shards=4, cross_shard_pct=0.5,
                                        seed=seed, full=True),
            "byzantine": cfg.byzantine(seed=seed),
            "byzantine_full": cfg.byzantine(seed=seed, full=True),
            "hot_state": cfg.hot_state(seed=seed),
            "hot_state_full": cfg.hot_state(seed=seed, full=True)}


def _plain(value):
    """A config field with each package's SLObjectives as tuples."""
    if isinstance(value, tuple):
        return tuple(dataclasses.astuple(v) if dataclasses.is_dataclass(v)
                     else v for v in value)
    return value


def _ops(pkg: str, cfg) -> list:
    lh = mod(pkg, "observability.ledger_harness")
    return [(o.kind, o.seq, o.intended_s, o.initiator, o.counterparty,
             o.big, o.step) for o in lh._build_ops(cfg)]


@pytest.mark.parametrize("seed", [7, 101, 9001])
def test_build_ops_equal_for_every_preset(seed):
    presets = {pkg: _presets(pkg, seed) for pkg in PKGS}
    for name, ref_cfg in presets["corda_tpu"].items():
        port_cfg = presets["corda_tpu_torch"][name]
        fields = {f: _plain(getattr(ref_cfg, f))
                  for f in ref_cfg.__dataclass_fields__}
        assert {f: _plain(getattr(port_cfg, f)) for f in fields} == fields, \
            name
        assert port_cfg.device == "cuda"
        ops = _ops("corda_tpu_torch", port_cfg)
        assert ops == _ops("corda_tpu", ref_cfg), name
        assert len(ops) == ref_cfg.operations


# -- one smoke run of each package --------------------------------------------

SMOKE = dict(parties=2, coins_per_party=2, operations=8,
             rate_tx_per_sec=10.0, max_duration_s=60.0)


@pytest.fixture(scope="module")
def runs():
    """{pkg: (report, {captured: inputs}, traces)}: a smoke scenario of
    each package; the port's hands its report functions' inputs to a spy,
    and each package's tracer hands its traces to the stitching check."""
    out = {}
    for pkg in PKGS:
        lh = mod(pkg, "observability.ledger_harness")
        obs = mod(pkg, "observability.consensus_obs")
        seen = {}
        traces = {}
        with pytest.MonkeyPatch.context() as mp:
            stitch = lh.connected_commit_traces

            def keep(found, *args, stitch=stitch, **kwargs):
                traces.update(found)
                return stitch(found, *args, **kwargs)
            mp.setattr(lh, "connected_commit_traces", keep)
            if pkg == "corda_tpu_torch":
                for name in ("ledger_critpath_fields",
                             "ledger_stage_percentiles",
                             "group_commit_fields", "ledger_shard_fields"):
                    mp.setattr(lh, name, _spy(seen, name, getattr(lh, name)))
                mp.setattr(obs, "ledger_raft_fields",
                           _spy(seen, "ledger_raft_fields",
                                obs.ledger_raft_fields))
            kw = dict(SMOKE, device="cpu") if pkg == "corda_tpu_torch" \
                else SMOKE
            report = lh.run_ledger_scenario(lh.LedgerScenarioConfig(**kw))
        out[pkg] = (report, seen, traces)
    return out


def _spy(seen: dict, name: str, fn):
    def call(*args, **kwargs):
        seen[name] = (args, kwargs)
        return fn(*args, **kwargs)
    return call


def _kind(v) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, (int, float)):
        return "number"
    return type(v).__name__


def test_smoke_reports_have_the_same_fields(runs):
    ref, port = runs["corda_tpu"][0], runs["corda_tpu_torch"][0]
    assert sorted(port) == sorted(ref)
    assert {k: _kind(v) for k, v in port.items()} == \
        {k: _kind(v) for k, v in ref.items()}
    for report in (ref, port):
        assert report["exactly_once_ok"] and report["replicas_agree"]
        assert report["counter_invariant_ok"]
        assert report["stitched_traces"] >= 1


def test_port_smoke_report_passes_the_reference_schema_gates(runs):
    report = runs["corda_tpu_torch"][0]
    for pkg in PKGS:
        guard = mod(pkg, "tools.benchguard")
        assert guard.ledger_schema_violations(report) == [], pkg
        assert guard.ledger_critpath_violations(report) == [], pkg


def _commit_chains(spans) -> set:
    """Each commit-path span's chain of names up its parent pointers."""
    names = set(mod("corda_tpu", "observability.ledger_harness")
                .COMMIT_PATH_SPANS)
    by_id = {s["span_id"]: s for s in spans}
    chains = set()
    for span in spans:
        if span["name"] not in names:
            continue
        chain, cur = [], span
        while cur is not None and len(chain) < 64:
            chain.append(cur["name"])
            cur = by_id.get(cur["parent_id"])
        chains.add(tuple(chain))
    return chains


def _chains_by_flow(pkg: str, traces: dict) -> dict:
    """{root flow class without its package: the commit-path chains of
    every stitched trace whose root ``flow.run`` is that flow}."""
    lh = mod(pkg, "observability.ledger_harness")
    out: dict = {}
    for tid in lh.connected_commit_traces(traces):
        spans = traces[tid]
        ids = {s["span_id"] for s in spans}
        for root in spans:
            if root["name"] == "flow.run" and root["parent_id"] not in ids:
                flow = root["tags"]["flow_type"].split(".", 1)[1]
                out.setdefault(flow, set()).update(_commit_chains(spans))
    return out


def test_stitched_commit_path_matches_the_reference(runs):
    """The commit path's spans hang off the same parents in both
    packages' stitched traces: no stage or parent link of the reference's
    is missing from the port's. Traces are compared by the flow at their
    root (the notarised payments, the paper's issuance, the trade): which
    transaction stitches first depends on timing, and under load a cold
    process's first payments may fail for want of cash."""
    ref = _chains_by_flow("corda_tpu", runs["corda_tpu"][2])
    port = _chains_by_flow("corda_tpu_torch", runs["corda_tpu_torch"][2])
    both_ran = sorted(ref.keys() & port.keys())
    assert both_ran
    for flow in both_ran:
        assert ref[flow] and port[flow] == ref[flow], flow


def test_report_functions_equal_on_the_ports_run(runs):
    """The reference's stage, critical-path and consensus functions give
    the port's own fields on the inputs the port's run handed its
    functions: its traces, its registry snapshot and its replicas."""
    report, seen, _ = runs["corda_tpu_torch"]
    assert set(seen) == {"ledger_critpath_fields", "ledger_stage_percentiles",
                         "group_commit_fields", "ledger_shard_fields",
                         "ledger_raft_fields"}
    paths = {"ledger_critpath_fields": "observability.critpath",
             "ledger_raft_fields": "observability.consensus_obs"}
    for name, (args, kwargs) in seen.items():
        fn = getattr(importlib.import_module(
            "corda_tpu." + paths.get(name, "observability.stages")), name)
        fields = fn(*args, **kwargs)
        assert fields, name
        for key, value in fields.items():
            assert report[key] == value, (name, key)


def test_a_stopped_replica_drops_a_delivery_in_flight(tmp_path):
    """The harness's replica_restart window stops a replica and closes its
    durable store on the driving thread while the replicas' pump thread may
    be inside a delivery to it (the bus hands the callback out before the
    handler is removed). That delivery must be dropped: applied, it would
    append to the closed store and raise in the pump thread, which then
    stops ticking every replica. The reference's RaftNode applies it (the
    same copy of the harness stalls on it); the port's drops it."""
    from corda_tpu_torch.consensus.raft import LEADER, RaftNode
    from corda_tpu_torch.consensus.raft_store import RaftLogStore
    from corda_tpu_torch.network.inmemory import InMemoryMessagingNetwork
    bus = InMemoryMessagingNetwork()
    names = [f"raft{i}" for i in range(3)]
    nodes = [RaftNode(n, list(names), bus.create_node(n), lambda e: e,
                      seed=i, storage=RaftLogStore(str(tmp_path / f"{n}.kv")))
             for i, n in enumerate(names)]

    def pump(ticks):
        for _ in range(ticks):
            for node in nodes:
                node.tick()
            bus.run_network()
    for _ in range(300):
        pump(1)
        if sum(n.role == LEADER for n in nodes) == 1:
            break
    leader = next(n for n in nodes if n.role == LEADER)
    follower = next(n for n in nodes if n is not leader)
    leader.submit("entry")
    in_flight = []
    for _ in range(50):
        leader.tick()
        queue = bus._queues[follower.node_id]
        if queue:
            in_flight.append(queue.popleft().message)
            break
    assert in_flight, "the leader sent the follower nothing"
    deliver = follower._on_message          # the callback the bus handed out
    before = follower.state.last_index()
    follower.stop()
    follower.storage.close()
    deliver(in_flight[0])
    assert follower.state.last_index() == before


def test_a_decided_commit_outlives_a_finalize_timeout():
    """A cross-shard commit whose finalize round times out after the
    commit decision (an append lost in a partition or drop window, as in
    the soak's recurring chaos) completes: the coordinator submits the
    idempotent round again. The reference's coordinator raises instead
    and leaves the transaction in doubt, its reservations held until
    recover_in_doubt(); its client, told the commit failed, spends the
    same coins again and parks behind them, and the soak waits out its
    max_duration_s (ROADMAP §C)."""
    from test_torch_raft import twin
    chaos = twin("test_chaos_sharded_notary")
    cluster = chaos._ShardedCluster(7)
    provider = None
    try:
        provider = cluster.build_provider()
        r0, r1 = chaos._ref_on(0, "ft"), chaos._ref_on(1, "ft")
        tx = chaos._tx("ft")
        orig = provider._round
        lost = []

        def lose_first_finalize(shard, command, trace_ctx, phase, n_states):
            if phase == "finalize" and not lost:
                lost.append(shard)
                raise TimeoutError("the finalize append was lost")
            return orig(shard, command, trace_ctx, phase, n_states)
        provider._round = lose_first_finalize
        assert provider.commit([r0, r1], tx, "chaos") is None
        assert lost == [0]
        assert provider.log.in_doubt() == []
        cluster.wait_shards_converged()
        assert cluster.owner_of(r0) == tx and cluster.owner_of(r1) == tx
    finally:
        if provider is not None:
            provider.close()
        cluster.close()
