"""The port's verifier fleet against the JAX package's.

Every case of tests/test_chaos_fleet.py and tests/test_chaos_controller.py
runs at seeds 7, 101 and 9001 on both packages (each with its own bus,
fault injector and tracer), keeping the reference tests' assertions on
each; the two packages must give the same futures' outcomes and the same
exactly-once counts. Then ``fleet_bench`` on both (the port's two workers
on ``devices=[cpu, cpu]``, the plain PyTorch kernels) gives the same
fields; ``InProcessFleet`` without ``devices`` raises where CUDA is absent
before any worker attaches; and the graft twin on a CPU mesh of 2 ends
with ``fleet_bench``'s JSON line.

Keys are made by each package from the same seeds; ledger transactions
cross to the port as ``serialize`` bytes. Fleet workers take the host
route, so no JAX kernel is traced."""
import json
import threading
import time
import types

import pytest
import torch

from corda_tpu.core.serialization import serialize as j_serialize
from corda_tpu.network.inmemory import InMemoryMessagingNetwork as JBus
from corda_tpu.observability import Tracer as JTracer
from corda_tpu.observability import get_tracer as j_get_tracer
from corda_tpu.observability import set_tracer as j_set_tracer
from corda_tpu.testing import faults as j_faults
from corda_tpu.verifier import fleet as j_fleet
from corda_tpu.verifier import out_of_process as j_oop
from corda_tpu.verifier.batcher import SignatureBatcher as JBatcher
from corda_tpu_torch.core.serialization import deserialize as t_deserialize
from corda_tpu_torch.core.serialization import serialize as t_serialize
from corda_tpu_torch.network.inmemory import \
    InMemoryMessagingNetwork as TBus
from corda_tpu_torch.observability import Tracer as TTracer
from corda_tpu_torch.observability import get_tracer as t_get_tracer
from corda_tpu_torch.observability import set_tracer as t_set_tracer
from corda_tpu_torch.testing import faults as t_faults
from corda_tpu_torch.verifier import fleet as t_fleet
from corda_tpu_torch.verifier import controller as t_ctl
from corda_tpu_torch.verifier import out_of_process as t_oop
from corda_tpu_torch.verifier.batcher import SignatureBatcher as TBatcher

from test_oop_verifier import make_ltx

SEEDS = [7, 101, 9001]
GROUPS = 12
GROUP_SIZE = 4

JAX = types.SimpleNamespace(
    name="jax", Bus=JBus, oop=j_oop, fleet=j_fleet, faults=j_faults,
    Tracer=JTracer, get_tracer=j_get_tracer, set_tracer=j_set_tracer,
    host_batcher=lambda: JBatcher(use_device=False, max_latency_s=0.002),
    worker=lambda node, queue: j_oop.VerifierWorker(node, queue),
    convert=lambda obj: obj, kill_storm_kwargs={})
PORT = types.SimpleNamespace(
    name="port", Bus=TBus, oop=t_oop, fleet=t_fleet, faults=t_faults,
    Tracer=TTracer, get_tracer=t_get_tracer, set_tracer=t_set_tracer,
    host_batcher=lambda: TBatcher(use_device=False, max_latency_s=0.002,
                                  device="cpu"),
    worker=lambda node, queue: t_oop.VerifierWorker(node, queue,
                                                    device="cpu"),
    convert=lambda obj: t_deserialize(j_serialize(obj)),
    kill_storm_kwargs={"use_device": False})


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- tests/test_chaos_fleet.py's harness, on either package -------------------

def _host_worker(pkg, bus, name, max_inflight_groups=1):
    return pkg.oop.VerifierWorker(
        bus.create_node(name), "node", batcher=pkg.host_batcher(),
        use_device=False, capacity=1,
        max_inflight_groups=max_inflight_groups)


def _pump_until(bus, futures, workers=(), timeout=60.0):
    deadline = time.monotonic() + timeout
    last_report = 0.0
    while not all(f.done() for f in futures):
        bus.run_network()
        now = time.monotonic()
        if now - last_report > 0.01:
            last_report = now
            for w in workers:
                if w._alive:
                    w.send_load_report()
        time.sleep(0.002)
        assert time.monotonic() < deadline, \
            "fleet verifications did not complete"


def _exactly_once(svc, futures):
    """The reference's exactly-once witness, as a record to compare."""
    outcomes = [f.result(timeout=1) for f in futures]
    assert outcomes == [None] * len(futures)
    snap = svc.metrics.snapshot()
    success = snap["Verification.Success"]["count"]
    failure = snap.get("Verification.Failure", {}).get("count", 0)
    assert success == len(futures)
    assert failure == 0
    return {"outcomes": outcomes, "success": success, "failure": failure}


def worker_killed_mid_batch_fleet(pkg, seed):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    svc.queue.redelivery_timeout_s = 0.1
    w1 = w2 = None
    try:
        w1 = _host_worker(pkg, bus, "w1")
        w2 = _host_worker(pkg, bus, "w2")
        bus.run_network()
        assert svc.queue.worker_count == 2
        checks = pkg.fleet.make_sig_checks(GROUP_SIZE, seed=seed)
        with pkg.faults.inject(pkg.faults.FaultRule(
                "oop.reply", "drop", detail="w1->*"), seed=seed):
            futures = [svc.verify_signatures(checks) for _ in range(GROUPS)]
            bus.run_network()
            w1.stop(announce=False)
            end = time.monotonic() + 0.25
            while time.monotonic() < end:
                bus.run_network()
                time.sleep(0.01)
            svc.queue.requeue_overdue()
            _pump_until(bus, futures, workers=[w2])
        out = _exactly_once(svc, futures)
        assert svc.queue.worker_count == 1
        assert w2.processed_sig_count >= GROUPS * GROUP_SIZE // 2
        return {**out, "workers": svc.queue.worker_count}
    finally:
        for w in (w1, w2):
            if w is not None and w._alive:
                w.stop(announce=False)
        svc.shutdown()


def worker_join_steals_from_bulk_backlog(pkg, seed):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    try:
        w1 = _host_worker(pkg, bus, "w1")
        bus.run_network()
        checks = pkg.fleet.make_sig_checks(GROUP_SIZE, seed=seed)
        futures = [svc.verify_signatures(checks) for _ in range(GROUPS)]
        bus.run_network()
        w1.send_load_report()
        bus.run_network()
        w2 = _host_worker(pkg, bus, "w2")
        bus.run_network()
        svc.queue.STEAL_TIMEOUT_S = 0.01
        with pkg.faults.inject(pkg.faults.FaultRule(
                "oop.deliver", "drop", detail="->w1", count=1),
                seed=seed) as inj:
            w2.send_load_report()
            bus.run_network()
            fired = inj.fired("oop.deliver")
            assert fired == 1
        time.sleep(0.02)
        _pump_until(bus, futures, workers=[w1, w2])
        out = _exactly_once(svc, futures)
        assert svc.metrics.meter("Fleet.Steals").count >= 1
        assert w2.processed_sig_count > 0
        w1.stop(announce=False)
        w2.stop(announce=False)
        return {**out, "fired": fired}
    finally:
        svc.shutdown()


def steal_racing_requeue_resolves_exactly_once(pkg, seed):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    try:
        w1 = _host_worker(pkg, bus, "w1")
        bus.run_network()
        checks = pkg.fleet.make_sig_checks(GROUP_SIZE, seed=seed)
        futures = [svc.verify_signatures(checks) for _ in range(GROUPS)]
        bus.run_network()
        w1.send_load_report()
        bus.run_network()
        w2 = _host_worker(pkg, bus, "w2")
        bus.run_network()
        bus.run_network()
        with pkg.faults.inject(pkg.faults.FaultRule(
                "net.send", "duplicate", detail="w1->node"), seed=seed):
            w2.send_load_report()
            while True:
                t = bus.pump_receive("node")
                assert t is not None, "load report never reached the node"
                if t.sender == "w2":
                    break
            assert bus.pump_receive("w1") is not None
            svc.queue.redelivery_timeout_s = 0.05
            time.sleep(0.12)
            svc.queue.requeue_overdue()
            assert svc.queue.worker_count == 1
            _pump_until(bus, futures, workers=[w2])
        out = _exactly_once(svc, futures)
        stolen = svc.metrics.meter("Fleet.Stolen").count
        assert stolen == 0
        w1.stop(announce=False)
        w2.stop(announce=False)
        return {**out, "stolen": stolen}
    finally:
        svc.shutdown()


def stolen_request_yields_one_stitched_trace(pkg, seed):
    prev_tracer = pkg.get_tracer()
    tracer = pkg.Tracer()
    pkg.set_tracer(tracer)
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    w1 = w2 = None
    try:
        w1 = _host_worker(pkg, bus, "w1")
        bus.run_network()
        checks = pkg.fleet.make_sig_checks(GROUP_SIZE, seed=seed)
        futures = [svc.verify_signatures(checks) for _ in range(GROUPS)]
        bus.run_network()
        w1.send_load_report()
        bus.run_network()
        w2 = _host_worker(pkg, bus, "w2")
        bus.run_network()
        w2.send_load_report()
        bus.run_network()
        _pump_until(bus, futures, workers=[w1, w2])
        outcomes = [f.result(timeout=1) for f in futures]
        assert outcomes == [None] * len(futures)
        assert svc.metrics.meter("Fleet.Stolen").count >= 1
        w1.send_load_report()
        bus.run_network()
        timelines = svc.request_log.snapshot()
        assert len(timelines) == len(futures)
        stolen_vids = [int(vid) for vid, tl in timelines.items()
                       if any(e["event"] == "stolen" for e in tl)]
        assert stolen_vids, "no request recorded a steal hop"
        terminal = [svc.request_log.terminal_count(int(v)) for v in timelines]
        assert terminal == [1] * len(timelines)
        assert svc._spans == {}
        for vid in stolen_vids:
            tl = timelines[str(vid)]
            stolen_ev = next(e for e in tl if e["event"] == "stolen")
            assert stolen_ev["victim"] == "w1"
            trace_id = next(e["trace_id"] for e in tl if "trace_id" in e)
            spans = tracer.trace(trace_id)
            names = [s["name"] for s in spans]
            assert names.count("verifier.oop_submit") == 1, names
            assert any(n.startswith("worker.") for n in names), names
            assert "worker.stolen" in names, names
            assert {s["trace_id"] for s in spans} == {trace_id}
        return {"outcomes": outcomes, "terminal": terminal}
    finally:
        for w in (w1, w2):
            if w is not None and w._alive:
                w.stop(announce=False)
        svc.shutdown()
        pkg.set_tracer(prev_tracer)


# -- tests/test_chaos_controller.py's cases -----------------------------------

def kill_storm_controller_restores_slo(pkg, seed):
    out = pkg.fleet.kill_storm_recovery(seed=seed, **pkg.kill_storm_kwargs)
    assert out["killed_workers"], "the storm killed nobody"
    assert out["lost_futures"] == 0, out
    assert out["failed_futures"] == 0, out
    assert out["controller_state"] == "steady", out
    assert out["recovered_within_bound"], out
    assert out["recovery_s"] is not None
    assert 0.0 < out["recovery_s"] <= out["recovery_bound_s"]
    assert out["controller_actions"] >= len(out["killed_workers"])
    assert out["episode_spans"] == 1, out
    assert out["episode_action_spans"] >= len(out["killed_workers"])
    return {k: out[k] for k in ("seed", "n_workers", "killed_workers",
                                "groups", "group_size", "lost_futures",
                                "failed_futures", "controller_state",
                                "recovery_bound_s", "recovered_within_bound",
                                "episode_spans")}


def silently_hung_worker_is_stale_detached(pkg, seed):
    # the transactions are built (and, for the port, carried across as
    # bytes) before the service's stale scanner starts, so building them
    # does not count against the workers' 0.12 s stale horizon
    ltxs = [pkg.convert(make_ltx(i)) for i in range(20)]
    bus = pkg.Bus()
    node = bus.create_node("node")
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        node, load_report_interval_s=0.02, stale_detach_intervals=2)
    try:
        w1 = pkg.worker(bus.create_node("w1"), "node")
        w2 = pkg.worker(bus.create_node("w2"), "node")
        bus.run_network()
        assert svc.queue.worker_count == 2
        with pkg.faults.inject(pkg.faults.FaultRule(
                "oop.reply", "drop", detail="w1->*"), seed=seed) as inj:
            futures = [svc.verify(ltx) for ltx in ltxs]
            bus.run_network()
            fired = inj.fired("oop.reply")
            assert fired == 10
            done_early = sum(f.done() for f in futures)
            assert done_early == 10
            deadline = time.monotonic() + 0.15
            while time.monotonic() < deadline:
                w2.send_load_report()
                bus.run_network()
                time.sleep(0.02)
            reaped = svc.reap_stale_workers()
            assert reaped in ([], ["w1"]), reaped
            assert svc.queue.worker_count == 1
            bus.run_network()
            outcomes = [f.result(timeout=5) for f in futures]
            assert outcomes == [None] * 20
        with svc.queue._lock:
            assert not svc.queue._pending
            assert not svc.queue._dealt_at
        detached = svc.metrics.snapshot()["Fleet.StaleDetached"]["count"]
        assert detached == 1
        w1.stop(announce=False)
        w2.stop(announce=False)
        return {"outcomes": outcomes, "fired": fired,
                "done_early": done_early, "detached": detached}
    finally:
        svc.shutdown()


CASES = [worker_killed_mid_batch_fleet, worker_join_steals_from_bulk_backlog,
         steal_racing_requeue_resolves_exactly_once,
         stolen_request_yields_one_stitched_trace,
         kill_storm_controller_restores_slo,
         silently_hung_worker_is_stale_detached]


@pytest.mark.chaos
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_chaos_case_matches_reference(case, seed):
    assert case(PORT, seed) == case(JAX, seed)


# -- fleet_bench, the fleet's device default and the graft twin ---------------

BENCH_FIELDS = {"fleet_verifies_per_sec", "scaling_efficiency_pct",
                "worker_busy_skew_pct", "n_workers", "n_devices",
                "fleet_steals", "fleet_stolen", "steals_total",
                "stitched_trace_depth", "groups", "group_size", "wall_s",
                "per_worker_sigs", "controller_state", "controller_actions",
                "recovery_s"}


def test_make_sig_checks_match_reference():
    want = j_fleet.make_sig_checks(20, unique=5, seed=9)
    got = t_fleet.make_sig_checks(20, unique=5, seed=9)
    assert [(k.encoded, s, c) for k, s, c in got] == \
        [(k.encoded, s, c) for k, s, c in want]


def test_fleet_bench_fields_match_reference():
    want = j_fleet.fleet_bench(2, groups=4, group_size=16)
    got = t_fleet.fleet_bench(2, groups=4, group_size=16,
                              devices=[torch.device("cpu")] * 2,
                              host_crossover=0)
    assert set(want) == BENCH_FIELDS
    assert set(got) == set(want)
    for out in (got, want):
        assert out["controller_state"] == "steady"
        assert out["controller_actions"] == 0
        assert out["stitched_trace_depth"] > 0
        assert sum(out["per_worker_sigs"].values()) == 5 * 16
        assert out["n_workers"] == 2
    assert got["n_devices"] == 2 and want["n_devices"] == 0


def test_fleet_workers_carry_their_device():
    """A port fleet's workers' batchers sit on the devices given, and each
    worker announces its shard (the device index, or its own index on the
    CPU)."""
    fleet = t_fleet.InProcessFleet(2, devices=["cpu", "cpu"])
    try:
        assert [b.device for b in fleet.batchers] == \
            [torch.device("cpu")] * 2
        deadline = time.monotonic() + 10
        while fleet.service.queue.worker_count < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        shards = {name: w["device_shard"] for name, w in
                  fleet.service.fleet_status()["workers"].items()}
        assert shards == {"w0": [0], "w1": [1]}
    finally:
        fleet.close()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
def test_fleet_without_devices_raises_before_any_worker_attaches(monkeypatch):
    spawned = []
    real = t_fleet.InProcessFleet._spawn_worker_locked

    def spy(self):
        spawned.append(True)
        return real(self)

    monkeypatch.setattr(t_fleet.InProcessFleet, "_spawn_worker_locked", spy)
    with pytest.raises(RuntimeError, match="cuda"):
        t_fleet.InProcessFleet(2)
    with pytest.raises(RuntimeError, match="cuda"):
        t_fleet.fleet_bench(2, groups=2, group_size=4)
    assert spawned == []
    # the host route asks for no card
    fleet = t_fleet.InProcessFleet(1, use_device=False)
    try:
        assert fleet.batchers[0].device == torch.device("cpu")
    finally:
        fleet.close()


def test_graft_twin_prints_fleet_bench_last(capsys, monkeypatch):
    """The graft twin at small sizes (the plain kernels run here). The
    configuration-built node's burst of 8 takes the device route with its
    batcher's crossover at 0 (the stage's 2048 clears the default 192)."""
    from corda_tpu_torch import graft_entry
    monkeypatch.setattr(graft_entry, "SERVICE_BATCH", 8)
    monkeypatch.setattr(graft_entry, "FLEET_GROUPS_PER_WORKER", 3)
    monkeypatch.setattr(graft_entry, "FLEET_GROUP_SIZE", 4)
    monkeypatch.setattr(graft_entry, "CONFIG_NODE_BURST", 8)
    real_init = TBatcher.__init__

    def device_route(self, *a, **kw):
        real_init(self, *a, **kw)
        self.host_crossover = 0

    monkeypatch.setattr(TBatcher, "__init__", device_route)
    config_nodes = []
    real_node = graft_entry._dryrun_config_mesh_node

    def config_node(*a, **kw):
        config_nodes.append((a, kw))
        return real_node(*a, **kw)

    monkeypatch.setattr(graft_entry, "_dryrun_config_mesh_node", config_node)
    fn, args = graft_entry.entry(device="cpu")
    assert fn(*args).tolist() == [True] * 8
    graft_entry.dryrun_multichip(2, devices=[torch.device("cpu")])
    assert config_nodes == [((1,), {"device": "cpu"})]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.strip()]
    last = json.loads(lines[-1])
    assert set(last) == BENCH_FIELDS
    assert last["n_workers"] == 2 and last["n_devices"] == 2
    assert all(c > 0 for c in last["per_worker_sigs"].values())


def _pump_stall(pkg, monkeypatch):
    """One worker's request handling holds the pump thread for 0.5 s (as
    decoding a 32768-signature request does in the port's pure-Python
    codec), against a stale horizon of 5 windows of 3 × 10 ms. Returns the
    stale detaches and controller actions that followed, and whether the
    group resolved."""
    real = pkg.oop.VerifierWorker._on_request
    stalls = []

    def slow_on_request(self, msg):
        if not stalls:
            stalls.append(self.network_service.my_address)
            time.sleep(0.5)
        return real(self, msg)

    monkeypatch.setattr(pkg.oop.VerifierWorker, "_on_request",
                        slow_on_request)
    kwargs = {"use_device": False, "report_every_s": 0.01}
    fleet = pkg.fleet.InProcessFleet(2, **kwargs)
    try:
        deadline = time.monotonic() + 10
        while fleet.service.queue.worker_count < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        ctl = fleet.attach_controller(
            slo=None, stale_detach_intervals=5,
            config=pkg.ctl.ControllerConfig(
                min_workers=2, max_workers=2, queue_high=float("inf"),
                queue_low=float("inf"), breakers_stress=False))
        fut = fleet.verify_signatures(pkg.fleet.make_sig_checks(4))
        try:
            resolved = fut.result(timeout=10) is None
        except Exception:   # the outcome under comparison
            resolved = False
        time.sleep(0.2)
        detached = fleet.metrics.snapshot().get(
            "Fleet.StaleDetached", {}).get("count", 0)
        return {"stalls": len(stalls), "detached": detached,
                "actions": ctl.actions_total, "resolved": resolved}
    finally:
        fleet.close()


def test_pump_stall_is_not_a_dead_worker(monkeypatch):
    """A difference kept on purpose (ROADMAP.md §C): after a pump cycle
    that outlasted the report interval, the port's fleet has its live
    workers report and delivers those reports to the node before the
    controller ticks, so a long delivery on the pump thread does not get
    live workers crash-detached; the reference ticks on the reports the
    stall held back and detaches them."""
    from corda_tpu.verifier import controller as j_ctl
    got = _pump_stall(types.SimpleNamespace(oop=t_oop, fleet=t_fleet,
                                            ctl=t_ctl), monkeypatch)
    want = _pump_stall(types.SimpleNamespace(oop=j_oop, fleet=j_fleet,
                                             ctl=j_ctl), monkeypatch)
    assert got == {"stalls": 1, "detached": 0, "actions": 0,
                   "resolved": True}
    assert want["stalls"] == 1 and want["detached"] >= 1
    assert want["actions"] >= 1


def test_a_worker_killed_while_it_admits_a_request_drops_it(monkeypatch):
    """A crash that lands while the pump thread hands a request to the
    worker's batcher (the kill shuts the completion pool before the group
    is scheduled on it) drops that request, as a dead worker does, instead
    of raising out of the delivery and ending the pump thread; no reply
    leaves the dead worker."""
    bus = TBus()
    bus.create_node("node")
    worker = t_oop.VerifierWorker(bus.create_node("w0"), "node",
                                  use_device=False, device="cpu")
    bus.run_network()
    checks = tuple(t_fleet.make_sig_checks(4))

    def request(vid):
        return types.SimpleNamespace(data=t_serialize(t_oop.VerificationRequest(
            vid, None, "node", signatures=checks)))

    stopped = []
    try:
        worker._on_request(request(1))
        deadline = time.monotonic() + 30
        while worker.verified_count < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        real = worker.batcher.submit_group

        def killed_on_admission(*args, **kwargs):
            group = real(*args, **kwargs)
            worker.stop(announce=False)
            stopped.append(True)
            return group

        monkeypatch.setattr(worker.batcher, "submit_group",
                            killed_on_admission)
        worker._on_request(request(2))
        time.sleep(0.1)
        assert stopped and worker.verified_count == 1
    finally:
        if not stopped:
            worker.stop(announce=False)


SATURATED_GROUPS = 12
DELIVERY_HOLD_S = 0.015


def test_controller_acts_while_the_pump_is_saturated():
    """A worker killed under continuous groups of 256 signatures on the
    host route. Each delivery to a worker holds the pump thread for
    DELIVERY_HOLD_S beyond its decoding, longer than the 10 ms report
    interval wherever the codec runs, and each group is submitted as soon
    as the one before it was delivered, so the pump is busy for the whole
    run and every cycle that delivers a group stalls. The controller must
    still tick after every stalled cycle (the reference's cadence), reap
    the dead worker alone within the stale horizon, scale up on queue depth
    before the load ends, and every future must resolve exactly once."""
    report_s, stale_windows = 0.01, 8
    fleet = t_fleet.InProcessFleet(2, use_device=False,
                                   report_every_s=report_s)
    handed = threading.Event()
    real_receive = fleet.bus.pump_receive

    def held_receive(recipient):
        transfer = real_receive(recipient)
        if transfer is not None and recipient != "node":
            time.sleep(DELIVERY_HOLD_S)
            handed.set()
        return transfer

    fleet.bus.pump_receive = held_receive
    cycles, ticks, tick_heard = [], [], []
    real_run = fleet.bus.run_network

    def timed_run(*args, **kwargs):
        t0 = time.monotonic()
        n = real_run(*args, **kwargs)
        if not kwargs.get("exclude"):
            cycles.append((t0, time.monotonic()))
        return n

    fleet.bus.run_network = timed_run
    try:
        deadline = time.monotonic() + 10
        while fleet.service.queue.worker_count < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        ctl = fleet.attach_controller(
            slo=None, stale_detach_intervals=stale_windows,
            config=t_ctl.ControllerConfig(
                min_workers=2, max_workers=3, queue_high=256.0,
                queue_low=0.0, scale_cooldown_s=0.25, step_cooldown_s=0.25,
                breakers_stress=False))
        real_tick = ctl.tick

        def timed_tick(*args, **kwargs):
            heard_at = fleet.heard_at
            actions = real_tick(*args, **kwargs)
            ticks.append((time.monotonic(), actions))
            tick_heard.append(heard_at)
            return actions

        ctl.tick = timed_tick
        # every sign of life the node takes from w0 (a load report or an
        # acknowledged result), timed before and after it is recorded
        heard = []
        queue = fleet.service.queue
        real_report, real_ack = queue._on_load_report, queue.acknowledge

        def heard_report(report):
            t0 = time.monotonic()
            real_report(report)
            if report.worker_address == "w0":
                heard.append((t0, time.monotonic()))

        def heard_ack(verification_id):
            t0 = time.monotonic()
            worker = real_ack(verification_id)
            if worker == "w0":
                heard.append((t0, time.monotonic()))
            return worker

        queue._on_load_report, queue.acknowledge = heard_report, heard_ack
        checks = t_fleet.make_sig_checks(256)
        assert fleet.verify_signatures(checks).result(timeout=60) is None
        futures = []
        t_kill = None
        for i in range(SATURATED_GROUPS):
            handed.clear()
            futures.append(fleet.verify_signatures(checks))
            if i == 3:
                t_kill = time.monotonic()
                fleet.kill_worker("w0")
            assert handed.wait(timeout=10), "the pump delivered nothing"
        t_load_end = time.monotonic()
        outcomes = [f.result(timeout=120) for f in futures]
        t_done = time.monotonic()
        time.sleep(5 * report_s)
    finally:
        fleet.close()
    # every future exactly once
    assert outcomes == [None] * SATURATED_GROUPS
    snap = fleet.metrics.snapshot()
    assert snap["Verification.Success"]["count"] == SATURATED_GROUPS + 1
    assert snap.get("Verification.Failure", {}).get("count", 0) == 0
    # the pump was saturated: each delivered group stalled a cycle (two
    # deliveries may share one)
    run = [(a, b) for a, b in cycles if t_kill <= a <= t_done]
    stalled = [(a, b) for a, b in run if b - a > report_s]
    assert len(stalled) >= SATURATED_GROUPS // 2
    # ... and the controller ticked after every one of them
    starts = sorted(a for a, _ in cycles)
    for a, b in stalled:
        nxt = next((c for c in starts if c > a), float("inf"))
        assert any(b <= t <= nxt for t, _ in ticks), (a, b)
    actions = [(t, act) for t, acts in ticks for act in acts]
    detached = [(t, act["worker"]) for t, act in actions
                if act["action"] == "stale_detach"]
    assert [w for _, w in detached] == ["w0"]
    assert snap["Fleet.StaleDetached"]["count"] == 1
    # the reaper counts the horizon from w0's last sign of life, which may
    # reach the node after the kill (a report already on the bus), to the
    # instant the node began hearing its workers before the tick: the
    # detaching tick ends more than the horizon after it, and no tick that
    # heard once the horizon had run out ended before it
    horizon = stale_windows * 3 * report_s
    t_detach = detached[0][0]
    last_lo, last_hi = max(h for h in heard if h[0] < t_detach)
    assert t_detach - last_lo > horizon
    assert not [t for h, (t, _) in zip(tick_heard, ticks)
                if h > last_hi + horizon and t < t_detach]
    scale_ups = [t for t, act in actions if act["action"] == "scale_up"]
    assert scale_ups and scale_ups[0] < t_load_end
