"""The port's out-of-process verifier (the OutOfProcess verifier type)
against the JAX package's: the same messages byte for byte, and the same
scenarios on both packages' in-memory buses — the cases of
tests/test_oop_verifier.py (those that resolve transactions against each
package's own MockServices) and every case of tests/test_chaos_oop.py —
with equal futures' outcomes, per-worker
``verified_count``, ``Verification.*`` counts, ``fleet_status()`` fields
and request-log events.

Transactions and keys are made once with the JAX package and cross to the
port as ``serialize`` bytes. The scenarios carry no signatures or verify
them on a host batcher, so no JAX kernel is traced; the port's device path
runs here on the CPU (``device="cpu"``, the plain PyTorch kernels)."""
import time
import types

import pytest
import torch

from corda_tpu.core.contracts import Command, TransactionState
from corda_tpu.core.contracts.exceptions import \
    TransactionVerificationException as JTVE
from corda_tpu.core.crypto import generate_keypair
from corda_tpu.core.crypto.schemes import ECDSA_SECP256K1_SHA256
from corda_tpu.core.crypto.signatures import Crypto
from corda_tpu.core.serialization import deserialize as j_deserialize
from corda_tpu.core.serialization import serialize as j_serialize
from corda_tpu.core.transactions import SignedTransaction, WireTransaction
from corda_tpu.network.inmemory import InMemoryMessagingNetwork as JBus
from corda_tpu.observability import tracing as j_tracing
from corda_tpu.testing import DummyContract, DummyState
from corda_tpu.testing import faults as j_faults
from corda_tpu.testing.services import MockServices as JMockServices
from corda_tpu.utils import retry as j_retry
from corda_tpu.verifier import out_of_process as j_oop
from corda_tpu.verifier.batcher import SignatureBatcher as JBatcher
from corda_tpu_torch.core.contracts.exceptions import \
    TransactionVerificationException as TTVE
from corda_tpu_torch.core.serialization import deserialize as t_deserialize
from corda_tpu_torch.core.serialization import serialize as t_serialize
from corda_tpu_torch.network.inmemory import \
    InMemoryMessagingNetwork as TBus
from corda_tpu_torch.observability import tracing as t_tracing
from corda_tpu_torch.testing import faults as t_faults
from corda_tpu_torch.testing.services import MockServices as TMockServices
from corda_tpu_torch.utils import retry as t_retry
from corda_tpu_torch.verifier import make_verifier_service
from corda_tpu_torch.verifier import out_of_process as t_oop
from corda_tpu_torch.verifier.batcher import SignatureBatcher as TBatcher

from test_oop_verifier import ALICE_KP, NOTARY, make_ltx

SEEDS = [7, 101, 9001]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_worker(node, queue, **kw):
    if kw.get("batcher") is None:
        kw["device"] = "cpu"
    return t_oop.VerifierWorker(node, queue, **kw)


JAX = types.SimpleNamespace(
    name="jax", Bus=JBus, oop=j_oop, Worker=j_oop.VerifierWorker,
    faults=j_faults, retry=j_retry, tracing=j_tracing, TVE=JTVE,
    convert=lambda obj: obj, MockServices=JMockServices,
    host_batcher=lambda: JBatcher(use_device=False))
PORT = types.SimpleNamespace(
    name="port", Bus=TBus, oop=t_oop, Worker=_port_worker,
    faults=t_faults, retry=t_retry, tracing=t_tracing, TVE=TTVE,
    convert=lambda obj: t_deserialize(j_serialize(obj)),
    MockServices=TMockServices,
    host_batcher=lambda: TBatcher(use_device=False, device="cpu"))


def ltx(pkg, i, valid=True):
    return pkg.convert(make_ltx(i, valid))


def _outcome(fut):
    try:
        return ("ok", fut.result(timeout=60))
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))


def _counts(svc):
    snap = svc.metrics.snapshot()
    return {k: snap[k].get("count", snap[k].get("value"))
            for k in sorted(snap) if k.startswith(("Verification.",
                                                   "Fleet."))
            and k != "Verification.Duration"}


def _status(svc):
    """fleet_status() with its clock readings reduced to whether they are
    set (ages and rates depend on wall time)."""
    st = svc.fleet_status()
    for w in st["workers"].values():
        for k in ("last_report_age_s", "service_rate_ewma"):
            w[k] = w[k] is not None
    return st


def _events(svc):
    """Request-log events without their wall time, trace ids and dispatch
    durations."""
    return {vid: [{k: v for k, v in e.items()
                   if k not in ("t", "trace_id", "duration_s")}
                  for e in tl]
            for vid, tl in svc.request_log.snapshot().items()}


def _record(svc, futures, workers, **extra):
    return {"outcomes": [_outcome(f) for f in futures],
            "verified": {n: w.verified_count for n, w in workers.items()},
            "counts": _counts(svc), "status": _status(svc),
            "events": _events(svc), **extra}


def _pump_until(bus, futures, timeout=120.0):
    """Pump the manual bus until every future resolves (workers with a
    batcher reply from pool threads, so replies land between pumps)."""
    deadline = time.monotonic() + timeout
    while not all(f.done() for f in futures):
        bus.run_network()
        time.sleep(0.005)
        assert time.monotonic() < deadline, "verifications did not complete"


# -- the messages ------------------------------------------------------------

def _messages(pkg):
    """One instance of every OOP message class, built from the same values
    in ``pkg`` (a request carrying a LedgerTransaction and a signature)."""
    oop = pkg.oop
    tx = ltx(pkg, 3)
    sig = Crypto.sign_with_key(ALICE_KP, b"content")
    key, sig_bytes = pkg.convert(sig.by), sig.bytes
    req = oop.VerificationRequest(5, tx, "node", ((key, sig_bytes,
                                                   b"content"),),
                                  ("a" * 32, "b" * 16))
    return {
        "VerificationRequest": req,
        "VerificationRequest.bare": oop.VerificationRequest(6, None, "node"),
        "VerificationResponse": oop.VerificationResponse(
            5, "bad", oop._pack_obs([{"name": "worker.host_verify",
                                      "duration_s": 0.25}])),
        "VerificationResponse.ok": oop.VerificationResponse(7, None),
        "WorkerHello": oop.WorkerHello("w1", (0, 1), 2),
        "WorkerGoodbye": oop.WorkerGoodbye("w1"),
        "WorkerLoadReport": oop.WorkerLoadReport(
            "w1", 12, 3, (("ed25519", 4), ("secp256k1", 1)), 2,
            oop._pack_obs([{"name": "worker.stolen"}]),
            oop._pack_obs({"SigBatcher.Checked": {"type": "meter",
                                                  "count": 9}})),
        "StealRequest": oop.StealRequest("w2", 64, ("c" * 32, "d" * 16)),
        "WorkReturned": oop.WorkReturned("w1", (req,)),
        "WorkReturned.empty": oop.WorkReturned("w1"),
    }


MESSAGES = sorted(_messages(JAX))


@pytest.mark.parametrize("name", MESSAGES)
def test_message_bytes_identical_and_cross_decode(name):
    want, got = _messages(JAX)[name], _messages(PORT)[name]
    raw = j_serialize(want)
    assert t_serialize(got) == raw
    back = t_deserialize(raw)
    assert type(back) is type(got) and t_serialize(back) == raw
    assert j_serialize(j_deserialize(t_serialize(got))) == raw


def test_every_message_class_registered_under_the_reference_names():
    for cls in ("VerificationRequest", "VerificationResponse", "WorkerHello",
                "WorkerGoodbye", "WorkerLoadReport", "StealRequest",
                "WorkReturned"):
        assert any(n.split(".")[0] == cls for n in MESSAGES)
        assert getattr(t_oop, cls).__name__ == cls
    assert t_oop.VerifierRequestQueue.ROUTE_SLACK == \
        j_oop.VerifierRequestQueue.ROUTE_SLACK


# -- tests/test_oop_verifier.py's cases on both packages --------------------

def _single_worker_verifies(pkg):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    worker = pkg.Worker(bus.create_node("w1"), "node")
    bus.run_network()
    futures = [svc.verify(ltx(pkg, i)) for i in range(20)]
    bus.run_network()
    for f in futures:
        assert f.result(timeout=1) is None
    assert worker.verified_count == 20
    assert svc.metrics.snapshot()["Verification.Success"]["count"] == 20
    return _record(svc, futures, {"w1": worker})


def _work_is_shared_across_workers(pkg):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    workers = {f"w{i}": pkg.Worker(bus.create_node(f"w{i}"), "node")
               for i in range(4)}
    bus.run_network()
    futures = [svc.verify(ltx(pkg, i)) for i in range(40)]
    bus.run_network()
    for f in futures:
        assert f.result(timeout=1) is None
    assert all(w.verified_count == 10 for w in workers.values())
    return _record(svc, futures, workers)


def _redistribution_on_worker_death(pkg):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    w1 = pkg.Worker(bus.create_node("w1"), "node")
    w2 = pkg.Worker(bus.create_node("w2"), "node")
    bus.run_network()
    futures = [svc.verify(ltx(pkg, i)) for i in range(30)]
    w1.stop(announce=False)
    svc.queue.detach_worker("w1")
    bus.run_network()
    for f in futures:
        assert f.result(timeout=1) is None
    assert (w1.verified_count, w2.verified_count) == (0, 30)
    return _record(svc, futures, {"w1": w1, "w2": w2})


def _failure_propagates(pkg):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    worker = pkg.Worker(bus.create_node("w1"), "node")
    bus.run_network()
    fut = svc.verify(ltx(pkg, 1, valid=False))
    bus.run_network()
    with pytest.raises(pkg.TVE):
        fut.result(timeout=1)
    assert svc.metrics.snapshot()["Verification.Failure"]["count"] == 1
    return _record(svc, [fut], {"w1": worker})


def _requests_queue_until_worker_attaches(pkg):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    futures = [svc.verify(ltx(pkg, i)) for i in range(5)]
    bus.run_network()
    assert not any(f.done() for f in futures)
    late = pkg.Worker(bus.create_node("late"), "node")
    bus.run_network()
    for f in futures:
        assert f.result(timeout=1) is None
    return _record(svc, futures, {"late": late})


def _fleet_status_and_worker_gauges(pkg):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"), expected_workers=2)
    w1 = pkg.Worker(bus.create_node("w1"), "node", device_shard=(0, 1),
                    capacity=2)
    bus.run_network()
    first = _status(svc)
    assert (first["expected"], first["attached"]) == (2, 1)
    assert first["degraded"] is True
    assert first["workers"]["w1"]["device_shard"] == [0, 1]
    assert first["workers"]["w1"]["capacity"] == 2
    snap = svc.metrics.snapshot()
    assert snap["Fleet.WorkersAttached"]["value"] == 1
    assert snap["Fleet.WorkerCapacity.w1"]["value"] == 2
    assert snap["Fleet.WorkerQueueDepth.w1"]["value"] == 0
    w2 = pkg.Worker(bus.create_node("w2"), "node")
    bus.run_network()
    second = _status(svc)
    assert second["attached"] == 2 and second["degraded"] is False
    w2.stop()
    bus.run_network()
    snap = svc.metrics.snapshot()
    assert svc.fleet_status()["degraded"] is True
    assert snap["Fleet.WorkerCapacity.w2"]["value"] == 0
    w1.stop()
    return _record(svc, [], {"w1": w1, "w2": w2}, first=first,
                   second=second)


def _load_aware_routing_prefers_idle_worker(pkg):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    busy = pkg.Worker(bus.create_node("busy"), "node")
    idle = pkg.Worker(bus.create_node("idle"), "node")
    bus.run_network()
    report = pkg.oop.WorkerLoadReport
    svc.queue._on_load_report(report("busy", pending=64, in_flight=12))
    svc.queue._on_load_report(report("idle", pending=0, in_flight=0))
    futures = [svc.verify(ltx(pkg, i)) for i in range(8)]
    bus.run_network()
    for f in futures:
        assert f.result(timeout=1) is None
    assert (idle.verified_count, busy.verified_count) == (8, 0)
    busy.stop()
    idle.stop()
    return _record(svc, futures, {"busy": busy, "idle": idle})


def _submit_spans_finish_exactly_once(pkg):
    tracer = pkg.tracing.enable_tracing()
    try:
        bus = pkg.Bus()
        svc = pkg.oop.OutOfProcessTransactionVerifierService(
            bus.create_node("node"))
        w1 = pkg.Worker(bus.create_node("w1"), "node")
        w2 = pkg.Worker(bus.create_node("w2"), "node")
        bus.run_network()
        futures = [svc.verify(ltx(pkg, i)) for i in range(10)]
        w1.stop(announce=False)
        svc.queue.detach_worker("w1")
        bus.run_network()
        for f in futures:
            assert f.result(timeout=1) is None
        assert svc._spans == {}
        submits = [s for s in tracer.ring.snapshot()
                   if s["name"] == "verifier.oop_submit"]
        assert len(submits) == len(futures)
        assert all(s["duration_s"] > 0 for s in submits)
        moved = [int(k) for k, tl in svc.request_log.snapshot().items()
                 if any(e["event"] == "requeued" for e in tl)]
        assert moved
        for vid in moved:
            assert svc.request_log.terminal_count(vid) == 1
        spans = sorted((s["name"], sorted(s["tags"]))
                       for s in tracer.ring.snapshot())
        w2.stop()
        return _record(svc, futures, {"w1": w1, "w2": w2}, spans=spans)
    finally:
        pkg.tracing.disable_tracing()


def _stale_worker_flagged_degraded(pkg):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"), expected_workers=1,
        load_report_interval_s=0.02)
    w1 = pkg.Worker(bus.create_node("w1"), "node")
    bus.run_network()
    w1.send_load_report()
    bus.run_network()
    views = [_status(svc)]
    assert views[0]["workers"]["w1"]["stale"] is False
    assert views[0]["stale"] == [] and views[0]["degraded"] is False
    time.sleep(0.08)
    views.append(_status(svc))
    assert views[1]["stale"] == ["w1"] and views[1]["degraded"] is True
    w1.send_load_report()
    bus.run_network()
    views.append(_status(svc))
    assert views[2]["degraded"] is False
    w1.stop()
    return _record(svc, [], {"w1": w1}, views=views)


OOP_CASES = [_single_worker_verifies, _work_is_shared_across_workers,
             _redistribution_on_worker_death, _failure_propagates,
             _requests_queue_until_worker_attaches,
             _fleet_status_and_worker_gauges,
             _load_aware_routing_prefers_idle_worker,
             _submit_spans_finish_exactly_once,
             _stale_worker_flagged_degraded]


@pytest.mark.parametrize("case", OOP_CASES,
                         ids=[c.__name__.strip("_") for c in OOP_CASES])
def test_oop_case_matches_reference(case):
    want = case(JAX)
    got = case(PORT)
    assert got == want


# -- tests/test_chaos_oop.py's cases on both packages ------------------------

def _send_failure_detaches_worker_immediately(pkg, seed):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    w1 = pkg.Worker(bus.create_node("w1"), "node")
    w2 = pkg.Worker(bus.create_node("w2"), "node")
    bus.run_network()
    assert svc.queue.worker_count == 2
    with pkg.faults.inject(pkg.faults.FaultRule("oop.deliver", "raise",
                                                detail="->w1"),
                           seed=seed) as inj:
        futures = [svc.verify(ltx(pkg, i)) for i in range(10)]
        bus.run_network()
        for f in futures:
            assert f.result(timeout=1) is None
        fired = inj.fired("oop.deliver")
    assert svc.queue.worker_count == 1
    assert (w1.verified_count, w2.verified_count) == (0, 10)
    return _record(svc, futures, {"w1": w1, "w2": w2}, fired=fired)


def _lost_delivery_recovered_by_redelivery_timeout(pkg, seed):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    svc.queue.redelivery_timeout_s = 0.05
    try:
        w1 = pkg.Worker(bus.create_node("w1"), "node")
        w2 = pkg.Worker(bus.create_node("w2"), "node")
        bus.run_network()
        with pkg.faults.inject(pkg.faults.FaultRule(
                "oop.deliver", "drop", detail="->w1", count=1),
                seed=seed) as inj:
            fut = svc.verify(ltx(pkg, 1))
            bus.run_network()
            if not fut.done():
                assert inj.fired("oop.deliver") == 1
                time.sleep(0.12)
                svc.queue.requeue_overdue()
                bus.run_network()
            assert fut.result(timeout=1) is None
            fired = inj.fired("oop.deliver")
        assert w2.verified_count >= svc.queue.worker_count - 1
        return _record(svc, [fut], {"w1": w1, "w2": w2}, fired=fired)
    finally:
        svc.shutdown()


def _worker_crash_mid_batch_completes_every_future(pkg, seed):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    svc.queue.redelivery_timeout_s = 0.05
    try:
        w1 = pkg.Worker(bus.create_node("w1"), "node")
        w2 = pkg.Worker(bus.create_node("w2"), "node")
        bus.run_network()
        with pkg.faults.inject(pkg.faults.FaultRule(
                "oop.reply", "drop", detail="w1->*"), seed=seed) as inj:
            futures = [svc.verify(ltx(pkg, i)) for i in range(20)]
            bus.run_network()
            assert w1.verified_count == 0
            assert inj.fired("oop.reply") == 10
            assert sum(f.done() for f in futures) == 10
            w1.stop(announce=False)
            time.sleep(0.12)
            svc.queue.requeue_overdue()
            bus.run_network()
            for f in futures:
                assert f.result(timeout=1) is None
            fired = inj.fired("oop.reply")
        assert w2.verified_count == 20
        assert svc.queue.worker_count == 1
        assert svc.metrics.snapshot()["Verification.Success"]["count"] == 20
        return _record(svc, futures, {"w1": w1, "w2": w2}, fired=fired)
    finally:
        svc.shutdown()


def _worker_hello_retries_through_transient_send_failure(pkg, seed):
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    before = pkg.retry.snapshot().get("Retry.Attempts.oop.hello",
                                      {}).get("count", 0)
    with pkg.faults.inject(pkg.faults.FaultRule(
            "net.send", "raise", detail="w1->node", count=2),
            seed=seed) as inj:
        worker = pkg.Worker(bus.create_node("w1"), "node")
        bus.run_network()
        fired = inj.fired("net.send")
    assert svc.queue.worker_count == 1
    fut = svc.verify(ltx(pkg, 1))
    bus.run_network()
    assert fut.result(timeout=1) is None
    assert worker.verified_count == 1
    attempts = pkg.retry.snapshot()["Retry.Attempts.oop.hello"]["count"]
    assert attempts - before == 3
    return _record(svc, [fut], {"w1": worker}, fired=fired)


CHAOS_CASES = [
    (_send_failure_detaches_worker_immediately, [None]),
    (_lost_delivery_recovered_by_redelivery_timeout, SEEDS),
    (_worker_crash_mid_batch_completes_every_future, SEEDS),
    (_worker_hello_retries_through_transient_send_failure, [None]),
]


@pytest.mark.chaos
@pytest.mark.parametrize("case,seed", [(c, s) for c, seeds in CHAOS_CASES
                                       for s in seeds],
                         ids=[f"{c.__name__.strip('_')}-{s}"
                              for c, seeds in CHAOS_CASES for s in seeds])
def test_chaos_case_matches_reference(case, seed):
    want = case(JAX, seed)
    got = case(PORT, seed)
    assert got == want


# -- work stealing, deterministically ---------------------------------------

def _checks(pkg, n):
    """``n`` Ed25519 (key, signature, content) checks from one seeded key,
    every fourth tampered."""
    kp = generate_keypair(entropy=b"\x61" * 32)
    out = []
    for i in range(n):
        content = b"steal %d" % i
        sig = Crypto.sign_with_key(kp, content)
        if i % 4 == 3:
            content += b"!"
        out.append((pkg.convert(kp.public), sig.bytes, content))
    return out


def _steal(pkg):
    """A straggler that admits nothing into its batcher
    (``max_inflight_groups=0``) holds its whole backlog; a load report
    from it beside an idle worker's makes the node ask it for work back,
    and the returned half is re-dealt to the idle worker, whose host
    batcher verifies it. The rest is requeued when the straggler goes."""
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    slow = pkg.Worker(bus.create_node("slow"), "node",
                      batcher=pkg.host_batcher(), max_inflight_groups=0)
    bus.run_network()
    futures = [svc.verify_signatures(_checks(pkg, 4)[i:i + 1] * 2)
               for i in range(4)]
    bus.run_network()
    fast = pkg.Worker(bus.create_node("fast"), "node",
                      batcher=pkg.host_batcher())
    bus.run_network()
    slow.send_load_report()
    fast.send_load_report()
    bus.run_network()
    _pump_until(bus, futures[2:])
    stolen_done = [f.done() for f in futures]
    slow.stop(announce=True)
    _pump_until(bus, futures)
    fast.stop()
    assert stolen_done == [False, False, True, True]
    assert fast.verified_count == 4
    return _record(svc, futures, {"slow": slow, "fast": fast},
                   stolen_done=stolen_done)


def test_work_stealing_matches_reference():
    want = _steal(JAX)
    got = _steal(PORT)
    assert got == want
    assert got["counts"]["Fleet.Stolen"] == 2
    assert got["outcomes"][3][0] == "TransactionVerificationException"


# -- the entry point and the device path ------------------------------------

def test_make_verifier_service_builds_the_port_service():
    bus = TBus()
    node = bus.create_node("node")
    svc = make_verifier_service("OutOfProcess", network_service=node,
                                expected_workers=2)
    assert type(svc) is t_oop.OutOfProcessTransactionVerifierService
    assert svc.fleet_status()["expected"] == 2
    worker = t_oop.VerifierWorker(bus.create_node("w"), "node",
                                  device="cpu", device_shard=(1,))
    bus.run_network()
    assert svc.fleet_status()["workers"]["w"]["device_shard"] == [1]
    assert worker.device == torch.device("cpu")
    worker.stop()
    svc.shutdown()


def _signed_transactions():
    """Issuances signed by one Ed25519 or secp256k1 key each (the JAX
    package's signing); one of each scheme with a signature over other
    content."""
    ed = ALICE_KP
    k1 = generate_keypair(ECDSA_SECP256K1_SHA256, entropy=b"\x62" * 32)
    out = []
    for i, (kp, bad) in enumerate([(ed, False), (ed, False), (ed, True),
                                   (k1, False), (k1, True)]):
        wtx = WireTransaction(
            outputs=(TransactionState(DummyState(40 + i, (kp.public,)),
                                      NOTARY),),
            commands=(Command(DummyContract.Create(), (kp.public,)),),
            notary=NOTARY, must_sign=(kp.public,))
        content = b"other content" if bad else wtx.id.bytes
        out.append(SignedTransaction.of(
            wtx, [Crypto.sign_with_key(kp, content)]))
    return out


def _device_path(pkg, batcher, stxs=None, recorded=()):
    """``stxs`` (default ``_signed_transactions()``) through one worker
    with ``batcher``, resolved against ``pkg``'s MockServices holding the
    ``recorded`` transactions."""
    bus = pkg.Bus()
    svc = pkg.oop.OutOfProcessTransactionVerifierService(
        bus.create_node("node"))
    worker = pkg.Worker(bus.create_node("w1"), "node", batcher=batcher)
    bus.run_network()
    services = pkg.MockServices()
    for stx in recorded:
        services.record_transactions(pkg.convert(stx))
    futures = [svc.verify_signed(pkg.convert(stx), services)
               for stx in (_signed_transactions() if stxs is None else stxs)]
    _pump_until(bus, futures)
    worker.stop()
    return _record(svc, futures, {"w1": worker})


def test_device_path_on_the_cpu_matches_the_reference_host_route():
    """A port worker whose batcher runs the plain PyTorch kernels
    (``device="cpu"``, ``host_crossover=0``) gives the reference worker's
    host-route verdicts on Ed25519 and secp256k1 transactions, and its
    batcher checked them on the device route."""
    want = _device_path(JAX, JBatcher(use_device=False))
    batcher = TBatcher(device="cpu", host_crossover=0, max_latency_s=0.05)
    got = _device_path(PORT, batcher)
    assert got == want
    assert [o[0] for o in got["outcomes"]] == [
        "ok", "ok", "TransactionVerificationException", "ok",
        "TransactionVerificationException"]
    assert "did not verify" in got["outcomes"][2][1]
    snap = batcher.metrics.snapshot()
    assert snap["SigBatcher.DeviceChecked"]["count"] == 5
    assert snap.get("SigBatcher.HostRouted", {}).get("count", 0) == 0


def test_device_path_through_worker():
    """tests/test_oop_verifier.py::test_device_path_through_worker: a
    generated ledger of 12 transactions (Ed25519 and secp256k1 parties,
    moves resolving their inputs through MockServices) through a worker
    whose batcher checks every signature on the device route (the port's:
    the plain kernels on the CPU), with the reference's outcomes."""
    from corda_tpu.testing.generated_ledger import make_generated_ledger
    ledger = make_generated_ledger(12, seed=7).transactions
    want = _device_path(JAX, JBatcher(use_device=False), ledger, ledger)
    batcher = TBatcher(device="cpu", host_crossover=0, max_latency_s=0.05)
    got = _device_path(PORT, batcher, ledger, ledger)
    assert got == want
    assert got["outcomes"] == [("ok", None)] * len(ledger)
    snap = batcher.metrics.snapshot()
    assert snap["SigBatcher.DeviceBatches"]["count"] > 0
    assert snap["SigBatcher.DeviceChecked"]["count"] >= len(ledger)


def test_device_path_rejects_bad_signature():
    """tests/test_oop_verifier.py::test_device_path_rejects_bad_signature:
    a signature over other content fails through the worker's device path
    with the reference's error."""
    wtx = WireTransaction(
        outputs=(TransactionState(DummyState(1, (ALICE_KP.public,)),
                                  NOTARY),),
        commands=(Command(DummyContract.Create(), (ALICE_KP.public,)),),
        notary=NOTARY, must_sign=(ALICE_KP.public,))
    stx = SignedTransaction.of(
        wtx, [Crypto.sign_with_key(ALICE_KP, b"some other content")])
    want = _device_path(JAX, JBatcher(use_device=False), [stx])
    got = _device_path(PORT, TBatcher(device="cpu", host_crossover=0,
                                      max_latency_s=0.01), [stx])
    assert got == want
    kind, msg = got["outcomes"][0]
    assert kind == "TransactionVerificationException"
    assert "did not verify" in msg
