"""The port's FlowScheduler and its AwaitFuture / VerifyMany suspension
points against the JAX package's (tests/test_flow_scheduler.py): each
scenario runs on both packages with controllable futures, and the flows'
outcomes, the parks and the scheduler's counters are compared."""
import threading
from concurrent.futures import Future

import pytest

from test_torch_flow_framework import (both, mock_network, mod, outcome,
                                       twin_module)

SCHEDULER_FLOWS = '''
from corda_tpu.flows import FlowLogic
from corda_tpu.flows.api import AwaitFuture, VerifyMany


class AwaitFlow(FlowLogic):
    def __init__(self, producer):
        self.producer = producer

    def call(self):
        value = yield AwaitFuture(self.producer)
        return value


class CatchingAwaitFlow(FlowLogic):
    def __init__(self, producer):
        self.producer = producer

    def call(self):
        try:
            yield AwaitFuture(self.producer)
        except ValueError as e:
            return f"caught:{e}"
        return "no-error"


class WaveFlow(FlowLogic):
    def __init__(self, stxs):
        self.stxs = stxs

    def call(self):
        try:
            yield VerifyMany(tuple(self.stxs),
                             check_sufficient_signatures=False)
        except Exception as e:
            return f"failed:{type(e).__name__}:{e}"
        return "verified"
'''


def flows(pkg):
    return twin_module(pkg, "scheduler", SCHEDULER_FLOWS)


def one_node(pkg):
    network = mock_network(pkg)
    a = network.create_node("O=Alice, L=London, C=GB")
    network.start_nodes()
    return network, a


class FakeVerifier:
    """Async verifier double: hands back controllable futures per submit."""

    def __init__(self):
        self.submitted: list = []   # (stx, future)

    def verify_signed(self, stx, hub, check_sufficient_signatures=True):
        fut = Future()
        self.submitted.append((stx, fut))
        return fut


def _drain(node):
    while node.smm.drain_external():
        pass


# -- AwaitFuture --------------------------------------------------------------

def _await(pkg, kind):
    network, a = one_node(pkg)
    F = flows(pkg)
    fut = Future()
    trace = []
    if kind == "none":
        fsm = a.start_flow(F.AwaitFlow(lambda: None))
    elif kind == "done":
        fut.set_result("ready")
        fsm = a.start_flow(F.AwaitFlow(lambda: fut))
    elif kind == "foreign":
        fsm = a.start_flow(F.AwaitFlow(lambda: fut))
        trace.append((fsm.done, a.smm.awaiting_external))
        threading.Timer(0.05, lambda: fut.set_result(42)).start()
    else:
        fsm = a.start_flow(F.CatchingAwaitFlow(lambda: fut))
        threading.Timer(0.05, lambda: fut.set_exception(
            ValueError("nope"))).start()
    network.run_network()
    trace.append(outcome(fsm.result_future, timeout=1))
    trace.append(a.smm.awaiting_external)
    return trace


@pytest.mark.parametrize("kind,want", [
    ("none", ("ok", None)), ("done", ("ok", "ready")),
    ("foreign", ("ok", 42)), ("error", ("ok", "caught:nope"))],
    ids=["none_producer_resumes_immediately", "done_fast_path",
         "parks_until_foreign_thread_resolves", "error_type_preserved"])
def test_await_future_matches_reference(kind, want):
    got = both(_await, kind)
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu_torch"][-2:] == [want, 0]
    if kind == "foreign":
        assert got["corda_tpu_torch"][0] == (False, 1)


# -- VerifyMany ---------------------------------------------------------------

def _wave(pkg, kind):
    network, a = one_node(pkg)
    F = flows(pkg)
    if kind == "empty":
        fsm = a.start_flow(F.WaveFlow([]))
        network.run_network()
        return [outcome(fsm.result_future, timeout=1)]
    fake = FakeVerifier()
    a.services.verifier_service = fake
    fsm = a.start_flow(F.WaveFlow(["stx0", "stx1", "stx2"]))
    trace = [[s for s, _ in fake.submitted], a.smm.awaiting_external]
    if kind == "parks_once":
        fake.submitted[0][1].set_result(None)
        fake.submitted[2][1].set_result(None)
        a.smm.drain_external()
        trace.append((fsm.done, a.smm.awaiting_external))
        fake.submitted[1][1].set_result(None)
    else:
        fake.submitted[2][1].set_exception(IndexError("later"))
        fake.submitted[0][1].set_exception(ValueError("first"))
        fake.submitted[1][1].set_result(None)
    network.run_network()
    trace.append(outcome(fsm.result_future, timeout=1))
    trace.append(a.smm.awaiting_external)
    return trace


@pytest.mark.parametrize("kind,want", [
    ("empty", [("ok", "verified")]),
    ("parks_once", [["stx0", "stx1", "stx2"], 1, (False, 1),
                    ("ok", "verified"), 0]),
    ("first_error", [["stx0", "stx1", "stx2"], 1,
                     ("ok", "failed:ValueError:first"), 0])],
    ids=["empty_wave_is_immediate", "submits_whole_wave_and_parks_once",
         "throws_first_error_in_submission_order"])
def test_verify_many_matches_reference(kind, want):
    got = both(_wave, kind)
    assert got["corda_tpu"] == want
    assert got["corda_tpu_torch"] == want


# -- FlowScheduler ------------------------------------------------------------

def _bounds(pkg):
    network, a = one_node(pkg)
    F = flows(pkg)
    sched = mod(pkg, "node.statemachine").FlowScheduler(a.smm,
                                                        max_concurrent=2)
    futs = [Future() for _ in range(5)]
    proxies = [sched.submit(lambda f=f: F.AwaitFlow(lambda: f)) for f in futs]
    trace = [(sched.in_flight, sched.waiting)]
    futs[0].set_result("r0")
    _drain(a)
    trace.append((outcome(proxies[0], 1), sched.in_flight, sched.waiting))
    for i, fut in enumerate(futs[1:], start=1):
        fut.set_result(f"r{i}")
        _drain(a)
    trace.append([outcome(p, 1) for p in proxies])
    trace.append((sched.in_flight, sched.waiting, sched.launched,
                  sched.high_water))
    return trace


def test_scheduler_bounds_concurrency_and_backfills_like_reference():
    got = both(_bounds)
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu_torch"][-1] == (0, 0, 5, 2)
    assert got["corda_tpu_torch"][-2] == [("ok", f"r{i}") for i in range(5)]


def _failures(pkg, kind):
    network, a = one_node(pkg)
    F = flows(pkg)
    FlowException = mod(pkg, "flows").FlowException
    FlowScheduler = mod(pkg, "node.statemachine").FlowScheduler
    if kind == "flow":
        sched = FlowScheduler(a.smm, max_concurrent=2)
        fut = Future()
        proxy = sched.submit(lambda: F.AwaitFlow(lambda: fut))
        fut.set_exception(FlowException("flow blew up"))
        _drain(a)
        return [outcome(proxy, 1), sched.in_flight]
    sched = FlowScheduler(a.smm, max_concurrent=1)

    def bad_factory():
        raise RuntimeError("cannot build")

    proxy = sched.submit(bad_factory)
    first = outcome(proxy, 1)
    ok = sched.submit(lambda: F.AwaitFlow(lambda: None))
    _drain(a)
    return [first, outcome(ok, 1), sched.in_flight]


@pytest.mark.parametrize("kind,want", [
    ("flow", [("FlowException", "flow blew up"), 0]),
    ("factory", [("RuntimeError", "cannot build"), ("ok", None), 0])],
    ids=["propagates_flow_failure_to_proxy",
         "factory_failure_does_not_leak_a_slot"])
def test_scheduler_failures_match_reference(kind, want):
    got = both(_failures, kind)
    assert got["corda_tpu"] == want
    assert got["corda_tpu_torch"] == want


# -- wave-based dependency resolution -----------------------------------------

class _FakeStx:
    def __init__(self, tx_id, deps=()):
        self.id = tx_id
        self.inputs = [type("Ref", (), {"txhash": d})() for d in deps]


GRAPHS = {
    "diamond": [("a", ()), ("b", ("a",)), ("c", ("a",)), ("d", ("b", "c"))],
    "external_deps_are_wave_zero": [("x", ("already-recorded",))],
    "cycle": [("a", ("b",)), ("b", ("a",))],
}


def _waves(pkg, graph):
    library = mod(pkg, "flows.library")
    txs = {s.id: s for s in (_FakeStx(i, d) for i, d in GRAPHS[graph])}
    try:
        waves = [sorted(s.id for s in w)
                 for w in library._topological_waves(txs)]
        order = [s.id for s in library._topological_order(txs)]
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))
    return waves, order


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_topological_waves_match_reference(graph):
    got = both(_waves, graph)
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    if graph == "diamond":
        assert got["corda_tpu_torch"][0] == [["a"], ["b", "c"], ["d"]]
    if graph == "cycle":
        assert got["corda_tpu_torch"] == (
            "FlowException", "Transaction dependency cycle detected")

