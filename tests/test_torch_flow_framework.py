"""The port's flow framework and MockNetwork against the JAX package's: the
session protocol (tests/test_flow_framework.py) and the flow timers
(tests/test_flow_timers.py), each scenario run on both packages and the
flows' outcomes compared.

The flows are the reference tests' own classes, defined once per package:
the same source text is executed into a module of each package's name
(``twin_module``), so a flow's name (its module path) differs between the
packages, as the two packages' flow names do, and checkpoints restore it
through that module. Flows here carry no signatures, so no kernel runs;
the port's MockNetwork is on the CPU (``device="cpu"``).

The helpers at the top (``PKGS``, ``twin_module``, ``mock_network``,
``outcome``) serve the port's other flow tests too."""
import importlib
import sys
import types

import pytest
import torch

PKGS = ("corda_tpu", "corda_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def twin_module(pkg: str, name: str, src: str) -> types.ModuleType:
    """``src`` (written against ``corda_tpu``) executed as the module
    ``twin_<name>_<pkg>`` with every ``corda_tpu.`` import naming ``pkg``'s
    module; registered in ``sys.modules`` so that checkpoints restore its
    flows by name. Built once a process."""
    modname = f"twin_{name}_{pkg}"
    mod = sys.modules.get(modname)
    if mod is None:
        mod = types.ModuleType(modname)
        sys.modules[modname] = mod
        code = src if pkg == "corda_tpu" else src.replace(
            "corda_tpu.", f"{pkg}.")
        exec(compile(code, f"<{modname}>", "exec"), mod.__dict__)
    return mod


def mod(pkg: str, path: str):
    """``pkg``'s module at the package-relative ``path``."""
    return importlib.import_module(f"{pkg}.{path}")


def mock_network(pkg: str):
    """A MockNetwork of ``pkg``: the port's on the CPU."""
    testing = mod(pkg, "testing")
    if pkg == "corda_tpu":
        return testing.MockNetwork()
    return testing.MockNetwork(device="cpu")


def outcome(fut, timeout: float = 5):
    """("ok", result) or (exception type name, message) of a future."""
    try:
        return ("ok", fut.result(timeout=timeout))
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))


def both(scenario, *args, **kw):
    """``scenario(pkg, ...)`` on each package: {pkg: its record}."""
    return {pkg: scenario(pkg, *args, **kw) for pkg in PKGS}


# ---------------------------------------------------------------------------
# tests/test_flow_framework.py's flows, verbatim
# ---------------------------------------------------------------------------

FRAMEWORK_FLOWS = '''
from corda_tpu.flows import (FlowException, FlowLogic, Receive, Send,
                             SendAndReceive, WaitForLedgerCommit,
                             initiated_by, initiating_flow)


@initiating_flow
class PingFlow(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        answer = yield SendAndReceive(self.peer, "ping", str)
        return answer.unwrap(lambda d: d)


@initiated_by(PingFlow)
class PongFlow(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        msg = yield Receive(self.peer, str)
        assert msg.unwrap(lambda d: d) == "ping"
        yield Send(self.peer, "pong")
        return "done"


@initiating_flow
class AngryInitiator(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        answer = yield SendAndReceive(self.peer, "hello", str)
        return answer.unwrap(lambda d: d)


@initiated_by(AngryInitiator)
class AngryResponder(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        _ = yield Receive(self.peer, str)
        raise FlowException("I am grumpy today")


@initiating_flow
class UnregisteredInitiator(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        answer = yield SendAndReceive(self.peer, "anyone there?", str)
        return answer.unwrap(lambda d: d)


@initiating_flow
class MultiHopFlow(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        first = yield from self.sub_flow(PingFlow(self.peer))
        second = yield from self.sub_flow(PingFlow2(self.peer))
        return (first, second)


@initiating_flow
class PingFlow2(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        answer = yield SendAndReceive(self.peer, "ping", str)
        return answer.unwrap(lambda d: d)


@initiated_by(PingFlow2)
class PongFlow2(PongFlow):
    pass


@initiating_flow
class DoubleReceiveAfterError(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        try:
            yield SendAndReceive(self.peer, "hello", str)
        except FlowException:
            pass
        answer = yield Receive(self.peer, str)  # session is dead
        return answer


@initiated_by(DoubleReceiveAfterError)
class AngryResponder2(AngryResponder):
    pass


@initiating_flow
class RetryingFlow(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        answer = yield from self.send_and_receive_with_retry(self.peer, "ping",
                                                             str, attempts=3)
        return answer.unwrap(lambda d: d)


_GRUMPY_COUNT = {"n": 0}


@initiated_by(RetryingFlow)
class EventuallyHelpful(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        msg = yield Receive(self.peer, str)
        _GRUMPY_COUNT["n"] += 1
        if _GRUMPY_COUNT["n"] < 3:
            raise FlowException("not yet")
        yield Send(self.peer, "pong")
        return None


@initiating_flow
class RetryThenChatFlow(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        first = yield from self.send_and_receive_with_retry(self.peer, "ping",
                                                            str, attempts=3)
        second = yield SendAndReceive(self.peer, "again", str)
        return (first.unwrap(lambda d: d), second.unwrap(lambda d: d))


_FLAKY_COUNT = {"n": 0}


@initiated_by(RetryThenChatFlow)
class FlakyThenChatty(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        msg = yield Receive(self.peer, str)
        _FLAKY_COUNT["n"] += 1
        if _FLAKY_COUNT["n"] < 2:
            raise FlowException("not yet")
        assert msg.unwrap(lambda d: d) == "ping"
        yield Send(self.peer, "pong")
        msg2 = yield Receive(self.peer, str)
        assert msg2.unwrap(lambda d: d) == "again"
        yield Send(self.peer, "pong2")
        return None
'''


def flows(pkg):
    return twin_module(pkg, "framework", FRAMEWORK_FLOWS)


def two_nodes(pkg, a_checkpoints=None):
    network = mock_network(pkg)
    a = network.create_node("O=Alice, L=London, C=GB",
                            checkpoint_storage=a_checkpoints)
    b = network.create_node("O=Bob, L=Paris, C=FR")
    network.start_nodes()
    return network, a, b


def _run_flow(pkg, flow_cls_name):
    network, a, b = two_nodes(pkg)
    F = flows(pkg)
    fsm = a.start_flow(getattr(F, flow_cls_name)(b.party))
    network.run_network()
    return {"outcome": outcome(fsm.result_future),
            "a_flows": len(a.smm.flows), "b_flows": len(b.smm.flows),
            "a_checkpoints": len(a.smm.checkpoints.get_all_checkpoints())}


def test_flow_names_carry_each_packages_module():
    """A flow's name is its module path: the port's flows name its own
    modules, so the two packages' nodes never take each other's flows."""
    for pkg in PKGS:
        api = mod(pkg, "flows.api")
        library = mod(pkg, "flows.library")
        assert api.flow_name(library.FinalityFlow) == \
            f"{pkg}.flows.library.FinalityFlow"
        assert api.flow_name(flows(pkg).PingFlow) == \
            f"twin_framework_{pkg}.PingFlow"


@pytest.mark.parametrize("flow,want", [
    ("PingFlow", ("ok", "pong")),
    ("AngryInitiator", ("FlowException", "I am grumpy today")),
    ("UnregisteredInitiator", None),
    ("MultiHopFlow", ("ok", ("pong", "pong"))),
    ("DoubleReceiveAfterError", None),
])
def test_session_protocol_outcomes_match_reference(flow, want):
    """test_ping_pong, test_error_propagates_to_initiator,
    test_session_init_rejected_when_unregistered,
    test_sub_flow_composition, test_receive_on_dead_session_fails_fast and
    test_flow_completion_removes_checkpoints: the same outcome, and no
    flow or checkpoint left, on both packages."""
    got = both(_run_flow, flow)
    ref, port = got["corda_tpu"], got["corda_tpu_torch"]
    if flow == "UnregisteredInitiator":
        # the reason names the initiator's flow, module path included
        assert ref["outcome"] == ("FlowException", "No initiated flow "
                                  "registered for twin_framework_corda_tpu."
                                  "UnregisteredInitiator")
        assert port["outcome"] == ("FlowException", "No initiated flow "
                                   "registered for twin_framework_"
                                   "corda_tpu_torch.UnregisteredInitiator")
        ref.pop("outcome"), port.pop("outcome")
    elif flow == "DoubleReceiveAfterError":
        assert port["outcome"][0] == "FlowException"
        assert "ended" in port["outcome"][1]
    else:
        assert port["outcome"] == want
    assert port == ref
    assert port["a_flows"] == port["b_flows"] == port["a_checkpoints"] == 0


def _checkpoint_restart(pkg, tmp_path):
    checkpoints = mod(pkg, "node.checkpoints")
    network, a, b = two_nodes(pkg, checkpoints.FileCheckpointStorage(
        str(tmp_path / f"{pkg}_ckpts")))
    fsm = a.start_flow(flows(pkg).PingFlow(b.party))
    n_ckpt = len(a.smm.checkpoints.get_all_checkpoints())
    network.bus.pump_receive(str(b.party.name))
    a2 = a.restart()
    a2.start()
    restored = list(a2.smm.flows.values())
    network.run_network()
    return {"checkpoints_before": n_ckpt, "restored": len(restored),
            "outcome": outcome(restored[0].result_future),
            "left": a2.smm.checkpoints.get_all_checkpoints(),
            "first_done": fsm.done}


def test_checkpoint_restart_mid_flow_matches_reference(tmp_path):
    got = both(_checkpoint_restart, tmp_path)
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu_torch"]["outcome"] == ("ok", "pong")
    assert got["corda_tpu_torch"]["restored"] == 1


def _retry(pkg):
    F = flows(pkg)
    F._GRUMPY_COUNT["n"] = 0
    out = _run_flow(pkg, "RetryingFlow")
    out["attempts"] = F._GRUMPY_COUNT["n"]
    return out


def test_send_and_receive_with_retry_matches_reference():
    got = both(_retry)
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu_torch"]["outcome"] == ("ok", "pong")
    assert got["corda_tpu_torch"]["attempts"] == 3


def _retry_restart(pkg, tmp_path):
    F = flows(pkg)
    checkpoints = mod(pkg, "node.checkpoints")
    network, a, b = two_nodes(pkg, checkpoints.FileCheckpointStorage(
        str(tmp_path / f"{pkg}_ckpts")))
    F._FLAKY_COUNT["n"] = 0
    fsm = a.start_flow(F.RetryThenChatFlow(b.party))
    alice, bob = str(a.party.name), str(b.party.name)
    for _ in range(50):
        if any(e[0] == "data" for e in fsm.response_log):
            break
        network.bus.pump_receive(bob)
        network.bus.pump_receive(alice)
    else:
        raise AssertionError("never reached the second exchange")
    network.run_network(exclude=(alice,))
    a2 = a.restart()
    a2.start()
    restored = list(a2.smm.flows.values())
    network.run_network()
    return {"restored": len(restored),
            "outcome": outcome(restored[0].result_future),
            "log_kinds": [e[0] for e in restored[0].response_log]}


def test_retry_discard_not_replayed_on_restart_matches_reference(tmp_path):
    got = both(_retry_restart, tmp_path)
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu_torch"]["outcome"] == ("ok", ("pong", "pong2"))


# ---------------------------------------------------------------------------
# tests/test_flow_timers.py
# ---------------------------------------------------------------------------

TIMER_FLOWS = '''
from corda_tpu.flows.api import (FlowLogic, FlowTimeoutException, Receive,
                                 Send, Sleep, initiating_flow)


class SleepingFlow(FlowLogic):
    def __init__(self, seconds):
        self.seconds = seconds

    def call(self):
        yield Sleep(self.seconds)
        return "woke"


@initiating_flow
class AskWithTimeoutFlow(FlowLogic):
    def __init__(self, peer, timeout_s):
        self.peer = peer
        self.timeout_s = timeout_s

    def call(self):
        yield Send(self.peer, "question")
        try:
            reply = yield Receive(self.peer, str, timeout_s=self.timeout_s)
        except FlowTimeoutException:
            return "timed-out"
        return reply.unwrap(lambda d: d)


class SilentResponder(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        yield Receive(self.peer, str)
        yield Receive(self.peer, str)    # parks forever


class PromptResponder(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        yield Receive(self.peer, str)
        yield Send(self.peer, "answer")
'''


def timers(pkg):
    return twin_module(pkg, "timers", TIMER_FLOWS)


def _sleep(pkg, restart):
    network, a, _ = two_nodes(pkg)
    fsm = a.start_flow(timers(pkg).SleepingFlow(10.0))
    network.run_network()
    trace = [fsm.result_future.done()]
    if restart:
        a = a.restart()
        a.start()
        fsm = list(a.smm.flows.values())[0]
        trace.append(network.advance_clock(10.1))
    else:
        trace.append(network.advance_clock(5.0))
        trace.append(fsm.result_future.done())
        trace.append(network.advance_clock(5.1))
    trace.append(outcome(fsm.result_future))
    return trace


@pytest.mark.parametrize("restart", [False, True],
                         ids=["wakes_on_test_clock_only", "survives_restart"])
def test_sleep_matches_reference(restart):
    got = both(_sleep, restart)
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu_torch"][-1] == ("ok", "woke")


def _ask(pkg, responder):
    network, a, b = two_nodes(pkg)
    T = timers(pkg)
    api = mod(pkg, "flows.api")
    b.smm.register_flow_factory(api.flow_name(T.AskWithTimeoutFlow),
                                getattr(T, responder))
    fsm = a.start_flow(T.AskWithTimeoutFlow(b.party, timeout_s=20.0))
    network.run_network()
    trace = [fsm.result_future.done()]
    trace.append(network.advance_clock(21.0 if responder == "SilentResponder"
                                       else 30.0))
    trace.append(outcome(fsm.result_future))
    return trace


@pytest.mark.parametrize("responder,want", [
    ("SilentResponder", [False, 1, ("ok", "timed-out")]),
    ("PromptResponder", [True, 0, ("ok", "answer")])],
    ids=["receive_timeout_throws_at_yield_site",
         "reply_before_deadline_cancels_timer"])
def test_receive_timeouts_match_reference(responder, want):
    got = both(_ask, responder)
    assert got["corda_tpu"] == want
    assert got["corda_tpu_torch"] == want
