"""The Verify suspension point of the port's state machine against the JAX
package's (tests/test_verify_suspension.py, the cases that need no
``node.node``): N flows parked on Verify coalesce into one batch of the
port's batcher, a failed verification is thrown at the yield site with its
type, the out-of-process backend is reachable from flows, and the restart,
fallback and stale-completion cases.

Transactions are signed once with the JAX package and cross to the port as
``serialize`` bytes. The port's batcher runs its plain PyTorch kernels
(``device="cpu"``, ``host_crossover=0``, batches of at most 8); the JAX
package's runs its host route, so no JAX kernel is traced."""
from concurrent.futures import Future

import pytest

from corda_tpu.core.serialization import serialize as j_serialize
from corda_tpu_torch.core.serialization import deserialize as t_deserialize

from test_torch_flow_framework import (PKGS, both, mock_network, mod,
                                       outcome, twin_module)
from test_verify_suspension import make_issue_stx, seed_services

FLOWS = '''
from corda_tpu.core.crypto.signatures import SignatureException
from corda_tpu.flows.api import FlowLogic, Sleep, Verify


class VerifyFlow(FlowLogic):
    def __init__(self, stx):
        self.stx = stx

    def call(self):
        yield Verify(self.stx)
        return "verified"


class CatchingVerifyFlow(FlowLogic):
    def __init__(self, stx):
        self.stx = stx

    def call(self):
        try:
            yield Verify(self.stx)
        except SignatureException:
            return "caught-signature-exception"
        return "verified"


class VerifyThenSleepFlow(FlowLogic):
    def __init__(self, stx):
        self.stx = stx

    def call(self):
        yield Verify(self.stx)
        yield Sleep(3600)
        return "woke"
'''


def flows(pkg):
    return twin_module(pkg, "verify", FLOWS)


def convert(pkg, obj):
    return obj if pkg == "corda_tpu" else t_deserialize(j_serialize(obj))


def stxs(n, first=0):
    """Issuances signed by the JAX package's MockServices."""
    svcs = seed_services(None)
    return [make_issue_stx(svcs, i) for i in range(first, first + n)]


def tampered(stx):
    sig = stx.sigs[0]
    bad = sig.__class__(sig.bytes[:-1] + bytes([sig.bytes[-1] ^ 1]), sig.by)
    return stx.__class__(stx.tx_bits, (bad,))


def one_node(pkg):
    network = mock_network(pkg)
    node = network.create_node("O=Alice, L=London, C=GB")
    network.start_nodes()
    return network, node


def batcher(pkg, **kw):
    verifier = mod(pkg, "verifier")
    if pkg == "corda_tpu":
        return verifier.SignatureBatcher(use_device=False, **kw)
    return verifier.SignatureBatcher(device="cpu", host_crossover=0, **kw)


def _n_flows(pkg, txs):
    network, node = one_node(pkg)
    b = batcher(pkg, max_latency_s=0.25, interactive_latency_s=0.25)
    node.services.verifier_service = mod(
        pkg, "verifier").TpuTransactionVerifierService(batcher=b)
    try:
        fsms = [node.start_flow(flows(pkg).VerifyFlow(convert(pkg, stx)))
                for stx in txs]
        parked = node.smm.awaiting_external
        network.run_network()
        out = [outcome(f.result_future, 60) for f in fsms]
    finally:
        node.services.verifier_service.shutdown()
    snap = b.metrics.snapshot()
    return {"parked": parked, "outcomes": out,
            "checked": snap["SigBatcher.Checked"]["count"],
            "device_batches": snap.get("SigBatcher.DeviceBatches",
                                       {}).get("count", 0),
            "device_checked": snap.get("SigBatcher.DeviceChecked",
                                       {}).get("count", 0)}


def test_n_flows_one_device_batch():
    """8 flows parked on Verify: the port's batcher checks their 8
    signatures in ONE device batch (the reference test's assertion on the
    JAX batcher), and the flows' outcomes are the reference's."""
    txs = stxs(8)
    got = both(_n_flows, txs)
    ref, port = got["corda_tpu"], got["corda_tpu_torch"]
    assert port["outcomes"] == ref["outcomes"] == [("ok", "verified")] * 8
    assert port["parked"] == ref["parked"] == 8
    assert port["checked"] == ref["checked"] == 8
    assert (port["device_batches"], port["device_checked"]) == (1, 8)
    assert ref["device_batches"] == 0    # the reference ran its host route


def _failure(pkg, stx, service):
    network, node = one_node(pkg)
    if service:
        node.services.verifier_service = mod(
            pkg, "verifier").TpuTransactionVerifierService(
                batcher=batcher(pkg, max_latency_s=0.01))
    try:
        fsm = node.start_flow(flows(pkg).CatchingVerifyFlow(convert(pkg, stx)))
        network.run_network()
        return outcome(fsm.result_future, 60)
    finally:
        if service:
            node.services.verifier_service.shutdown()


@pytest.mark.parametrize("service", [True, False],
                         ids=["async_service", "sync_fallback"])
def test_verify_failure_throws_original_type_at_yield_site(service):
    """A flipped signature byte: the flow catches the reference's
    SignatureException type at its yield site, through the port's batcher
    (plain kernels) and through the no-service host fallback."""
    bad = tampered(stxs(1)[0])
    got = both(_failure, bad, service)
    assert got["corda_tpu"] == got["corda_tpu_torch"] == \
        ("ok", "caught-signature-exception")


def _sync_fallback(pkg, stx):
    network, node = one_node(pkg)
    assert node.services.verifier_service is None
    fsm = node.start_flow(flows(pkg).VerifyFlow(convert(pkg, stx)))
    network.run_network()
    return outcome(fsm.result_future, 30), node.smm.awaiting_external


def test_sync_fallback_without_async_service():
    got = both(_sync_fallback, stxs(1)[0])
    assert got["corda_tpu"] == got["corda_tpu_torch"] == (("ok", "verified"),
                                                          0)


def _oop(pkg, txs):
    network, node = one_node(pkg)
    oop = mod(pkg, "verifier.out_of_process")
    svc = oop.OutOfProcessTransactionVerifierService(node.messaging)
    node.services.verifier_service = svc
    kw = {} if pkg == "corda_tpu" else {"device": "cpu"}
    worker = oop.VerifierWorker(network.bus.create_node("verifier-worker-1"),
                                str(node.info.address), **kw)
    network.run_network()
    fsms = [node.start_flow(flows(pkg).VerifyFlow(convert(pkg, stx)))
            for stx in txs]
    parked = node.smm.awaiting_external
    network.run_network()
    out = [outcome(f.result_future, 30) for f in fsms]
    worker.stop()
    return {"parked": parked, "outcomes": out,
            "verified": worker.verified_count}


def test_oop_backend_reachable_from_flows():
    got = both(_oop, stxs(4))
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu_torch"] == {
        "parked": 4, "outcomes": [("ok", "verified")] * 4, "verified": 4}


class ManualVerifierService:
    """Async-capable verifier whose futures the test completes by hand."""

    def __init__(self):
        self.futures = []

    def verify_signed(self, stx, services, check_sufficient_signatures=True):
        fut = Future()
        self.futures.append(fut)
        return fut


def _restart(pkg, stx):
    network, node = one_node(pkg)
    manual = ManualVerifierService()
    node.services.verifier_service = manual
    fsm = node.start_flow(flows(pkg).VerifyFlow(convert(pkg, stx)))
    trace = [len(manual.futures), fsm.result_future.done(),
             len(node.smm.checkpoints.get_all_checkpoints())]
    node2 = node.restart()
    manual2 = ManualVerifierService()
    node2.services.verifier_service = manual2
    node2.start()
    trace.append(len(manual2.futures))
    restored = list(node2.smm.flows.values())[0]
    manual2.futures[0].set_result(None)
    network.run_network()
    trace.append(outcome(restored.result_future, 30))
    trace.append(len(node2.smm.checkpoints.get_all_checkpoints()))
    return trace


def test_restart_mid_verify_replays_and_resubmits():
    got = both(_restart, stxs(1)[0])
    assert got["corda_tpu"] == got["corda_tpu_torch"] == [
        1, False, 1, 1, ("ok", "verified"), 0]


def _stale(pkg, stx):
    network, node = one_node(pkg)
    Verify = mod(pkg, "flows.api").Verify
    manual = ManualVerifierService()
    node.services.verifier_service = manual
    fsm = node.start_flow(flows(pkg).VerifyThenSleepFlow(convert(pkg, stx)))
    verify_request = fsm.parked_on
    trace = [isinstance(verify_request, Verify)]
    manual.futures[0].set_result(None)
    network.run_network()
    sleep_park = fsm.parked_on
    trace.append((fsm.done, sleep_park is not None,
                  sleep_park is not verify_request))
    node.smm._awaiting_external += 1
    node.smm._on_verify_done(fsm, manual.futures[0], verify_request)
    trace.append((fsm.parked_on is sleep_park, fsm.done))
    return trace


def test_stale_verify_completion_does_not_resume_wrong_park():
    got = both(_stale, stxs(1)[0])
    assert got["corda_tpu"] == got["corda_tpu_torch"] == [
        True, (False, True, True), (True, False)]


def _rebuild(pkg):
    sm = mod(pkg, "node.statemachine")
    api = mod(pkg, "flows.api")
    sigs = mod(pkg, "core.crypto.signatures")
    out = []
    for err in (sigs.SignatureException("bad sig"),
                api.FlowTimeoutException("slow peer")):
        payload = sm._error_payload(err)
        e = sm._rebuild_error(payload)
        out.append((payload, type(e) is type(err), str(e)))
    out.append(type(sm._rebuild_error("plain")) is api.FlowException)
    for gadget in (["os.path:join", "x"], ["subprocess:Popen", "sleep 9"],
                   ["builtins:exec", "1+1"], ["no.such.module:X", "y"]):
        out.append(type(sm._rebuild_error(gadget)) is api.FlowException)
    return out


def test_rebuild_error_uses_whitelist_not_dynamic_import():
    """The error payloads name each package's own modules, and each
    package rebuilds only its own whitelisted types."""
    got = both(_rebuild)
    for pkg in PKGS:
        (sig_payload, sig_same, _), (timeout_payload, timeout_same, _) = \
            got[pkg][:2]
        assert sig_payload == [
            f"{pkg}.core.crypto.signatures:SignatureException", "bad sig"]
        assert timeout_payload == [
            f"{pkg}.flows.api:FlowTimeoutException", "slow peer"]
        assert sig_same and timeout_same
        assert got[pkg][2:] == [True] * 5
    sm = mod("corda_tpu_torch", "node.statemachine")
    assert all(m.startswith("corda_tpu_torch.") for m in sm._ERROR_MODULES)
    # a payload naming the other package's type is not rebuilt as that type
    e = sm._rebuild_error(got["corda_tpu"][0][0])
    assert type(e) is mod("corda_tpu_torch", "flows.api").FlowException
