"""The port's verifier service on SignedTransactions built by the JAX
package: same outcome as the JAX service — success, SignatureException or
SignaturesMissingException, with the same message.

The port's batcher runs with ``host_crossover=0``, so its signatures go
through the plain PyTorch split-k kernel on the CPU; the JAX service keeps
its default (host route for a few signatures), so no JAX kernel is compiled.
"""
import pytest

from corda_tpu.core.contracts import Command, TransactionState
from corda_tpu.core.crypto import generate_keypair
from corda_tpu.core.crypto.schemes import ECDSA_SECP256K1_SHA256
from corda_tpu.core.identity import Party
from corda_tpu.core.transactions import SignedTransaction, WireTransaction
from corda_tpu.testing import (DUMMY_NOTARY_NAME, DummyContract, DummyState,
                               MockServices)
from corda_tpu.verifier import TpuTransactionVerifierService as JaxService
from corda_tpu_torch.core.crypto.signatures import SignatureException
from corda_tpu_torch.core.transactions import SignaturesMissingException
from corda_tpu_torch.verifier import (DeviceTransactionVerifierService,
                                      InMemoryTransactionVerifierService,
                                      SignatureBatcher,
                                      TpuTransactionVerifierService,
                                      make_verifier_service)

NOTARY_KP = generate_keypair(entropy=b"\x30" * 32)
NOTARY = Party(DUMMY_NOTARY_NAME, NOTARY_KP.public)
ALICE_KP = generate_keypair(entropy=b"\x31" * 32)
ALICE_K1_KP = generate_keypair(ECDSA_SECP256K1_SHA256, entropy=b"\x32" * 32)


def make_issue_stx(services, owner_kp=ALICE_KP):
    """The issuance transaction of tests/test_verifier_service.py."""
    wtx = WireTransaction(
        outputs=(TransactionState(DummyState(7, (owner_kp.public,)), NOTARY),),
        commands=(Command(DummyContract.Create(), (owner_kp.public,)),),
        notary=NOTARY, must_sign=(owner_kp.public,))
    return services.sign_transaction(wtx, owner_kp.public)


@pytest.fixture
def services():
    return MockServices(key_pairs=[NOTARY_KP, ALICE_KP, ALICE_K1_KP],
                        parties=[NOTARY])


def _outcome(fut):
    try:
        return ("ok", fut.result(timeout=300))
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))


def test_verify_signed_matches_jax_service(services):
    stx = make_issue_stx(services)
    sig = stx.sigs[0]
    bad = SignedTransaction(stx.tx_bits, (sig.__class__(
        sig.bytes[:-1] + bytes([sig.bytes[-1] ^ 1]), sig.by),))
    wrong_key = SignedTransaction.of(
        stx.tx, [services.sign(stx.tx.id.bytes, ALICE_K1_KP.public)])
    cases = [stx, bad, wrong_key]
    jax_svc = JaxService()
    port_svc = TpuTransactionVerifierService(batcher=SignatureBatcher(
        device="cpu", host_crossover=0, max_latency_s=0.01))
    try:
        want = [_outcome(jax_svc.verify_signed(s, services)) for s in cases]
        got = [_outcome(port_svc.verify_signed(s, services)) for s in cases]
    finally:
        jax_svc.shutdown()
        port_svc.shutdown()
    assert got == want
    assert [o[0] for o in got] == ["ok", "SignatureException",
                                   "SignaturesMissingException"]
    snap = port_svc.batcher.metrics.snapshot()
    assert snap["SigBatcher.DeviceChecked"]["count"] == 2   # the Ed25519 sigs
    assert snap["SigBatcher.Checked"]["count"] == 3


def test_port_exceptions_are_the_ports_own(services):
    stx = make_issue_stx(services)
    wrong_key = SignedTransaction.of(
        stx.tx, [services.sign(stx.tx.id.bytes, ALICE_K1_KP.public)])
    svc = TpuTransactionVerifierService(device="cpu")
    try:
        with pytest.raises(SignaturesMissingException) as info:
            svc.verify_signed(wrong_key, services).result(timeout=120)
        assert isinstance(info.value, SignatureException)
        assert info.value.id == stx.id
    finally:
        svc.shutdown()


def test_make_verifier_service_seam():
    assert isinstance(make_verifier_service("InMemory"),
                      InMemoryTransactionVerifierService)
    svc = make_verifier_service("Tpu", device="cpu")
    assert isinstance(svc, DeviceTransactionVerifierService)
    assert svc.batcher.device.type == "cpu"
    svc.shutdown()
    with pytest.raises(NotImplementedError):
        make_verifier_service("OutOfProcess")
    with pytest.raises(ValueError):
        make_verifier_service("Bogus")
