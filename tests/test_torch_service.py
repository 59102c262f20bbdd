"""The port's verifier service on SignedTransactions built by the JAX
package: same outcome as the JAX service — success, SignatureException or
SignaturesMissingException, with the same message.

The port's batcher runs with ``host_crossover=0``, so its signatures go
through the plain PyTorch kernels on the CPU (Ed25519 split-k, secp256k1
hybrid, secp256r1 split); the JAX service keeps its default (host route for
a few signatures), so no JAX kernel is compiled.
"""
import pytest
import torch

from corda_tpu.core.contracts import Command, TransactionState
from corda_tpu.core.crypto import generate_keypair
from corda_tpu.core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                           ECDSA_SECP256R1_SHA256)
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
BOB_R1_KP = generate_keypair(ECDSA_SECP256R1_SHA256, entropy=b"\x33" * 32)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_issue_stx(services, owner_kp=ALICE_KP):
    """The issuance transaction of tests/test_verifier_service.py."""
    wtx = WireTransaction(
        outputs=(TransactionState(DummyState(7, (owner_kp.public,)), NOTARY),),
        commands=(Command(DummyContract.Create(), (owner_kp.public,)),),
        notary=NOTARY, must_sign=(owner_kp.public,))
    return services.sign_transaction(wtx, owner_kp.public)


@pytest.fixture
def services():
    return MockServices(key_pairs=[NOTARY_KP, ALICE_KP, ALICE_K1_KP,
                                   BOB_R1_KP], parties=[NOTARY])


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
    # every signature takes a device bucket: two Ed25519, one secp256k1
    assert snap["SigBatcher.DeviceChecked"]["count"] == 3
    assert snap["SigBatcher.Checked"]["count"] == 3


def test_verify_signed_routes_each_scheme_to_its_device_bucket(services):
    """A transaction signed by an Ed25519, a secp256k1 and a secp256r1 key:
    the port's service sends each signature to its scheme's device bucket
    and reaches the JAX service's outcome, valid and with the r1 signature
    tampered."""
    signers = (ALICE_KP.public, ALICE_K1_KP.public, BOB_R1_KP.public)
    wtx = WireTransaction(
        outputs=(TransactionState(DummyState(9, signers), NOTARY),),
        commands=(Command(DummyContract.Create(), signers),),
        notary=NOTARY, must_sign=signers)
    stx = services.sign_transaction(wtx, *signers)
    r1_sig = stx.sigs[2]
    bad = SignedTransaction(stx.tx_bits, stx.sigs[:2] + (r1_sig.__class__(
        r1_sig.bytes[:-2] + bytes([r1_sig.bytes[-2] ^ 4]) + r1_sig.bytes[-1:],
        r1_sig.by),))
    jax_svc = JaxService()
    port_svc = TpuTransactionVerifierService(batcher=SignatureBatcher(
        device="cpu", host_crossover=0, max_latency_s=0.05))
    try:
        want = [_outcome(jax_svc.verify_signed(s, services))
                for s in (stx, bad)]
        # both submitted before either is awaited: the two transactions'
        # signatures may share a batch per scheme
        futs = [port_svc.verify_signed(s, services) for s in (stx, bad)]
        got = [_outcome(f) for f in futs]
    finally:
        jax_svc.shutdown()
        port_svc.shutdown()
    assert got == want
    assert [o[0] for o in got] == ["ok", "SignatureException"]
    snap = port_svc.batcher.metrics.snapshot()
    assert snap["SigBatcher.DeviceChecked"]["count"] == 6
    for bucket in ("ed25519", "secp256k1", "secp256r1"):
        assert snap[f"SigBatcher.{bucket}.Prep"]["count"] in (1, 2)


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
    from corda_tpu_torch.network import InMemoryMessagingNetwork
    from corda_tpu_torch.verifier import OutOfProcessTransactionVerifierService
    node = InMemoryMessagingNetwork().create_node("node")
    oop = make_verifier_service("OutOfProcess", network_service=node)
    assert isinstance(oop, OutOfProcessTransactionVerifierService)
    oop.shutdown()
    with pytest.raises(TypeError):   # network_service is required, as there
        make_verifier_service("OutOfProcess")
    with pytest.raises(ValueError):
        make_verifier_service("Bogus")
