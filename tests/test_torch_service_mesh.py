"""The port's verifier service built on a mesh alone,
``TpuTransactionVerifierService(mesh=...)`` with no ``device=``, as the
reference service is built on ``make_mesh(2)``: same outcomes for
Ed25519- and secp256k1-signed transactions, one of them tampered.

The reference service keeps its default host crossover, so it compiles no
JAX kernel. The port's service runs once at its default crossover (the
host route) and once with the crossover at 0, where every signature goes
through the 2-shard CPU mesh's plain kernels.
"""
import pytest
import torch

from corda_tpu.core.contracts import Command, TransactionState
from corda_tpu.core.crypto import generate_keypair
from corda_tpu.core.crypto.schemes import ECDSA_SECP256K1_SHA256
from corda_tpu.core.identity import Party
from corda_tpu.core.transactions import SignedTransaction, WireTransaction
from corda_tpu.parallel import make_mesh as jax_make_mesh
from corda_tpu.testing import (DUMMY_NOTARY_NAME, DummyContract, DummyState,
                               MockServices)
from corda_tpu.verifier import TpuTransactionVerifierService as JaxService
from corda_tpu_torch.parallel import make_mesh
from corda_tpu_torch.verifier import TpuTransactionVerifierService

CPU = torch.device("cpu")
NOTARY_KP = generate_keypair(entropy=b"\x50" * 32)
NOTARY = Party(DUMMY_NOTARY_NAME, NOTARY_KP.public)
ED_KP = generate_keypair(entropy=b"\x51" * 32)
K1_KP = generate_keypair(ECDSA_SECP256K1_SHA256, entropy=b"\x52" * 32)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _transactions():
    """Three transactions: signed by the Ed25519 key, by the secp256k1 key,
    and by both with the secp256k1 signature tampered."""
    services = MockServices(key_pairs=[NOTARY_KP, ED_KP, K1_KP],
                            parties=[NOTARY])
    out = []
    for i, signers in enumerate(((ED_KP.public,), (K1_KP.public,),
                                 (ED_KP.public, K1_KP.public))):
        wtx = WireTransaction(
            outputs=(TransactionState(DummyState(11 + i, signers), NOTARY),),
            commands=(Command(DummyContract.Create(), signers),),
            notary=NOTARY, must_sign=signers)
        out.append(services.sign_transaction(wtx, *signers))
    sig = out[2].sigs[1]
    out[2] = SignedTransaction(out[2].tx_bits, out[2].sigs[:1] + (
        sig.__class__(sig.bytes[:-2] + bytes([sig.bytes[-2] ^ 8])
                      + sig.bytes[-1:], sig.by),))
    return services, out


def _outcome(fut):
    try:
        return ("ok", fut.result(timeout=300))
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("route", ["host", "device"])
def test_mesh_service_matches_reference_service(route):
    services, cases = _transactions()
    jax_svc = JaxService(mesh=jax_make_mesh(2))
    port_svc = TpuTransactionVerifierService(
        mesh=make_mesh(devices=[CPU] * 2))
    assert port_svc.batcher.device == CPU
    assert len(port_svc.batcher.mesh.devices) == 2
    if route == "device":
        port_svc.batcher.host_crossover = 0
    try:
        want = [_outcome(jax_svc.verify_signed(s, services)) for s in cases]
        futs = [port_svc.verify_signed(s, services) for s in cases]
        got = [_outcome(f) for f in futs]
    finally:
        jax_svc.shutdown()
        port_svc.shutdown()
    assert got == want
    assert [o[0] for o in got] == ["ok", "ok", "SignatureException"]
    snap = port_svc.batcher.metrics.snapshot()
    device_checked = snap.get("SigBatcher.DeviceChecked", {}).get("count", 0)
    assert device_checked == (4 if route == "device" else 0)
    assert "SigBatcher.BatchFailure" not in snap
