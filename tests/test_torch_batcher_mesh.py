"""SignatureBatcher(mesh=...) of the port on a 2-shard CPU mesh, mirroring
tests/test_parallel.py's mesh-backed batcher test: the service seam
composed with the sharded path returns the host oracle's verdicts, and
every check is counted as device-checked."""
import pytest
import torch

from corda_tpu.core.crypto.signatures import Crypto as JaxCrypto
from corda_tpu_torch.core.crypto import generate_keypair
from corda_tpu_torch.core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                                 ECDSA_SECP256R1_SHA256,
                                                 EDDSA_ED25519_SHA512)
from corda_tpu_torch.core.crypto.signatures import Crypto
from corda_tpu_torch.ops import ed25519 as ted
from corda_tpu_torch.parallel import make_mesh
from corda_tpu_torch.utils.faults import FaultRule, inject
from corda_tpu_torch.verifier.batcher import SignatureBatcher

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _checks(schemes, n):
    checks, want = [], []
    for i in range(n):
        scheme = schemes[i % len(schemes)]
        kp = generate_keypair(scheme, entropy=bytes([0x30 + i]) * 32)
        content = bytes([i]) * 24
        sig = Crypto.sign_with_key(kp, content).bytes
        if i % 4 == 2:
            content = content + b"!"        # invalidate
        checks.append((kp.public, sig, content))
        want.append(Crypto.is_valid(kp.public, sig, content))
    return checks, want


def test_mesh_backed_batcher_matches_host():
    """The reference's test on a 2-shard mesh: Ed25519 and secp256k1
    checks, submit_many, device route for every batch."""
    checks, want = _checks((ECDSA_SECP256K1_SHA256, EDDSA_ED25519_SHA512),
                           12)
    b = SignatureBatcher(mesh=make_mesh(devices=[CPU] * 2), host_crossover=0,
                         max_latency_s=0.02)
    try:
        futs = b.submit_many(checks)
        got = [f.result(timeout=300) for f in futs]
        assert got == want
        snap = b.metrics.snapshot()
        assert snap["SigBatcher.DeviceChecked"]["count"] >= len(checks)
        assert "SigBatcher.BatchFailure" not in snap
        assert all(v["state"] == "closed"
                   for v in b.breaker_status().values())
    finally:
        b.close()


def test_mesh_batcher_groups_cover_every_scheme():
    """submit_group over all three device schemes: verdicts equal the host
    oracle (and the JAX package's host verify), each check device-checked,
    the Ed25519 bucket on the sharded split kernel's plain version."""
    checks, want = _checks((EDDSA_ED25519_SHA512, ECDSA_SECP256K1_SHA256,
                            ECDSA_SECP256R1_SHA256), 9)
    b = SignatureBatcher(mesh=make_mesh(devices=[CPU] * 2), host_crossover=0,
                         max_latency_s=0.02)
    assert b.device == CPU
    try:
        got = b.submit_group(checks).result(timeout=300)
        snap = b.metrics.snapshot()
    finally:
        b.close()
    assert got == want
    assert got == [JaxCrypto.is_valid(*c) for c in checks]
    assert snap["SigBatcher.DeviceChecked"]["count"] == len(checks)
    assert snap["SigBatcher.DeviceBatches"]["count"] == 3
    assert ted.verify_core_split.launches == 0 or torch.cuda.is_available()


def test_mesh_and_device_together_raise():
    mesh = make_mesh(devices=[CPU] * 2)
    with pytest.raises(ValueError, match="pass mesh= or device=, not both"):
        SignatureBatcher(mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        SignatureBatcher(mesh=mesh, device=CPU)


def test_mesh_dispatch_fault_falls_back_to_host_and_counts():
    """A transient dispatch fault on the mesh route takes the host fallback
    and counts toward the breaker, as on one device."""
    checks, want = _checks((EDDSA_ED25519_SHA512,), 4)
    b = SignatureBatcher(mesh=make_mesh(devices=[CPU] * 2), host_crossover=0,
                         max_latency_s=0.01, breaker_threshold=5)
    try:
        with inject(FaultRule("batcher.device_dispatch", "raise",
                              detail="ed25519")):
            got = b.submit_group(checks).result(timeout=300)
        snap = b.metrics.snapshot()
        status = b.breaker_status()["ed25519"]
    finally:
        b.close()
    assert got == want
    assert snap["SigBatcher.BatchFailure"]["count"] == 1
    assert "SigBatcher.DeviceChecked" not in snap
    assert status["consecutive_failures"] == 1
