"""Tests of the port that need the card (marked ``gpu``; they skip where
torch.cuda.is_available() is False). On a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
lacks.)

The CUDA kernel must give the same verdicts as its plain PyTorch version,
bit for bit, and the batcher's device route must run on it.
"""
import numpy as np
import pytest
import torch

from corda_tpu_torch.core.crypto import ecmath

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _items(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sk = rng.bytes(32)
        pub = ecmath.ed25519_public_key(sk)
        msg = rng.bytes(32)
        sig = ecmath.ed25519_sign(sk, msg)
        if i % 3 == 1:
            sig = sig[:7] + bytes([sig[7] ^ 2]) + sig[8:]
        out.append((pub, sig, msg))
    return out


def test_kernel_matches_plain_version_on_the_card(cuda):
    from corda_tpu_torch.ops import ed25519 as ed
    items = _items(48, 1)
    *wire, precheck = ed.prepare_batch_split(items)
    args = ed.wire_to_device(*wire, device=cuda)
    tabs = ed.split_tables(cuda)
    before = ed.verify_core_split.launches
    ok = ed.verify_core_split(*args, *tabs)
    torch.cuda.synchronize()
    assert ed.verify_core_split.launches == before + 1
    plain = ed.verify_core_split_plain(*args, *tabs)
    assert torch.equal(ok.cpu(), plain.cpu())
    want = [ecmath.ed25519_verify(p, m, s) for p, s, m in items]
    assert list(ok.cpu().numpy() & precheck) == want


def test_batcher_device_route_runs_the_kernel(cuda):
    from corda_tpu_torch.core.crypto import PublicKey
    from corda_tpu_torch.core.crypto.schemes import EDDSA_ED25519_SHA512
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.verifier import SignatureBatcher
    items = _items(16, 2)
    checks = [(PublicKey(EDDSA_ED25519_SHA512, p), s, m) for p, s, m in items]
    b = SignatureBatcher(device=cuda, host_crossover=0, max_latency_s=0.01)
    before = ed.verify_core_split.launches
    try:
        got = b.submit_group(checks).result(timeout=120)
    finally:
        b.close()
    assert got == [ecmath.ed25519_verify(p, m, s) for p, s, m in items]
    assert ed.verify_core_split.launches > before
    snap = b.metrics.snapshot()
    assert snap["SigBatcher.DeviceChecked"]["count"] == 16
    assert "SigBatcher.BatchFailure" not in snap


def test_profile_dir_traces_the_card(cuda, tmp_path, monkeypatch):
    """CORDA_TPU_PROFILE_DIR on the card: the exported trace holds the
    dispatch range and the kernel's device activity."""
    import json
    from corda_tpu_torch.core.crypto import PublicKey
    from corda_tpu_torch.core.crypto.schemes import EDDSA_ED25519_SHA512
    from corda_tpu_torch.verifier import SignatureBatcher
    monkeypatch.setenv("CORDA_TPU_PROFILE_DIR", str(tmp_path))
    items = _items(8, 3)
    checks = [(PublicKey(EDDSA_ED25519_SHA512, p), s, m) for p, s, m in items]
    b = SignatureBatcher(device=cuda, host_crossover=0, max_latency_s=0.01)
    try:
        b.submit_group(checks).result(timeout=120)
    finally:
        b.close()
    (trace,) = tmp_path.glob("sig-batcher-*.json")
    names = [e.get("name", "") for e in
             json.loads(trace.read_text())["traceEvents"]]
    assert any(n.startswith("verify-ed25519-") for n in names)
    assert any("ed25519_split_verify_kernel" in n for n in names)


def test_batcher_on_the_card_raises_when_the_kernel_cannot_build(
        cuda, tmp_path, monkeypatch):
    """SignatureBatcher(device="cuda") builds its kernel at construction:
    without a compiler it raises BuildError instead of verifying on the
    host."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.verifier import SignatureBatcher
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setitem(_build._TARGETS["ed25519_split"], "compiler",
                        lambda: None)
    ed.load_kernel.cache_clear()
    try:
        with pytest.raises(_build.BuildError, match="no compiler"):
            SignatureBatcher(device=cuda)
    finally:
        ed.load_kernel.cache_clear()
