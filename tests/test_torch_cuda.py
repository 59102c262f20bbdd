"""Tests of the port that need the card (marked ``gpu``; they skip where
torch.cuda.is_available() is False). On a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
lacks.)

Each CUDA kernel (B2 Ed25519, B3 secp256k1, B4 secp256r1) must give the
same verdicts as its plain PyTorch version, bit for bit, and the batcher's
device routes must run on them.
"""
import hashlib

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


def _ecdsa_items(curve, n, seed):
    """Signed (pub, msg, r, s) items, every third one tampered, plus a
    crafted valid signature with x(R) = r + n < p (the r + n candidate of
    B3, a host fallback of B4)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n - 1):
        priv = int.from_bytes(rng.bytes(32), "little") % (curve.n - 1) + 1
        msg = rng.bytes(24)
        r, s = ecmath.ecdsa_sign(curve, priv, msg)
        if i % 3 == 1:
            msg += b"!"
        out.append((curve.mul(priv, curve.g), msg, r, s))
    p, order = curve.p, curve.n
    x = order + 1
    while pow((x ** 3 + curve.a * x + curve.b) % p, (p - 1) // 2, p) != 1:
        x += 1
    y = pow((x ** 3 + curve.a * x + curve.b) % p, (p + 1) // 4, p)
    msg, r, s = b"crafted", x - order, (1 << 200) + 99
    e = ecmath._bits2int(hashlib.sha256(msg).digest(), order) % order
    Q = curve.mul(pow(r, order - 2, order),
                  curve.add(curve.mul(s, (x, y)), curve.mul(order - e,
                                                            curve.g)))
    out.append((Q, msg, r, s))
    return out


@pytest.mark.parametrize("name", ["secp256k1", "secp256r1"])
def test_ecdsa_kernels_match_plain_versions_on_the_card(cuda, name):
    from corda_tpu_torch.ops import weierstrass as wc
    curve = ecmath.SECP256K1 if name == "secp256k1" else ecmath.SECP256R1
    items = _ecdsa_items(curve, 40, 4)
    if name == "secp256k1":
        *wire, precheck = wc.prepare_batch_hybrid_wide(items)
        forced = np.zeros(len(items), dtype=bool)
        tabs, fn = wc.hybrid_tables(cuda), wc.verify_core_hybrid_wide
        plain = wc.verify_core_hybrid_wide_plain
    else:
        *wire, precheck, forced = wc.prepare_batch_r1_split(curve, items)
        tabs, fn = wc.r1_split_tables(cuda), wc.verify_core_r1_split
        plain = wc.verify_core_r1_split_plain
    args = [torch.from_numpy(np.array(a)).to(cuda) for a in wire]
    before = fn.launches
    ok = fn(*args, *tabs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(ok.cpu(), plain(*args, *tabs).cpu())
    want = [ecmath.ecdsa_verify(curve, *it) for it in items]
    assert want[-1]
    assert list((ok.cpu().numpy() & precheck) | forced) == want


def test_batcher_ecdsa_device_routes_run_the_kernels(cuda):
    from corda_tpu_torch.core.crypto import Crypto, generate_keypair
    from corda_tpu_torch.core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                                     ECDSA_SECP256R1_SHA256)
    from corda_tpu_torch.ops import weierstrass as wc
    from corda_tpu_torch.verifier import SignatureBatcher
    checks, want = [], []
    for i in range(24):
        scheme = (ECDSA_SECP256K1_SHA256, ECDSA_SECP256R1_SHA256)[i % 2]
        kp = generate_keypair(scheme, entropy=bytes([i + 1]) * 32)
        msg = bytes([i]) * 9
        sig = Crypto.sign_with_key(kp, msg).bytes
        if i % 4 < 2:
            msg += b"?"
        checks.append((kp.public, sig, msg))
        want.append(i % 4 >= 2)
    b = SignatureBatcher(device=cuda, host_crossover=0, max_latency_s=0.01)
    before = (wc.verify_core_hybrid_wide.launches,
              wc.verify_core_r1_split.launches)
    try:
        got = b.submit_group(checks).result(timeout=120)
    finally:
        b.close()
    assert got == want
    assert wc.verify_core_hybrid_wide.launches > before[0]
    assert wc.verify_core_r1_split.launches > before[1]
    snap = b.metrics.snapshot()
    assert snap["SigBatcher.DeviceChecked"]["count"] == 24
    assert "SigBatcher.BatchFailure" not in snap


def test_batcher_on_the_card_raises_when_an_ecdsa_kernel_cannot_build(
        cuda, tmp_path, monkeypatch):
    """The CUDA batcher builds all three kernels at construction: a
    secp256r1 kernel that cannot build raises BuildError there."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import weierstrass as wc
    from corda_tpu_torch.verifier import SignatureBatcher
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setitem(_build._TARGETS["secp256r1_split"], "compiler",
                        lambda: None)
    for load in (ed.load_kernel, wc.load_hybrid_kernel,
                 wc.load_r1_split_kernel):
        load.cache_clear()
    try:
        with pytest.raises(_build.BuildError, match="secp256r1_split"):
            SignatureBatcher(device=cuda)
    finally:
        for load in (ed.load_kernel, wc.load_hybrid_kernel,
                     wc.load_r1_split_kernel):
            load.cache_clear()
