"""Tests of the port that need the card (marked ``gpu``; they skip where
torch.cuda.is_available() is False). On a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
lacks.)

Each CUDA kernel (B2 Ed25519, B3 secp256k1, B4 secp256r1, B5 windowed and
B8 Shamir/GLV ECDSA — B3, B4, B5 and both B8 kernels on lane pairs, B2 and
both B7 kernels on lane pairs or one lane by batch size —, B6
SHA-256/Merkle, B7 Ed25519 Shamir and windowed)
must give the same results as its plain PyTorch version, bit for bit (B10,
the SIMM margin, too: both round every float32 operation in one order);
the batcher's device routes
must run on B2-B4, ``verify_batch``'s other modes on B5/B8, the Merkle
seams of batch_merkle on B6 and a 2-shard mesh of one card on B2-B4, B6
and B7.
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


# ---------------------------------------------------------------------------
# B5 and B8: the windowed, Shamir and GLV verify modes
# ---------------------------------------------------------------------------

MODE_CASES = [("secp256k1", "plain"), ("secp256k1", "glv"),
              ("secp256k1", "windowed"), ("secp256r1", "plain"),
              ("secp256r1", "windowed")]


def _mode_items(curve, n, seed):
    """``_ecdsa_items`` with the keys G (private key 1) and -G (n - 1),
    whose G + Q is a doubling and the identity."""
    items = _ecdsa_items(curve, n, seed)
    for k, priv in ((0, 1), (2, curve.n - 1)):
        msg = b"edge %d" % k
        items[k] = (curve.mul(priv, curve.g), msg,
                    *ecmath.ecdsa_sign(curve, priv, msg))
    return items


def _mode_call(wc, curve, mode, items, device):
    """(dispatcher, plain version, device args incl. tables and curve
    name, precheck) of a mode on ``items``."""
    if mode == "plain":
        *wire, precheck = wc.prepare_batch(curve, items)
        fn, plain, tabs, extra = wc.verify_core, wc.verify_core_plain, (), (
            curve.name,)
    elif mode == "glv":
        *wire, precheck = wc.prepare_batch_glv(items)
        fn, plain, tabs, extra = (wc.verify_core_glv,
                                  wc.verify_core_glv_plain, (), ())
    else:
        *wire, precheck = wc.prepare_batch_windowed_single(curve, items)
        fn, plain = (wc.verify_core_windowed_single,
                     wc.verify_core_windowed_single_plain)
        tabs, extra = wc.windowed_tables(curve, device), (curve.name,)
    args = [torch.from_numpy(np.array(a)).to(device) for a in wire]
    return fn, plain, (*args, *tabs, *extra), precheck


@pytest.mark.parametrize("bucket", [8, 256])
@pytest.mark.parametrize("name,mode", MODE_CASES)
def test_mode_kernels_match_plain_versions_on_the_card(cuda, name, mode,
                                                       bucket):
    """B5 (windowed), B8 Shamir (plain) and B8 GLV give their plain
    versions' verdicts bit for bit, and after the precheck the host
    oracle's, at two buckets (keys G and -G and a crafted r + n item
    among the inputs)."""
    from corda_tpu_torch.ops import weierstrass as wc
    curve = ecmath.SECP256K1 if name == "secp256k1" else ecmath.SECP256R1
    items = _mode_items(curve, bucket, 5 + bucket)
    fn, plain, args, precheck = _mode_call(wc, curve, mode, items, cuda)
    before = fn.launches
    ok = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(ok.cpu(), plain(*args).cpu())
    want = [ecmath.ecdsa_verify(curve, *it) for it in items]
    assert want[0] and want[2] and want[-1]
    assert list(ok.cpu().numpy() & precheck) == want


@pytest.mark.parametrize("name,mode", MODE_CASES)
def test_verify_batch_modes_launch_their_kernels(cuda, name, mode):
    """verify_batch(mode=...) on the card runs the mode's kernel once and
    gives the host oracle's verdicts."""
    from corda_tpu_torch.ops import weierstrass as wc
    curve = ecmath.SECP256K1 if name == "secp256k1" else ecmath.SECP256R1
    fn = {"plain": wc.verify_core, "glv": wc.verify_core_glv,
          "windowed": wc.verify_core_windowed_single}[mode]
    items = _mode_items(curve, 20, 9)
    before = fn.launches
    got = wc.verify_batch(curve, items, mode=mode, device=cuda)
    assert fn.launches == before + 1
    assert list(got) == [ecmath.ecdsa_verify(curve, *it) for it in items]


def test_mode_wrappers_refuse_bad_arguments_before_building(cuda):
    """The B5/B8 wrappers refuse a wrong dtype, shape or curve with
    ValueError before they build or launch anything."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import weierstrass as wc
    curve = ecmath.SECP256K1
    items = _mode_items(curve, 8, 3)
    builds = dict(_build.BUILD_COUNT)
    launches = (wc.verify_core.launches, wc.verify_core_glv.launches,
                wc.verify_core_windowed_single.launches)
    for mode, cuda_fn in (("plain", wc.verify_core_cuda),
                          ("glv", wc.verify_core_glv_cuda),
                          ("windowed", wc.verify_core_windowed_single_cuda)):
        _, _, args, _ = _mode_call(wc, curve, mode, items, cuda)
        bad = list(args)
        bad[0] = bad[0].to(torch.int64)
        with pytest.raises(ValueError):
            cuda_fn(*bad)
        bad = list(args)
        bad[0] = bad[0][:4].contiguous()
        with pytest.raises(ValueError):
            cuda_fn(*bad)
        if mode != "glv":
            with pytest.raises(ValueError, match="unknown curve"):
                cuda_fn(*args[:-1], "secp384r1")
    assert dict(_build.BUILD_COUNT) == builds
    assert (wc.verify_core.launches, wc.verify_core_glv.launches,
            wc.verify_core_windowed_single.launches) == launches


# ---------------------------------------------------------------------------
# B6: SHA-256 / Merkle
# ---------------------------------------------------------------------------

def _words(rng, *shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _host_root(leaves: bytes) -> bytes:
    level = [leaves[i:i + 32] for i in range(0, len(leaves), 32)]
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest()
                 for i in range(0, len(level), 2)]
    return level[0]


@pytest.mark.parametrize("n", [1, 7, 255, 1000, 4097])
def test_b6_hash_pairs_matches_plain_and_hashlib_at_ragged_sizes(cuda, n):
    from corda_tpu_torch.ops import sha256 as sha
    pairs = _words(np.random.default_rng(n), n, 16)
    t = sha.as_words(pairs).to(cuda)
    before = sha.hash_pairs.launches
    got = sha.hash_pairs(t)
    torch.cuda.synchronize()
    assert sha.hash_pairs.launches == before + 1
    assert got.device == t.device
    assert torch.equal(got.cpu(), sha.hash_pairs_plain(t).cpu())
    raw = pairs.astype(">u4").tobytes()
    assert sha.digests_to_bytes(got) == [
        hashlib.sha256(raw[64 * i:64 * i + 64]).digest() for i in range(n)]


@pytest.mark.parametrize("n_blocks", [1, 2, 5])
def test_b6_sha256_blocks_matches_plain_and_hashlib(cuda, n_blocks):
    from corda_tpu_torch.ops import sha256 as sha
    rng = np.random.default_rng(n_blocks)
    lo, hi = 64 * (n_blocks - 1), 64 * n_blocks - 9
    msgs = [rng.bytes(int(rng.integers(lo, hi + 1))) for _ in range(333)]
    t = sha.as_words(sha.pack_batch(msgs)).to(cuda)
    before = sha.sha256_blocks.launches
    got = sha.sha256_blocks(t)
    torch.cuda.synchronize()
    assert sha.sha256_blocks.launches == before + 1
    assert torch.equal(got.cpu(), sha.sha256_blocks_plain(t).cpu())
    assert sha.digests_to_bytes(got) == [hashlib.sha256(m).digest()
                                         for m in msgs]


def test_b6_merkle_root_with_leading_batch_dims(cuda):
    from corda_tpu_torch.ops import sha256 as sha
    leaves = _words(np.random.default_rng(9), 2, 3, 16, 8)
    t = sha.as_words(leaves).to(cuda)
    before = sha.merkle_root.launches
    got = sha.merkle_root(t)
    torch.cuda.synchronize()
    assert got.shape == (2, 3, 8)
    assert sha.merkle_root.launches == before + 4      # one per level
    assert torch.equal(got.cpu(), sha.merkle_root_plain(t).cpu())
    for idx in np.ndindex(2, 3):
        assert (sha.digests_to_bytes(got[idx][None])[0]
                == _host_root(leaves[idx].astype(">u4").tobytes()))
    one = sha.as_words(_words(np.random.default_rng(10), 1, 8)).to(cuda)
    assert torch.equal(sha.merkle_root(one).cpu(), one[0].cpu())
    assert sha.merkle_root.launches == before + 4


def _port_tear_offs(n):
    """``n`` oracle-shaped tear-offs revealing their Fix command, every
    fourth with a wrong root, built by the port alone."""
    from corda_tpu_torch.core.contracts import Command, TransactionState
    from corda_tpu_torch.core.crypto import PublicKey, SecureHash
    from corda_tpu_torch.core.crypto.schemes import EDDSA_ED25519_SHA512
    from corda_tpu_torch.core.identity import Party
    from corda_tpu_torch.core.transactions import (FilteredTransaction,
                                                   WireTransaction)
    from corda_tpu_torch.samples.rates_oracle import Fix, FixOf
    from corda_tpu_torch.testing.dummy import DummyContract, DummyState
    rng = np.random.default_rng(11)
    alice, rates, notary_key = (PublicKey(EDDSA_ED25519_SHA512,
                                          ecmath.ed25519_public_key(
                                              rng.bytes(32)))
                                for _ in range(3))
    notary = Party("O=Notary Service, L=Zurich, C=CH", notary_key)
    ftxs, want = [], []
    for i in range(n):
        wtx = WireTransaction(
            outputs=(TransactionState(DummyState(i, (alice,)), notary),),
            commands=(Command(DummyContract.Create(), (alice,)),
                      Command(Fix(FixOf("ICE LIBOR", "2016-03-16", "3M"),
                                  500 + i), (rates,))),
            notary=notary, must_sign=(alice, rates))
        ftx = wtx.build_filtered_transaction(
            lambda c: isinstance(c, Command) and isinstance(c.value, Fix))
        if i % 4 == 1:
            ftx = FilteredTransaction(SecureHash.sha256(b"wrong"),
                                      ftx.filtered_leaves,
                                      ftx.partial_merkle_tree)
        ftxs.append(ftx)
        want.append(i % 4 != 1)
    return ftxs, want


def test_b6_batch_merkle_on_the_card_matches_the_host_route(cuda):
    from corda_tpu_torch.core.transactions import batch_merkle as bm
    from corda_tpu_torch.ops import sha256 as sha
    ftxs, want = _port_tear_offs(40)
    before = sha.hash_pairs.launches
    got = bm.verify_filtered_batch(ftxs, device_crossover=1, device=cuda)
    assert sha.hash_pairs.launches == before + 3       # one per round
    assert got == bm.verify_filtered_batch(ftxs, use_device=False) == want
    lists = [f.filtered_leaves.available_component_hashes * 5 for f in ftxs]
    before = sha.merkle_root.launches
    roots = bm.batch_roots(lists, device_crossover=1, device=cuda)
    assert sha.merkle_root.launches == before + 3      # 5 leaves -> 8
    assert roots == bm.batch_roots(lists, use_device=False)


def test_b6_raises_kernel_error_when_its_library_cannot_build(
        cuda, tmp_path, monkeypatch):
    """A B6 library that cannot be built raises KernelError on the card —
    nothing falls back to the plain version or to hashlib."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.core.transactions import batch_merkle as bm
    from corda_tpu_torch.ops import sha256 as sha
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setitem(_build._TARGETS["sha256"], "compiler", lambda: None)
    sha.load_kernel.cache_clear()
    try:
        t = torch.zeros(4, 16, dtype=torch.int32, device=cuda)
        with pytest.raises(_build.KernelError, match="no compiler"):
            sha.hash_pairs(t)
        ftxs, _ = _port_tear_offs(4)
        with pytest.raises(_build.KernelError):
            bm.verify_filtered_batch(ftxs, device_crossover=1, device=cuda)
    finally:
        sha.load_kernel.cache_clear()


# ---------------------------------------------------------------------------
# B7 (Ed25519 Shamir and windowed), B2 after the header move, B10, B9
# ---------------------------------------------------------------------------

def _ed_adversarial(n, seed):
    """``n`` Ed25519 items cycling through eleven kinds: valid, flipped s
    bit, flipped message bit, the wrong key, s >= L, flipped R sign bit,
    R y >= p, an undecodable key, an undecodable R (y = 2), a short
    signature, valid. Returns (items, oracle verdicts)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        sk = rng.bytes(32)
        pub = ecmath.ed25519_public_key(sk)
        msg = rng.bytes(20 + i % 13)
        sig = ecmath.ed25519_sign(sk, msg)
        kind = i % 11
        if kind == 1:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        elif kind == 2:
            msg = msg[:-1] + bytes([msg[-1] ^ 1])
        elif kind == 3:
            pub = ecmath.ed25519_public_key(rng.bytes(32))
        elif kind == 4:
            s = int.from_bytes(sig[32:], "little") + ecmath.ED_L
            sig = sig[:32] + s.to_bytes(32, "little")
        elif kind == 5:
            sig = sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:]
        elif kind == 6:
            sig = (2**255 - 10).to_bytes(32, "little") + sig[32:]
        elif kind == 7:
            pub = b"\xff" * 32
        elif kind == 8:
            sig = (2).to_bytes(32, "little") + sig[32:]
        elif kind == 9:
            sig = sig[:63]
        items.append((pub, sig, msg))
    return items, [ecmath.ed25519_verify(p, m, s) for p, s, m in items]


@pytest.mark.parametrize("n", [48, 256])
@pytest.mark.parametrize("ladder", ["shamir", "windowed"])
def test_b7_kernels_match_plain_versions_on_the_card(cuda, ladder, n):
    from corda_tpu_torch.ops import ed25519 as ed
    items, want = _ed_adversarial(n, 70 + n)
    if ladder == "shamir":
        *wire, precheck = ed.prepare_batch(items)
        fn, plain, tabs = ed.verify_core, ed.verify_core_plain, ()
    else:
        *wire, precheck = ed.prepare_batch_windowed(items,
                                                    device_tables=False)
        fn, plain = ed.verify_core_windowed, ed.verify_core_windowed_plain
        tabs = ed.windowed_table(cuda)
    args = ed.b7_to_device(wire, cuda)
    before = fn.launches
    ok = fn(*args, *tabs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(ok.cpu(), plain(*args, *tabs).cpu())
    assert list(ok.cpu().numpy() & precheck) == want
    assert True in want and False in want


def test_b2_still_matches_its_plain_version_after_the_header_move(cuda):
    """B2's formulas now live in curve_ed25519.cuh, shared with B7."""
    from corda_tpu_torch.ops import ed25519 as ed
    items, want = _ed_adversarial(256, 81)
    *wire, precheck = ed.prepare_batch_split(items)
    args = ed.wire_to_device(*wire, device=cuda)
    tabs = ed.split_tables(cuda)
    ok = ed.verify_core_split(*args, *tabs)
    torch.cuda.synchronize()
    assert torch.equal(ok.cpu(), ed.verify_core_split_plain(*args,
                                                            *tabs).cpu())
    assert list(ok.cpu().numpy() & precheck) == want
    assert ed.windowed_table(cuda)[0] is tabs[0]   # one table, two kernels


@pytest.mark.parametrize("n", [1, 16, 300, 1024, 65536])
def test_b10_kernel_matches_plain_version_on_the_card(cuda, n):
    from corda_tpu_torch.samples import simm_valuation as simm
    book = simm.demo_portfolio(n, seed=n)
    sens = torch.from_numpy(book).to(cuda)
    rw, corr = simm.model_tensors(cuda)
    before = simm.margin.launches
    k = simm.margin(sens, rw, corr)
    p = simm.margin_plain(sens, rw, corr)
    torch.cuda.synchronize()
    assert simm.margin.launches == before + 1
    assert k.dtype == torch.float32 and k.shape == ()
    kv, pv = float(k), float(p)
    assert abs(kv - pv) <= 1e-5 * pv
    if n <= 1024:
        assert abs(kv - pv) * 100 <= 2
    # the kernel rounds every operation as the plain version does
    assert k.cpu().numpy().tobytes() == p.cpu().numpy().tobytes()
    again = simm.margin(sens, rw, corr)
    assert float(again) == kv                      # no atomics: same order
    cents = simm.compute_margin_cents(book, device=cuda)
    assert cents == int(round(kv * 100))


def test_two_shard_mesh_on_one_card(cuda):
    """Two shards on cuda:0 (two streams): the batch wrapper, the B7
    callables, the sharded Merkle root and the transaction step equal the
    unsharded results, and each path launched its kernels."""
    from corda_tpu_torch import parallel as par
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import sha256 as sha
    mesh = par.make_mesh(devices=[cuda, cuda])
    assert mesh.size == 2 and all(s is not None for s in mesh.streams)
    items, want = _ed_adversarial(64, 90)
    before = ed.verify_core_split.launches
    got = par.sharded_verify_batch_ed25519(mesh, items)
    assert list(got) == want
    assert ed.verify_core_split.launches == before + 2
    *wire, precheck = ed.prepare_batch_windowed(items, device_tables=False)
    before = ed.verify_core_windowed.launches
    ok = par.sharded_ed25519_verify_windowed(mesh)(*wire)
    assert ok.device == cuda and ed.verify_core_windowed.launches == before + 2
    assert list(ok.cpu().numpy() & precheck) == want
    leaves = np.random.default_rng(5).integers(
        0, 1 << 32, (1 << 12, 8), dtype=np.uint64).astype(np.uint32)
    root = par.sharded_merkle_root(mesh)(leaves)
    whole = sha.merkle_root(torch.from_numpy(leaves.view(np.int32)).to(cuda))
    assert torch.equal(root, whole)
    *wire, precheck = ed.prepare_batch(items)
    before = ed.verify_core.launches
    ok, root = par.tx_verify_step(mesh)(*wire, leaves)
    assert ed.verify_core.launches == before + 2
    assert list(ok.cpu().numpy() & precheck) == want
    assert torch.equal(root, whole)


def test_mesh_batcher_on_the_card(cuda):
    from corda_tpu_torch.core.crypto import PublicKey
    from corda_tpu_torch.core.crypto.schemes import EDDSA_ED25519_SHA512
    from corda_tpu_torch.parallel import make_mesh
    from corda_tpu_torch.verifier import SignatureBatcher
    items, want = _ed_adversarial(300, 91)
    checks = [(PublicKey(EDDSA_ED25519_SHA512, p), s, m) for p, s, m in items]
    b = SignatureBatcher(mesh=make_mesh(devices=[cuda, cuda]),
                         host_crossover=0, max_latency_s=0.01)
    try:
        got = b.submit_group(checks).result(timeout=300)
    finally:
        b.close()
    assert got == want
    snap = b.metrics.snapshot()
    assert snap["SigBatcher.DeviceChecked"]["count"] == len(checks)
    assert "SigBatcher.BatchFailure" not in snap


# -- B2 and B4 on lane pairs: ragged edges and rejected rows ----------------

RAGGED = [1, 31, 33, 4095, 4097]


def _tile_wire(wire, axes, n):
    """The first ``n`` items of prepped wire arrays, tiled past their
    length along each array's batch axis."""
    return [np.ascontiguousarray(np.take(a, np.arange(n) % a.shape[ax],
                                         axis=ax))
            for a, ax in zip(wire, axes)]


def _r1_adversarial(seed):
    """secp256r1 items whose precheck fails (no key, off-curve key, r = 0,
    r >= n, high s), tampered ones, a half-gcd host fallback, keys G and -G
    and valid signatures. Returns (items, oracle verdicts)."""
    curve = ecmath.SECP256R1
    rng = np.random.default_rng(seed)
    items = list(_ecdsa_items(curve, 12, seed))
    for kind in range(16):
        priv = (1 if kind == 8 else curve.n - 1 if kind == 9 else
                int.from_bytes(rng.bytes(32), "little") % (curve.n - 1) + 1)
        pub = curve.mul(priv, curve.g)
        msg = rng.bytes(20 + kind)
        r, s = ecmath.ecdsa_sign(curve, priv, msg)
        if kind == 1:
            pub = None
        elif kind == 2:
            pub = (pub[0], (pub[1] + 1) % curve.p)
        elif kind == 3:
            r = 0
        elif kind == 4:
            r = r + curve.n
        elif kind == 5:
            s = curve.n - s
        elif kind == 6:
            msg += b"?"
        items.append((pub, msg, r, s))
    want = [pub is not None and ecmath.ecdsa_verify(curve, pub, msg, r, s)
            for pub, msg, r, s in items]
    return items, want


@pytest.mark.parametrize("n", RAGGED)
def test_b2_lane_pairs_match_plain_version_at_ragged_sizes(cuda, n):
    """B2 runs two lanes a signature on these batch sizes; lanes past the
    last item recompute it and store nothing. Raw verdicts (before the
    precheck mask) equal the plain version's on every lane, rejected rows
    included."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import ed25519 as ed
    items, want = _ed_adversarial(44, 90)
    *wire, precheck = ed.prepare_batch_split(items)
    assert not precheck.all()
    wire = _tile_wire(wire, (1, 2, 0, 0), n)
    args = ed.wire_to_device(*wire, device=cuda)
    tabs = ed.split_tables(cuda)
    ok = ed.verify_core_split(*args, *tabs)
    torch.cuda.synchronize()
    assert torch.equal(ok.cpu(), ed.verify_core_split_plain(*args,
                                                            *tabs).cpu())
    idx = np.arange(n) % len(items)
    assert list(ok.cpu().numpy() & precheck[idx]) == [want[i] for i in idx]
    assert _cuda.geometry("ed25519_split", n)["lanes"] == 2


@pytest.mark.parametrize("n", RAGGED)
def test_b4_lane_pairs_match_plain_version_at_ragged_sizes(cuda, n):
    """B4 on lane pairs at ragged sizes, raw verdicts against the plain
    version, precheck-failed and host-fallback rows included."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import weierstrass as wc
    items, want = _r1_adversarial(91)
    *wire, precheck, forced = wc.prepare_batch_r1_split(ecmath.SECP256R1,
                                                        items)
    assert not precheck.all() and forced.any()
    wire = _tile_wire(wire, (2, 2, 0, 0, 0), n)
    args = [torch.from_numpy(a).to(cuda) for a in wire]
    tabs = wc.r1_split_tables(cuda)
    ok = wc.verify_core_r1_split(*args, *tabs)
    torch.cuda.synchronize()
    assert torch.equal(ok.cpu(), wc.verify_core_r1_split_plain(*args,
                                                               *tabs).cpu())
    idx = np.arange(n) % len(items)
    got = (ok.cpu().numpy() & precheck[idx]) | forced[idx]
    assert list(got) == [want[i] for i in idx]
    assert _cuda.geometry("secp256r1_split", n)["lanes"] == 2


def test_b2_large_batches_run_one_lane_a_signature(cuda):
    """Above the pair threshold B2 runs one lane a signature; that kernel
    too equals the plain version bit for bit, raw, and the wrapper counts
    the launch under its lanes."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import ed25519 as ed
    n = next(k for k in (8193, 16385, 32769)
             if _cuda.geometry("ed25519_split", k)["lanes"] == 1)
    assert _cuda.geometry("ed25519_split", 1)["lanes"] == 2
    items, _ = _ed_adversarial(44, 92)
    *wire, _ = ed.prepare_batch_split(items)
    args = ed.wire_to_device(*_tile_wire(wire, (1, 2, 0, 0), n), device=cuda)
    tabs = ed.split_tables(cuda)
    before = dict(ed.verify_core_split.launches_by_lanes)
    ok = ed.verify_core_split(*args, *tabs)
    ed.verify_core_split(*ed.wire_to_device(
        *_tile_wire(wire, (1, 2, 0, 0), 1024), device=cuda), *tabs)
    torch.cuda.synchronize()
    assert torch.equal(ok.cpu(), ed.verify_core_split_plain(*args,
                                                            *tabs).cpu())
    after = ed.verify_core_split.launches_by_lanes
    assert (after[1] - before[1], after[2] - before[2]) == (1, 1)


def test_b4_runs_lane_pairs_at_every_size(cuda):
    """B4 has one kernel, on lane pairs, at every batch size; at 32768
    items it equals the plain version bit for bit, raw."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import weierstrass as wc
    assert {_cuda.geometry("secp256r1_split", k)["lanes"]
            for k in (1, 16385, 32768)} == {2}
    items, _ = _r1_adversarial(93)
    *wire, _, _ = wc.prepare_batch_r1_split(ecmath.SECP256R1, items)
    args = [torch.from_numpy(a).to(cuda)
            for a in _tile_wire(wire, (2, 2, 0, 0, 0), 32768)]
    tabs = wc.r1_split_tables(cuda)
    ok = wc.verify_core_r1_split(*args, *tabs)
    torch.cuda.synchronize()
    assert torch.equal(ok.cpu(), wc.verify_core_r1_split_plain(*args,
                                                               *tabs).cpu())


def test_b8_glv_holds_two_blocks_a_multiprocessor(cuda):
    """B8 GLV caps its residency at 2 blocks (8 warps) a multiprocessor,
    which a 32768-item batch fills in exactly two waves."""
    from corda_tpu_torch.ops import _cuda
    g = _cuda.geometry("secp256k1_glv", 32768)
    assert (g["block"], g["lanes"], g["blocks_per_sm"]) == (128, 2, 2)


# -- B3 and B8 Shamir on lane pairs ----------------------------------------

@pytest.mark.parametrize("n", RAGGED + [32768])
@pytest.mark.parametrize("name", ["secp256k1_hybrid", "secp256k1_shamir",
                                  "secp256r1_shamir", "secp256k1_glv"])
def test_b3_and_b8_lane_pairs_match_plain_versions_at_every_size(cuda, name,
                                                                  n):
    """B3, both B8 Shamir instantiations and B8 GLV run two lanes a
    signature at every size; raw verdicts equal the plain version's on the
    known-answer items (precheck failures, x(R) = r + n, keys G and -G) and
    signed ones, tiled to ragged sizes and to 32768, and the wrapper counts
    one launch."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import known_answers as ka
    from corda_tpu_torch.ops import weierstrass as wc
    curve = (ecmath.SECP256K1 if name.startswith("secp256k1")
             else ecmath.SECP256R1)
    items = list(ka.k1_items() if curve is ecmath.SECP256K1
                 else ka.r1_items()) + _ecdsa_items(curve, 12, 95)
    want = [pub is not None and ecmath.ecdsa_verify(curve, pub, msg, r, s)
            for pub, msg, r, s in items]
    if name == "secp256k1_hybrid":
        *wire, precheck = wc.prepare_batch_hybrid_wide(items)
        wire = _tile_wire(wire, (1, 2, 0, 0), n)
        fn, plain = wc.verify_core_hybrid_wide, wc.verify_core_hybrid_wide_plain
        tail = wc.hybrid_tables(cuda)
        geometry = _cuda.geometry("secp256k1_hybrid", n)
    elif name == "secp256k1_glv":
        *wire, precheck = wc.prepare_batch_glv(items)
        wire = _tile_wire(wire, (1, 2, 1), n)
        fn, plain, tail = wc.verify_core_glv, wc.verify_core_glv_plain, ()
        geometry = _cuda.geometry("secp256k1_glv", n)
    else:
        *wire, precheck = wc.prepare_batch(curve, items)
        wire = _tile_wire(wire, (1, 1, 1, 1), n)
        fn, plain, tail = wc.verify_core, wc.verify_core_plain, (curve.name,)
        geometry = _cuda.geometry("weierstrass_shamir", n,
                                  0 if curve is ecmath.SECP256K1 else 1)
    assert geometry["lanes"] == 2
    args = [torch.from_numpy(a).to(cuda) for a in wire]
    before = fn.launches
    ok = fn(*args, *tail)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(ok.cpu(), plain(*args, *tail).cpu())
    idx = np.arange(n) % len(items)
    assert list(ok.cpu().numpy() & precheck[idx]) == [want[i] for i in idx]


# -- B7 Shamir on one lane and on lane pairs, B5 on lane pairs --------------

B7_THRESHOLD = [16383, 16384, 16385]


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("n", RAGGED + B7_THRESHOLD)
def test_b7_shamir_lane_variants_match_plain_version_at_ragged_sizes(
        cuda, n, lanes):
    """Each B7 Shamir kernel (one lane, lane pairs; forced through the
    launcher's lanes argument) equals the plain version bit for bit,
    raw, at ragged sizes and at the lane threshold +-1, on adversarial
    items (s >= L, R y >= p, undecodable keys and R among them)."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import ed25519 as ed
    items, want = _ed_adversarial(44, 96)
    *wire, precheck = ed.prepare_batch(items)
    assert not precheck.all()
    s_bits, k_bits, neg_a, r_aff = ed.b7_to_device(wire, "cpu")
    idx = torch.from_numpy(np.arange(n) % len(items))
    args = [s_bits[:, idx], k_bits[:, idx], *(c[idx] for c in neg_a),
            *(c[idx] for c in r_aff)]
    args = [a.contiguous().to(cuda) for a in args]
    ok = _cuda.launch_verify(ed.load_shamir_kernel(),
                             "ed25519_shamir_verify", args, n, cuda, lanes)
    torch.cuda.synchronize()
    plain = ed.verify_core_plain(args[0], args[1], args[2:6], args[6:8])
    assert torch.equal(ok.cpu(), plain.cpu())
    got = ok.cpu().numpy() & precheck[idx.numpy()]
    assert list(got) == [want[i] for i in idx.numpy()]


def test_b7_shamir_wrapper_counts_the_lanes_its_size_selects(cuda):
    """verify_core picks lane pairs up to the threshold and one lane above
    it, and counts each launch under the lanes it ran."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import ed25519 as ed
    items, want = _ed_adversarial(44, 97)
    *wire, precheck = ed.prepare_batch(items)
    s_bits, k_bits, neg_a, r_aff = ed.b7_to_device(wire, "cpu")
    lanes_of = {n: _cuda.geometry("ed25519_shamir", n)["lanes"]
                for n in B7_THRESHOLD + [1, 32768]}
    assert lanes_of[1] == 2 and lanes_of[32768] == 1
    assert (lanes_of[16383], lanes_of[16385]) == (2, 1)
    for n in (16384, 16385):
        idx = torch.from_numpy(np.arange(n) % len(items))
        args = [s_bits[:, idx], k_bits[:, idx], tuple(c[idx] for c in neg_a),
                tuple(c[idx] for c in r_aff)]
        args = ed.b7_to_device(args, cuda)
        before = dict(ed.verify_core.launches_by_lanes)
        ok = ed.verify_core(*args)
        torch.cuda.synchronize()
        after = ed.verify_core.launches_by_lanes
        moved = {k: after[k] - before[k] for k in (1, 2)}
        assert moved == {k: int(k == lanes_of[n]) for k in (1, 2)}
        assert torch.equal(ok.cpu(), ed.verify_core_plain(*args).cpu())


def _windowed_args(n, seed, device):
    """B7 windowed's launcher arguments on ``n`` adversarial items (44
    distinct, tiled): the eleven flat tensors on ``device``, the nested
    ones the wrapper takes, the precheck and the oracle's verdicts."""
    from corda_tpu_torch.ops import ed25519 as ed
    items, want = _ed_adversarial(44, seed)
    *wire, precheck = ed.prepare_batch_windowed(items, device_tables=False)
    assert not precheck.all()
    idx = np.arange(n) % len(items)
    wire = _tile_wire([wire[0], wire[1], *wire[2], wire[3], wire[4]],
                      (1, 2, 0, 0, 0, 0, 0, 0), n)
    flat = [torch.from_numpy(a).to(device) for a in wire]
    nested = (flat[0], flat[1], tuple(flat[2:6]), flat[6], flat[7])
    return (flat + list(ed.windowed_table(device)), nested, precheck[idx],
            [want[i] for i in idx])


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("n", RAGGED + B7_THRESHOLD + [32768])
def test_b7_windowed_lane_variants_match_plain_version_at_every_size(
        cuda, n, lanes):
    """Each B7 windowed kernel (one lane, lane pairs; forced through the
    launcher's lanes argument) equals the plain version bit for bit, raw,
    at ragged sizes, at the lane threshold +-1 and at 32768, on adversarial
    items (s >= L, R y >= p, undecodable keys and R among them)."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import ed25519 as ed
    args, nested, precheck, want = _windowed_args(n, 99, cuda)
    ok = _cuda.launch_verify(ed.load_windowed_kernel(),
                             "ed25519_windowed_verify", args, n, cuda, lanes)
    torch.cuda.synchronize()
    plain = ed.verify_core_windowed_plain(*nested, *args[8:])
    assert torch.equal(ok.cpu(), plain.cpu())
    assert list(ok.cpu().numpy() & precheck) == want


@pytest.mark.parametrize("build", ["as_is", "pair_affine"])
def test_b7_windowed_lane_check_builds_agree_lane_by_lane(cuda, build):
    """B7 windowed's pair kernel built with -DED25519_WINDOWED_LANE_CHECK,
    as shipped and with -DED25519_WINDOWED_PAIR_AFFINE (X zi and Y zi one
    a lane; wrong on every valid item while fe_inv returned zi through a
    reference), on the known answers and adversarial items at 1024 and
    4097: both lanes' verdicts equal the plain version's, both lanes hold
    the same point, zi and affine x and y on every item, and on the first
    64 items zi = Z^(p-2) and every inversion step is right on both
    lanes."""
    import importlib.util
    import pathlib
    from corda_tpu_torch.ops import ed25519 as ed
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    items, _ = _ed_adversarial(256, 1919)
    prep = ed.prepare_batch_windowed(items, device_tables=False)
    lib = cs.finish_b7_lane_build(
        build, *cs.start_b7_lane_builds(names=[build])[build])
    cases = cs.b7_lane_cases(ed, prep, cuda, sizes=(1024, 4097))
    rows = cs.b7_lane_rows(lib, cases, ed.windowed_table(cuda), cuda)
    assert [r["case"] for r in rows] == ["known_answers", "1024", "4097"]
    for row in rows:
        assert all(row[k] == row["items"] for k in cs.B7_LANE_BITS), row
    assert rows[1]["zi_inverse_lanes"] == 2 * cs.B7_LANE_ITEMS
    assert rows[1]["chain_exact_lanes"] == 2 * cs.B7_LANE_ITEMS


def test_b7_windowed_wrapper_counts_the_lanes_its_size_selects(cuda):
    """verify_core_windowed picks lane pairs up to the threshold and one
    lane above it, and counts each launch under the lanes it ran."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import ed25519 as ed
    lanes_of = {n: _cuda.geometry("ed25519_windowed", n)["lanes"]
                for n in B7_THRESHOLD + [1, 32768]}
    assert lanes_of[1] == 2 and lanes_of[32768] == 1
    assert (lanes_of[16383], lanes_of[16385]) == (2, 1)
    for n in (16384, 16385):
        args, nested, _, _ = _windowed_args(n, 100, cuda)
        before = dict(ed.verify_core_windowed.launches_by_lanes)
        ok = ed.verify_core_windowed(*nested, *args[8:])
        torch.cuda.synchronize()
        after = ed.verify_core_windowed.launches_by_lanes
        moved = {k: after[k] - before[k] for k in (1, 2)}
        assert moved == {k: int(k == lanes_of[n]) for k in (1, 2)}
        assert torch.equal(ok.cpu(), ed.verify_core_windowed_plain(
            *nested, *args[8:]).cpu())


@pytest.mark.parametrize("n", RAGGED + [32768])
@pytest.mark.parametrize("name", ["secp256k1", "secp256r1"])
def test_b5_lane_pairs_match_plain_versions_at_every_size(cuda, name, n):
    """Both B5 instantiations run two lanes a signature at every size; raw
    verdicts equal the plain version's on the known-answer items
    (precheck failures, x(R) = r + n, keys G and -G) and signed ones,
    tiled to ragged sizes and to 32768, and the wrapper counts one
    launch."""
    from corda_tpu_torch.ops import _cuda
    from corda_tpu_torch.ops import known_answers as ka
    from corda_tpu_torch.ops import weierstrass as wc
    curve = ecmath.SECP256K1 if name == "secp256k1" else ecmath.SECP256R1
    items = list(ka.k1_items() if curve is ecmath.SECP256K1
                 else ka.r1_items()) + _ecdsa_items(curve, 12, 98)
    want = [pub is not None and ecmath.ecdsa_verify(curve, pub, msg, r, s)
            for pub, msg, r, s in items]
    *wire, precheck = wc.prepare_batch_windowed_single(curve, items)
    wire = _tile_wire(wire, (1, 2, 0, 0, 0, 0), n)
    assert _cuda.geometry("weierstrass_windowed", n,
                          0 if curve is ecmath.SECP256K1 else 1)["lanes"] == 2
    args = [torch.from_numpy(a).to(cuda) for a in wire]
    tail = (*wc.windowed_tables(curve, cuda), curve.name)
    fn = wc.verify_core_windowed_single
    before = fn.launches
    ok = fn(*args, *tail)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(ok.cpu(),
                       wc.verify_core_windowed_single_plain(*args,
                                                            *tail).cpu())
    idx = np.arange(n) % len(items)
    assert list(ok.cpu().numpy() & precheck[idx]) == [want[i] for i in idx]


@pytest.mark.parametrize("target", ["ed25519_split", "secp256r1_split",
                                    "secp256k1_hybrid", "weierstrass_shamir",
                                    "ed25519_shamir", "weierstrass_windowed",
                                    "ed25519_windowed", "secp256k1_glv"])
def test_a_library_that_fails_its_known_answers_is_refused(
        cuda, monkeypatch, target):
    """A freshly loaded B2, B3, B4, B5, B7 or B8 library whose raw verdicts
    differ from the plain version's on the known-answer batch raises
    BuildError and gives no verdict (here the plain version is made to
    disagree)."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import ed25519 as ed
    from corda_tpu_torch.ops import weierstrass as wc
    if target == "ed25519_split":
        mod, plain, load = ed, "verify_core_split_plain", ed.load_kernel
    elif target == "secp256r1_split":
        mod, plain, load = wc, "verify_core_r1_split_plain", \
            wc.load_r1_split_kernel
    elif target == "secp256k1_hybrid":
        mod, plain, load = wc, "verify_core_hybrid_wide_plain", \
            wc.load_hybrid_kernel
    elif target == "weierstrass_shamir":
        mod, plain, load = wc, "verify_core_plain", wc.load_shamir_kernel
    elif target == "ed25519_shamir":
        mod, plain, load = ed, "verify_core_plain", ed.load_shamir_kernel
    elif target == "ed25519_windowed":
        mod, plain, load = ed, "verify_core_windowed_plain", \
            ed.load_windowed_kernel
    elif target == "secp256k1_glv":
        mod, plain, load = wc, "verify_core_glv_plain", wc.load_glv_kernel
    else:
        mod, plain, load = wc, "verify_core_windowed_single_plain", \
            wc.load_windowed_kernel
    real = getattr(mod, plain)
    monkeypatch.setattr(mod, plain, lambda *a: ~real(*a))
    load.cache_clear()
    try:
        with pytest.raises(_build.BuildError, match="known-answer"):
            load()
    finally:
        monkeypatch.undo()
        load.cache_clear()
    load()
