"""The port's SignatureBatcher against the JAX package's, on the CPU.

Both batchers take the same checks (made from a numpy seed) with
``host_crossover=0``, so Ed25519 batches take the device route: the JAX
batcher's jitted kernel on the CPU, the port's plain PyTorch kernel. Verdicts
and the routing counters must agree exactly. secp256k1 and secp256r1 checks
take the port's device buckets too (plain B3/B4 on the CPU); there the JAX
batcher keeps its host route — its ECDSA kernels take minutes to trace on the
CPU — and the verdicts must agree with it and with the construction.
"""
import hashlib

import numpy as np
import pytest
import torch

from corda_tpu.core.crypto import ecmath
from corda_tpu.core.crypto import generate_keypair as jax_keypair
from corda_tpu.core.crypto.keys import PublicKey as JaxPublicKey
from corda_tpu.core.crypto.schemes import (ECDSA_SECP256K1_SHA256,
                                           ECDSA_SECP256R1_SHA256)
from corda_tpu.core.crypto.signatures import Crypto as JaxCrypto
from corda_tpu.verifier.batcher import SignatureBatcher as JaxBatcher
from corda_tpu_torch.core.crypto import generate_keypair
from corda_tpu_torch.core.crypto.keys import PublicKey
from corda_tpu_torch.core.crypto.schemes import EDDSA_ED25519_SHA512
from corda_tpu_torch.core.crypto.signatures import Crypto
from corda_tpu_torch.utils.faults import FaultRule, inject
from corda_tpu_torch.verifier.batcher import SignatureBatcher

RNG = np.random.default_rng(32768)
COUNTERS = ("SigBatcher.Checked", "SigBatcher.DeviceChecked",
            "SigBatcher.DeviceBatches", "SigBatcher.HostRouted",
            "SigBatcher.BatchFailure")
CLOSED = {"state": "closed", "trips": 0, "consecutive_failures": 0}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ed_checks(n):
    """Ed25519 checks signed by the JAX package's keys (n <= 8: one JAX
    bucket), every fourth one tampered."""
    checks = []
    for i in range(n):
        kp = jax_keypair(entropy=RNG.bytes(32))
        msg = RNG.bytes(24 + i)
        sig = JaxCrypto.sign_with_key(kp, msg).bytes
        if i % 4 == 1:
            sig = sig[:5] + bytes([sig[5] ^ 4]) + sig[6:]
        checks.append((kp.public, sig, msg))
    return checks


def _counts(batcher):
    snap = batcher.metrics.snapshot()
    return {k: snap[k]["count"] for k in COUNTERS if k in snap}


def _drive(batcher, checks):
    """submit_group of all, then submit_many, then single submits —
    each waited on, so each is its own flush."""
    out = [batcher.submit_group(checks).result(timeout=300)]
    out.append([f.result(timeout=300)
                for f in batcher.submit_many(checks[:5])])
    out.append([batcher.submit(*c).result(timeout=300) for c in checks[:2]])
    return out


def test_verdicts_and_counters_match_jax_batcher():
    checks = _ed_checks(8)
    jb = JaxBatcher(host_crossover=0, max_latency_s=0.01)
    tb = SignatureBatcher(device="cpu", host_crossover=0, max_latency_s=0.01)
    try:
        want = _drive(jb, checks)
        got = _drive(tb, checks)
        assert got == want
        assert want[0] == [i % 4 != 1 for i in range(8)]
        assert _counts(tb) == _counts(jb)
        assert _counts(tb)["SigBatcher.DeviceChecked"] == 8 + 5 + 2
        assert tb.breaker_status() == {"ed25519": CLOSED,
                                       "secp256k1": CLOSED,
                                       "secp256r1": CLOSED}
    finally:
        jb.close()
        tb.close()


@pytest.mark.parametrize("scheme", [ECDSA_SECP256K1_SHA256,
                                    ECDSA_SECP256R1_SHA256],
                         ids=lambda s: s.scheme_code_name)
def test_ecdsa_checks_take_the_host_queue(scheme):
    """Below the host crossover (default 192) a k1 or r1 batch takes the
    host queue, as in the JAX batcher: same verdicts, same counters, and
    the scheme's breaker is never touched."""
    kp = generate_keypair(scheme, entropy=RNG.bytes(32))
    msg = b"ecdsa routes to host"
    sig = Crypto.sign_with_key(kp, msg).bytes
    bad = sig[:-1] + bytes([sig[-1] ^ 1])
    checks = [(kp.public, sig, msg), (kp.public, bad, msg)]
    jb = JaxBatcher(max_latency_s=0.01)
    b = SignatureBatcher(device="cpu", max_latency_s=0.01)
    try:
        got = b.submit_group(checks).result(timeout=120)
        assert got == jb.submit_group(checks).result(timeout=120)
        assert got == [True, False]
        assert _counts(b) == _counts(jb)
        assert _counts(b)["SigBatcher.HostRouted"] == 2
        assert b.breaker_status()[scheme_bucket(scheme)] == CLOSED
    finally:
        jb.close()
        b.close()


def scheme_bucket(scheme) -> str:
    return {ECDSA_SECP256K1_SHA256.scheme_number_id: "secp256k1",
            ECDSA_SECP256R1_SHA256.scheme_number_id: "secp256r1"}[
                scheme.scheme_number_id]


def _crafted_rn_check(scheme, curve, msg: bytes):
    """A valid check whose R has x(R) = r + n < p (unreachable by honest
    signing): R is chosen first and the key solved for, Q = r^-1 (sR - eG).
    k1 accepts it through the r + n candidate, r1 through the host
    fallback of the half-gcd split."""
    p, n = curve.p, curve.n
    x = n + 1
    while True:
        z = (x * x * x + curve.a * x + curve.b) % p
        y = pow(z, (p + 1) // 4, p)
        if y * y % p == z:
            break
        x += 1
    r = x - n
    e = ecmath._bits2int(hashlib.sha256(msg).digest(), n) % n
    s = (1 << 200) + 12345
    Q = curve.mul(pow(r, n - 2, n), curve.add(curve.mul(s, (x, y)),
                                              curve.mul(n - e, curve.g)))
    key = JaxPublicKey(scheme, b"\x04" + Q[0].to_bytes(32, "big")
                       + Q[1].to_bytes(32, "big"))
    return key, ecmath.ecdsa_sig_to_der(r, s), msg


def _ecdsa_checks(scheme, n):
    """``n`` checks signed by the JAX package's keys of ``scheme``: valid,
    a tampered message, a flipped DER byte, the wrong key, the high-s twin,
    an undecodable key, and a crafted r + n < p signature (valid)."""
    curve = ecmath.SECP256K1 if scheme is ECDSA_SECP256K1_SHA256 \
        else ecmath.SECP256R1
    checks = []
    for i in range(n):
        kp = jax_keypair(scheme, entropy=RNG.bytes(32))
        msg = RNG.bytes(20 + i)
        sig = JaxCrypto.sign_with_key(kp, msg).bytes
        kind = i % 7
        if kind == 1:
            msg = msg + b"?"
        elif kind == 2:
            sig = sig[:-3] + bytes([sig[-3] ^ 0x10]) + sig[-2:]
        elif kind == 3:
            kp = jax_keypair(scheme, entropy=RNG.bytes(32))
        elif kind == 4:
            r, s = ecmath.ecdsa_sig_from_der(sig)
            sig = ecmath.ecdsa_sig_to_der(r, curve.n - s)
        elif kind == 5:
            checks.append((JaxPublicKey(scheme, b"\x02" + b"\xff" * 32),
                           sig, msg))
            continue
        elif kind == 6:
            checks.append(_crafted_rn_check(scheme, curve, msg))
            continue
        checks.append((kp.public, sig, msg))
    return checks


def test_ecdsa_device_buckets_match_the_jax_batcher():
    """Mixed Ed25519, secp256k1 and secp256r1 checks with host_crossover=0:
    each scheme takes its own device bucket in the port (plain B2, B3, B4
    on the CPU) and the verdicts equal the JAX batcher's and the
    construction's; DeviceChecked counts every check, each breaker stays
    closed and the flight recorder books one launch per ECDSA kernel."""
    from corda_tpu_torch.observability import KernelProfiler, set_profiler
    from corda_tpu_torch.observability.profiling import get_profiler
    checks = (_ed_checks(8) + _ecdsa_checks(ECDSA_SECP256K1_SHA256, 8)
              + _ecdsa_checks(ECDSA_SECP256R1_SHA256, 8))
    want = [bool(JaxCrypto.is_valid(*c)) for c in checks]
    assert want.count(True) == 6 + 3 + 3
    assert want[8 + 6] and want[16 + 6]        # the crafted r + n items
    jb = JaxBatcher(max_latency_s=0.01)
    tb = SignatureBatcher(device="cpu", host_crossover=0, max_latency_s=0.05)
    prof, old = KernelProfiler(), get_profiler()
    set_profiler(prof)
    try:
        got = tb.submit_group(checks).result(timeout=600)
        assert got == jb.submit_group(checks).result(timeout=300) == want
        counts = _counts(tb)
        assert counts["SigBatcher.DeviceChecked"] == len(checks)
        assert counts["SigBatcher.DeviceBatches"] == 3
        assert "SigBatcher.BatchFailure" not in counts
        assert tb.breaker_status() == {"ed25519": CLOSED,
                                       "secp256k1": CLOSED,
                                       "secp256r1": CLOSED}
        kernels = prof.snapshot()["kernels"]
        for name in ("ed25519.split", "weierstrass.hybrid_k1",
                     "weierstrass.r1_split"):
            assert kernels[name]["dispatches"] == 1
    finally:
        set_profiler(old)
        jb.close()
        tb.close()


def test_breaker_trips_under_the_ports_fault_point():
    """The port's own fault_point("batcher.device_dispatch") drives the
    host fallback and the breaker exactly as a failing kernel would."""
    kp = generate_keypair(entropy=b"\x44" * 32)
    msg = b"breaker"
    sig = Crypto.sign_with_key(kp, msg).bytes
    clock = [0.0]
    b = SignatureBatcher(device="cpu", host_crossover=1, breaker_threshold=3,
                         breaker_cooldown_s=30.0,
                         breaker_clock=lambda: clock[0])
    try:
        with inject(FaultRule("batcher.device_dispatch", "raise",
                              detail="ed25519"), seed=7) as inj:
            for _ in range(5):
                assert b.submit(kp.public, sig, msg).result(timeout=60)
            assert b.breaker_status()["ed25519"]["state"] == "open"
            assert inj.fired("batcher.device_dispatch") == 3
        snap = b.metrics.snapshot()
        assert snap["Breaker.Trips"]["count"] == 1
        assert snap["SigBatcher.BatchFailure"]["count"] == 3
        assert snap["SigBatcher.BreakerRouted"]["count"] == 2
    finally:
        b.close()


def _without_compiler(monkeypatch, tmp_path):
    """The kernels' builds as on a machine without nvcc: an empty build
    directory and no compiler to fill it."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import ed25519 as ted
    from corda_tpu_torch.ops import weierstrass as twc
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    for name in ("ed25519_split", "secp256k1_hybrid", "secp256r1_split"):
        monkeypatch.setitem(_build._TARGETS[name], "compiler", lambda: None)
    for load in (ted.load_kernel, twc.load_hybrid_kernel,
                 twc.load_r1_split_kernel):
        load.cache_clear()


def _signed(entropy: bytes, msg: bytes):
    kp = generate_keypair(entropy=entropy)
    return kp.public, Crypto.sign_with_key(kp, msg).bytes, msg


def test_kernel_build_error_fails_the_futures_not_over_to_host(
        monkeypatch, tmp_path):
    """A kernel that does not build is no transient fault: the BuildError
    reaches the caller through the batch's futures, nothing is verified on
    the host in its place, and the breaker does not trip into the host
    route however often it happens."""
    from corda_tpu_torch._build import BuildError
    from corda_tpu_torch.ops import ed25519 as ted
    _without_compiler(monkeypatch, tmp_path)
    # the CPU tensors take the CUDA wrapper's path: argument checks, then
    # the kernel's library, whose build fails
    monkeypatch.setattr(ted, "verify_core_split_plain",
                        ted.verify_core_split_cuda)
    check = _signed(b"\x45" * 32, b"no compiler")
    b = SignatureBatcher(device="cpu", host_crossover=1, breaker_threshold=3)
    try:
        for _ in range(4):
            with pytest.raises(BuildError, match="no compiler"):
                b.submit_group([check, check]).result(timeout=60)
        snap = b.metrics.snapshot()
        assert snap["SigBatcher.BatchFailure"]["count"] == 4
        assert "SigBatcher.Checked" not in snap
        assert "SigBatcher.BreakerRouted" not in snap
        assert b.breaker_status()["ed25519"]["state"] == "closed"
    finally:
        b.close()


@pytest.mark.parametrize("scheme", [ECDSA_SECP256K1_SHA256,
                                    ECDSA_SECP256R1_SHA256],
                         ids=lambda s: s.scheme_code_name)
def test_ecdsa_kernel_build_error_reaches_the_caller(monkeypatch, tmp_path,
                                                     scheme):
    """A secp256k1 or secp256r1 kernel that does not build fails the
    batch's futures with BuildError: no host verdicts in its place, and the
    scheme's breaker stays closed."""
    from corda_tpu_torch._build import BuildError
    from corda_tpu_torch.ops import weierstrass as twc
    _without_compiler(monkeypatch, tmp_path)
    # the CPU tensors take the CUDA wrappers' path: argument checks, then
    # the kernel's library, whose build fails
    monkeypatch.setattr(twc, "verify_core_hybrid_wide_plain",
                        twc.verify_core_hybrid_wide_cuda)
    monkeypatch.setattr(twc, "verify_core_r1_split_plain",
                        twc.verify_core_r1_split_cuda)
    kp = generate_keypair(scheme, entropy=RNG.bytes(32))
    sig = Crypto.sign_with_key(kp, b"no compiler").bytes
    check = (kp.public, sig, b"no compiler")
    b = SignatureBatcher(device="cpu", host_crossover=1, breaker_threshold=3)
    try:
        for _ in range(3):
            with pytest.raises(BuildError, match="no compiler"):
                b.submit_group([check, check]).result(timeout=120)
        snap = b.metrics.snapshot()
        assert snap["SigBatcher.BatchFailure"]["count"] == 3
        assert "SigBatcher.Checked" not in snap
        assert b.breaker_status()[scheme_bucket(scheme)] == CLOSED
    finally:
        b.close()


def test_kernel_fault_at_the_wait_fails_the_futures(monkeypatch):
    """A kernel that faults while it runs (its wait raises LaunchError)
    fails the batch's futures, single submits included, with no host
    verdicts and no breaker failure."""
    from corda_tpu_torch._build import LaunchError
    from corda_tpu_torch.ops import ed25519 as ted

    def faulted(pending):
        raise LaunchError("ed25519_split_verify failed on the card")

    monkeypatch.setattr(ted, "finish_batch", faulted)
    check = _signed(b"\x46" * 32, b"faulted")
    b = SignatureBatcher(device="cpu", host_crossover=1)
    try:
        with pytest.raises(LaunchError):
            b.submit_group([check] * 3).result(timeout=60)
        with pytest.raises(LaunchError):
            b.submit(*check).result(timeout=60)
        snap = b.metrics.snapshot()
        assert snap["SigBatcher.BatchFailure"]["count"] == 2
        assert "SigBatcher.Checked" not in snap
        assert b.breaker_status()["ed25519"]["consecutive_failures"] == 0
    finally:
        b.close()


@pytest.mark.parametrize("scheme", [ECDSA_SECP256K1_SHA256,
                                    ECDSA_SECP256R1_SHA256],
                         ids=lambda s: s.scheme_code_name)
def test_ecdsa_kernel_fault_at_the_wait_fails_the_futures(monkeypatch,
                                                          scheme):
    """A secp256k1 or secp256r1 kernel that faults while it runs (its wait
    raises LaunchError) fails the batch's futures: no host verdicts, no
    breaker failure. The launch itself is stubbed; only the wait faults."""
    from corda_tpu_torch._build import LaunchError
    from corda_tpu_torch.ops import weierstrass as twc

    def faulted(pending):
        raise LaunchError("the ECDSA kernel failed on the card")

    monkeypatch.setattr(twc, "verify_batch_async_words",
                        lambda curve, *words, device: object())
    monkeypatch.setattr(twc, "finish_batch", faulted)
    kp = generate_keypair(scheme, entropy=RNG.bytes(32))
    check = (kp.public, Crypto.sign_with_key(kp, b"faulted").bytes,
             b"faulted")
    b = SignatureBatcher(device="cpu", host_crossover=1)
    try:
        with pytest.raises(LaunchError):
            b.submit_group([check] * 3).result(timeout=60)
        snap = b.metrics.snapshot()
        assert snap["SigBatcher.BatchFailure"]["count"] == 1
        assert "SigBatcher.Checked" not in snap
        assert b.breaker_status()[scheme_bucket(scheme)] == CLOSED
    finally:
        b.close()


def test_device_default_raises_without_cuda_and_mesh_is_not_ported():
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SignatureBatcher()
    # mesh= is ported: together with device= it raises the reference's
    # ValueError (tests/test_torch_batcher_mesh.py drives a mesh)
    with pytest.raises(ValueError, match="pass mesh= or device=, not both"):
        SignatureBatcher(device="cpu", mesh=object())


def test_scheme_routing_is_by_number_not_identity():
    """A key whose scheme object is not this package's (a JAX-built key)
    still routes by its scheme number."""
    kp = jax_keypair(entropy=b"\x45" * 32)
    assert kp.public.scheme is not EDDSA_ED25519_SHA512
    port_key = PublicKey(EDDSA_ED25519_SHA512, kp.public.encoded)
    msg = b"routing"
    sig = JaxCrypto.sign_with_key(kp, msg).bytes
    assert Crypto.is_valid(kp.public, sig, msg)
    assert Crypto.is_valid(port_key, sig, msg)


def test_flight_recorder_keeps_the_jax_snapshot_keys():
    """The port's KernelProfiler counts launches and builds instead of jit
    compiles but serves the JAX package's /debug/profile keys; a CPU batch
    books one warm dispatch of "ed25519.split" (nothing was built)."""
    from corda_tpu.observability import KernelProfiler as JaxProfiler
    from corda_tpu_torch.observability import KernelProfiler, set_profiler
    from corda_tpu_torch.observability.profiling import get_profiler
    from corda_tpu_torch.ops import ed25519 as ted
    prof, old = KernelProfiler(), get_profiler()
    set_profiler(prof)
    try:
        items = [(c[0].encoded, c[1], c[2]) for c in _ed_checks(3)]
        assert list(ted.verify_batch(items, device="cpu")) == [True, False,
                                                               True]
    finally:
        set_profiler(old)
    snap = prof.snapshot()
    assert sorted(snap) == sorted(JaxProfiler().snapshot())
    k = snap["kernels"]["ed25519.split"]
    assert (k["dispatches"], k["compiles"], k["cache_hits"]) == (1, 0, 1)
    assert k["device_waits"] == 1
    assert snap["occupancy"]["ed25519"]["live_total"] == 3


def test_profile_dir_exports_a_torch_profiler_trace(tmp_path, monkeypatch):
    """CORDA_TPU_PROFILE_DIR: each device dispatch is a record_function
    range of a torch.profiler profile exported as a Chrome trace on close()
    (the device start is stubbed so the trace stays small)."""
    import json
    monkeypatch.setenv("CORDA_TPU_PROFILE_DIR", str(tmp_path))
    kp = generate_keypair(entropy=b"\x46" * 32)
    sig = Crypto.sign_with_key(kp, b"p").bytes
    b = SignatureBatcher(device="cpu", host_crossover=0, max_latency_s=0.01)
    b._start_ed25519 = lambda items: (None, lambda _p: [True] * len(items))
    try:
        assert b.submit(kp.public, sig, b"p").result(timeout=60)
    finally:
        b.close()
    traces = list(tmp_path.glob("sig-batcher-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("verify-ed25519-")
               for e in events)


def test_secp256k1_counters_match_the_jax_device_route():
    """A small secp256k1 set through both batchers' device routes
    (host_crossover=0; the JAX batcher traces its hybrid kernel once, at
    bucket 8): the same verdicts, the same Checked, DeviceChecked,
    DeviceBatches, HostRouted and BatchFailure counts, and the same
    breaker states."""
    checks = _ecdsa_checks(ECDSA_SECP256K1_SHA256, 7)
    want = [bool(JaxCrypto.is_valid(*c)) for c in checks]
    assert want == [True] + [False] * 5 + [True]
    jb = JaxBatcher(host_crossover=0, max_latency_s=0.01)
    tb = SignatureBatcher(device="cpu", host_crossover=0, max_latency_s=0.01)
    try:
        assert jb.submit_group(checks).result(timeout=600) == want
        assert tb.submit_group(checks).result(timeout=600) == want
        assert _counts(tb) == _counts(jb)
        assert _counts(tb)["SigBatcher.DeviceChecked"] == len(checks)
        assert _counts(tb)["SigBatcher.DeviceBatches"] == 1
        assert tb.breaker_status() == jb.breaker_status()
    finally:
        jb.close()
        tb.close()
