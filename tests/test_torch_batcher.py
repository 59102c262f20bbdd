"""The port's SignatureBatcher against the JAX package's, on the CPU.

Both batchers take the same checks (made from a numpy seed) with
``host_crossover=0``, so Ed25519 batches take the device route: the JAX
batcher's jitted kernel on the CPU, the port's plain PyTorch kernel. Verdicts
and the routing counters must agree exactly. secp256k1/r1 have no device
kernel in the port yet and must take its host queue.
"""
import numpy as np
import pytest

from corda_tpu.core.crypto import generate_keypair as jax_keypair
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
        assert tb.breaker_status() == {"ed25519": {
            "state": "closed", "trips": 0, "consecutive_failures": 0}}
    finally:
        jb.close()
        tb.close()


@pytest.mark.parametrize("scheme", [ECDSA_SECP256K1_SHA256,
                                    ECDSA_SECP256R1_SHA256],
                         ids=lambda s: s.scheme_code_name)
def test_ecdsa_checks_take_the_host_queue(scheme):
    """No k1/r1 device kernel yet: their checks are routed to the host
    queue at enqueue time — never to a device bucket or its breaker."""
    kp = generate_keypair(scheme, entropy=RNG.bytes(32))
    msg = b"ecdsa routes to host"
    sig = Crypto.sign_with_key(kp, msg).bytes
    bad = sig[:-1] + bytes([sig[-1] ^ 1])
    b = SignatureBatcher(device="cpu", host_crossover=0, max_latency_s=0.01)
    try:
        got = b.submit_group([(kp.public, sig, msg), (kp.public, bad, msg)]
                             ).result(timeout=120)
        assert got == [True, False]
        snap = b.metrics.snapshot()
        assert snap["SigBatcher.Checked"]["count"] == 2
        assert "SigBatcher.DeviceChecked" not in snap
        assert set(b.breaker_status()) == {"ed25519"}
    finally:
        b.close()


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
    """The kernel's build as on a machine without nvcc: an empty build
    directory and no compiler to fill it."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.ops import ed25519 as ted
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setitem(_build._TARGETS["ed25519_split"], "compiler",
                        lambda: None)
    ted.load_kernel.cache_clear()


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


def test_device_default_raises_without_cuda_and_mesh_is_not_ported():
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SignatureBatcher()
    with pytest.raises(NotImplementedError):
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
