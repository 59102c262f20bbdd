"""The port's SignatureBatcher against the JAX batcher's DEVICE route on
secp256r1, on the CPU.

A secp256r1 group of 12 checks (one JAX bucket of 16: valid signatures, a
tampered message, a flipped DER byte, the wrong key, the high-s twin, an
undecodable key, and crafted r + n < p signatures that only the half-gcd
split's host fallback accepts) goes through both batchers with
``host_crossover=0``: the JAX batcher's jitted half-gcd split kernel, the
port's plain B4. Verdicts, the routing counters and the breaker states
must agree. The JAX kernel takes about two minutes to trace on this CPU,
so it runs once, in a module fixture, in this file of its own."""
import pytest
import torch

from corda_tpu.core.crypto.schemes import ECDSA_SECP256R1_SHA256
from corda_tpu.core.crypto.signatures import Crypto as JaxCrypto
from corda_tpu.verifier.batcher import SignatureBatcher as JaxBatcher
from corda_tpu_torch.verifier.batcher import SignatureBatcher

from test_torch_batcher import _counts, _ecdsa_checks

N_CHECKS = 12


@pytest.fixture(scope="module")
def runs():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    checks = _ecdsa_checks(ECDSA_SECP256R1_SHA256, N_CHECKS)
    want = [bool(JaxCrypto.is_valid(*c)) for c in checks]
    out = {"want": want}
    for name, batcher in (
            ("jax", JaxBatcher(host_crossover=0, max_latency_s=0.01)),
            ("port", SignatureBatcher(device="cpu", host_crossover=0,
                                      max_latency_s=0.01))):
        try:
            verdicts = batcher.submit_group(checks).result(timeout=900)
            out[name] = {"verdicts": verdicts, "counts": _counts(batcher),
                         "breakers": batcher.breaker_status()}
        finally:
            batcher.close()
    torch.set_num_threads(prev)
    return out


def test_r1_verdicts_match_the_jax_device_route(runs):
    assert runs["port"]["verdicts"] == runs["jax"]["verdicts"] == runs["want"]
    # kinds by i % 7: valid, five invalid kinds, a crafted r + n < p
    assert runs["want"] == (([True] + [False] * 5 + [True]) * 2)[:N_CHECKS]


def test_r1_counters_match_the_jax_device_route(runs):
    assert runs["port"]["counts"] == runs["jax"]["counts"]
    assert runs["port"]["counts"]["SigBatcher.DeviceChecked"] == N_CHECKS
    assert runs["port"]["counts"]["SigBatcher.DeviceBatches"] == 1
    assert runs["port"]["counts"].get("SigBatcher.BatchFailure", 0) == 0


def test_r1_breakers_match_the_jax_device_route(runs):
    assert runs["port"]["breakers"] == runs["jax"]["breakers"]
    assert runs["port"]["breakers"]["secp256r1"]["state"] == "closed"
