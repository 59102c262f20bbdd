"""Differential tests: the port's field engine (corda_tpu_torch.ops.field)
against the JAX package's (corda_tpu.ops.field), exactly, over p25519,
secp256k1's PSECP and P-256's PSECR1.

Inputs come from a numpy seed and go through both engines; results are
compared after canonicalisation (the two engines keep different relaxed-limb
forms, so only ``canon`` outputs must agree). Tolerance: exact equality of
integers.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from corda_tpu.ops import field as JF
from corda_tpu_torch.ops import field as TF

P = JF.P25519
RNG = np.random.default_rng(20261017)
PRIMES = {"p25519": JF.P25519, "secp256k1": JF.PSECP, "p256": JF.PSECR1}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rand_elems(n):
    return [int.from_bytes(RNG.bytes(32), "little") % P for _ in range(n)]


def _pair(xs):
    """The same elements as a JAX-engine u64 limb array and a port tensor."""
    limbs = JF.to_limbs(xs)
    return limbs, TF.limbs_tensor(TF.to_limbs(xs))


def test_host_helpers_identical_to_jax():
    xs = _rand_elems(16) + [0, 1, P - 1, (1 << 256) - 1]
    assert np.array_equal(TF.to_limbs(xs), JF.to_limbs(xs))
    assert np.array_equal(TF.to_limbs(xs[0]), JF.to_limbs(xs[0]))
    assert TF.from_limbs(JF.to_limbs(xs)) == xs
    assert TF.from_limbs(TF.limbs_tensor(TF.to_limbs(xs))) == xs
    for n in (0, 1, 7, 8, 9, 255, 256, 257, 32768):
        assert TF.bucket_size(n) == JF.bucket_size(n)
        assert TF.bucket_size(n, floor=256) == JF.bucket_size(n, floor=256)
    for nbits in (256, 128, 253):
        ys = [x >> (256 - nbits) for x in xs]
        assert np.array_equal(TF.scalars_to_bits(ys, nbits),
                              JF.scalars_to_bits(ys, nbits))


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub"])
def test_binary_ops_match_jax(op):
    xs, ys = _rand_elems(8), _rand_elems(8)
    ja, ta = _pair(xs)
    jb, tb = _pair(ys)
    if op == "sqr":
        want = JF.canon(JF.sqr(ja, P), P)
        got = TF.canon(TF.sqr(ta))
    else:
        want = JF.canon(getattr(JF, op)(ja, jb, P), P)
        got = TF.canon(getattr(TF, op)(ta, tb))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


def test_mul_const_and_inv25519_match_jax():
    xs = _rand_elems(8)
    xs[3] = 0                       # inv(0) = 0 in both engines
    ja, ta = _pair(xs)
    want = JF.canon(JF.mul_const(ja, 2, P), P)
    assert np.array_equal(np.asarray(want).astype(np.int64),
                          TF.canon(TF.mul_const(ta, 2)).numpy())
    want = JF.canon(JF.inv25519(ja), P)
    got = TF.canon(TF.inv25519(ta))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    assert TF.from_limbs(got)[0] == pow(xs[0], P - 2, P)


def test_engine_holds_at_its_limb_bounds():
    """Every limb at the contract maximum (2^17 - 1): products, sums and
    differences stay exact in int64 lanes and canonicalise to the right
    residue."""
    top = torch.full((2, 16), (1 << 17) - 1, dtype=torch.int64)
    v = TF.from_limbs(top[0])
    zero = torch.zeros_like(top)
    cases = [(TF.mul(top, top), v * v), (TF.add(top, top), 2 * v),
             (TF.sub(zero, top), -v), (TF.mul_const(top, 2), 2 * v)]
    for got, want in cases:
        assert int(got.max()) < (1 << 17)
        assert TF.from_limbs(TF.canon(got))[0] == want % P


def _header_words(header: str):
    src = (pathlib.Path(TF.__file__).resolve().parent.parent / "csrc"
           / header).read_text()

    def words(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", src).group(1)
        vals = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(v << (32 * i) for i, v in enumerate(vals))
    return words


def test_cuda_header_constants_match_ecmath():
    """The device headers' constant words are the host constants: 2d and
    p of edwards25519, p and n of secp256k1, p and b of P-256, in the
    one-thread fields and in the pair kernels' Comba fields (with
    2^256 - p of P-256), and the generators of both curves (with P-256's
    order) in the one-thread and the pair formulas."""
    from corda_tpu_torch.core.crypto import ecmath
    words = _header_words("field25519.cuh")
    assert words("FE_D2") == ecmath.ED_D2
    assert words("FE_P") == P
    words = _header_words("field_k1.cuh")
    assert words("K1_P") == ecmath.SECP256K1.p == TF.PSECP
    assert words("K1_N") == ecmath.SECP256K1.n
    words = _header_words("field_p256.cuh")
    assert words("P256_P") == ecmath.SECP256R1.p == TF.PSECR1
    assert words("P256_B") == ecmath.SECP256R1.b
    words = _header_words("field_p256_comba.cuh")
    assert words("P256_P") == ecmath.SECP256R1.p
    assert words("P256_B") == ecmath.SECP256R1.b
    assert words("P256_C") == (1 << 256) - ecmath.SECP256R1.p
    words = _header_words("field25519_comba.cuh")
    assert words("FE_D2") == ecmath.ED_D2
    assert words("FE_P") == P
    words = _header_words("field_k1_comba.cuh")
    assert words("K1_P") == ecmath.SECP256K1.p
    assert words("K1_N") == ecmath.SECP256K1.n
    for header in ("curve_k1.cuh", "curve_k1_pair.cuh"):
        words = _header_words(header)
        assert (words("K1_GX"), words("K1_GY")) == ecmath.SECP256K1.g
    for header in ("curve_p256.cuh", "curve_p256_pair.cuh"):
        words = _header_words(header)
        assert (words("P256_GX"), words("P256_GY")) == ecmath.SECP256R1.g
        assert words("P256_N") == ecmath.SECP256R1.n


def _edges(p):
    return [0, 1, p - 1, p, p + 1, (1 << 256) - 1, 1 << 128, (1 << 256) - p]


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "canon"])
@pytest.mark.parametrize("prime", ["secp256k1", "p256"])
def test_secp_ops_match_jax(prime, op):
    """The k1 and P-256 mul, sqr, add, sub and canon give the JAX engine's
    canonical output, exactly, on random values and on the edges 0, 1,
    p-1, p, p+1, 2^256-1, 2^128 (2^128 · 2^128 among the products) and
    2^256 - p; every limb of every result stays inside the contract."""
    p = PRIMES[prime]
    xs = _edges(p) + [int.from_bytes(RNG.bytes(32), "little")
                      for _ in range(8)]
    ys = list(reversed(_edges(p))) + [int.from_bytes(RNG.bytes(32), "little")
                                      for _ in range(8)]
    ja, ta = _pair(xs)
    jb, tb = _pair(ys)
    if op == "canon":
        want = JF.canon(ja, p)
        got = TF.canon(ta, p)
    elif op == "sqr":
        want = JF.canon(JF.sqr(ja, p), p)
        got = TF.sqr(ta, p)
    else:
        want = JF.canon(getattr(JF, op)(ja, jb, p), p)
        got = getattr(TF, op)(ta, tb, p)
    if op != "canon":
        assert int(got.abs().max()) < TF.LIMB_BOUND
        got = TF.canon(got, p)
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    ref = {"mul": lambda x, y: x * y, "sqr": lambda x, y: x * x,
           "add": lambda x, y: x + y, "sub": lambda x, y: x - y,
           "canon": lambda x, y: x}[op]
    assert TF.from_limbs(got) == [ref(x, y) % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("prime", ["p25519", "secp256k1", "p256"])
def test_signed_limbs_at_their_bounds(prime):
    """Every limb at +(2^17 - 1) or -(2^17 - 1): products, sums,
    differences, small-constant multiples and is_zero stay exact in int64
    lanes over each prime."""
    p = PRIMES[prime]
    top = torch.full((2, 16), TF.LIMB_BOUND - 1, dtype=torch.int64)
    for t in (top, -top):
        v = sum(int(x) << (16 * i) for i, x in enumerate(t[0].tolist()))
        cases = [(TF.mul(t, t, p), v * v), (TF.add(t, t, p), 2 * v),
                 (TF.sub(t, -t, p), 2 * v), (TF.mul_const(t, 21, p), 21 * v),
                 (t, v)]
        for got, want in cases:
            assert int(got.abs().max()) < TF.LIMB_BOUND
            assert TF.from_limbs(TF.canon(got, p))[0] == want % p
    vals = TF.limbs_tensor(TF.to_limbs([0, p, 1, p - 1]))
    assert TF.is_zero(vals, p).tolist() == [True, True, False, False]
