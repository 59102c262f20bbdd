"""Differential tests: the port's p25519 engine (corda_tpu_torch.ops.field)
against the JAX package's (corda_tpu.ops.field), exactly.

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


def test_cuda_header_constants_match_ecmath():
    """The device header's 2d and p words are the host constants."""
    from corda_tpu_torch.core.crypto import ecmath
    src = (pathlib.Path(TF.__file__).resolve().parent.parent / "csrc"
           / "field25519.cuh").read_text()

    def words(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", src).group(1)
        vals = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(v << (32 * i) for i, v in enumerate(vals))

    assert words("FE_D2") == ecmath.ED_D2
    assert words("FE_P") == P
