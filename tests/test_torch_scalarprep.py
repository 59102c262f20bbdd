"""Differential tests: the port's scalar prep (native library built from
native/scalarmath.cpp by corda_tpu_torch._build, and its pure-Python
fallback) against corda_tpu.ops.scalarprep.ed_prep, bit for bit."""
import hashlib

import numpy as np
import pytest

from corda_tpu.core.crypto import ecmath
from corda_tpu.ops import scalarprep as jsp
from corda_tpu_torch.ops import ed25519 as ted
from corda_tpu_torch.ops import scalarprep as tsp

RNG = np.random.default_rng(1017)


def _inputs(n):
    digests = [hashlib.sha512(RNG.bytes(40)).digest() for _ in range(n)]
    s_ints = [int.from_bytes(RNG.bytes(32), "little") % ecmath.ED_L
              for _ in range(n)]
    # range-check edges: s = L - 1 (ok), L (reject), 2^256 - 1 (reject)
    s_ints[:3] = [ecmath.ED_L - 1, ecmath.ED_L, (1 << 256) - 1]
    return digests, tsp.ints_to_words(s_ints)


def test_word_helpers_match_jax():
    digests, s_words = _inputs(12)
    assert np.array_equal(tsp.le_digests_to_words(digests, 8),
                          jsp.le_digests_to_words(digests, 8))
    ints = [int.from_bytes(RNG.bytes(32), "little") for _ in range(5)]
    assert np.array_equal(tsp.ints_to_words(ints), jsp.ints_to_words(ints))


def test_native_build_has_expected_abi():
    """The library the port builds from native/scalarmath.cpp passes its
    ABI gate (sm_version 3)."""
    if not jsp.available():
        pytest.skip("the JAX package's libscalarmath is not built here")
    assert tsp.SM_VERSION == jsp.SM_VERSION == 3
    assert tsp.available()


@pytest.mark.parametrize("route", ["native", "python"])
def test_ed_prep_matches_jax(route):
    if not jsp.available():
        pytest.skip("the JAX package's libscalarmath is not built here")
    digests, s_words = _inputs(37)
    want = jsp.ed_prep(jsp.le_digests_to_words(digests, 8), s_words)
    if route == "native":
        got = tsp.ed_prep(tsp.le_digests_to_words(digests, 8), s_words)
    else:
        got = ted._split_windows_python(digests, s_words)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert not got[3][1] and not got[3][2] and got[3][0]
