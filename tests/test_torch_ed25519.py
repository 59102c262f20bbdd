"""Differential tests: the port's Ed25519 split-k path against the JAX
package's (corda_tpu.ops.ed25519) and the host oracle.

Inputs are made from a numpy seed. Every comparison is exact: limb arrays
and tables byte for byte, points after canonicalisation, verdicts as bools.
JAX calls stay at bucket 8, the size tests/test_ops_curves.py compiles.
"""
import numpy as np
import pytest
import torch

from corda_tpu.core.crypto import ecmath
from corda_tpu.ops import ed25519 as jed
from corda_tpu.ops import field as JF
from corda_tpu_torch.core.crypto import ecmath as tecmath
from corda_tpu_torch.ops import ed25519 as ted
from corda_tpu_torch.ops import field as TF

RNG = np.random.default_rng(25519)
P = ecmath.ED_P


def _rand_points(k):
    pts = []
    for _ in range(k):
        s = int.from_bytes(RNG.bytes(32), "little") % ecmath.ED_L
        pts.append(ecmath.ed_to_affine(
            ecmath.ed_scalar_mul(s, ecmath.ed_to_extended(ecmath.ED_B))))
    return pts


def _ext_tensor(pts):
    cols = ([x for x, _ in pts], [y for _, y in pts], [1] * len(pts),
            [x * y % P for x, y in pts])
    return tuple(TF.limbs_tensor(TF.to_limbs(c)) for c in cols)


def _canon_affine(jax_pt, torch_pt):
    """Both packages' extended points → canonical (X/Z, Y/Z) per item."""
    out = []
    for pt, from_limbs in ((jax_pt, JF.from_limbs), (torch_pt, TF.from_limbs)):
        xs, ys, zs, _ = (from_limbs(np.asarray(c) if not isinstance(
            c, torch.Tensor) else c) for c in pt)
        out.append([(x * pow(z, P - 2, P) % P, y * pow(z, P - 2, P) % P)
                    for x, y, z in zip(xs, ys, zs)])
    return out


def _signed_items(n, tamper=True):
    items = []
    for i in range(n):
        seed = RNG.bytes(32)
        pub = ecmath.ed25519_public_key(seed)
        msg = RNG.bytes(40 + i)
        sig = ecmath.ed25519_sign(seed, msg)
        if tamper and i % 4 == 1:    # corrupt signature
            sig = sig[:10] + bytes([sig[10] ^ 1]) + sig[11:]
        if tamper and i % 4 == 2:    # corrupt message
            msg = msg[:-1] + bytes([msg[-1] ^ 0xFF])
        if tamper and i % 4 == 3:    # wrong key
            pub = ecmath.ed25519_public_key(RNG.bytes(32))
        items.append((pub, sig, msg))
    return items


def _adversarial_items():
    """The malformed-input and R-encoding cases of tests/test_ops_curves.py
    (eight items: one JAX bucket)."""
    seed = RNG.bytes(32)
    pub = ecmath.ed25519_public_key(seed)
    msg = b"sign-bit coverage"
    sig = ecmath.ed25519_sign(seed, msg)
    bad_s = sig[:32] + (ecmath.ED_L + 1).to_bytes(32, "little")
    flipped_sign = sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:]
    non_canonical = (2**255 - 10).to_bytes(32, "little") + sig[32:]
    off_curve = (2).to_bytes(32, "little") + sig[32:]
    return [(b"\xff" * 32, sig, msg), (pub, b"\x00" * 63, msg),
            (pub, bad_s, msg), (pub, sig, msg), (pub, flipped_sign, msg),
            (pub, non_canonical, msg), (pub, off_curve, msg),
            (pub, sig, msg + b"!")]


def test_niels_tables_identical_to_jax():
    for shift in (0, 128):
        want = jed._b_window_table(16, shift)
        got = ted._b_window_table(16, shift)
        for g, w in zip(got, want):
            assert g.dtype == np.uint16 and g.shape == (65536, 16)
            assert np.array_equal(g, w)


def test_prepare_batch_split_byte_identical_to_jax():
    items = _signed_items(5) + _adversarial_items()[:3]
    want = jed.prepare_batch_split(items, device_tables=False)
    got = ted.prepare_batch_split(items)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    assert list(got[-1]) == [True] * 5 + [False] * 3


def test_point_formulas_match_jax():
    pts, qts = _rand_points(4), _rand_points(4)
    qts[1] = pts[1]                   # doubling through the complete add
    jp, jq = jed._pack_point_ext(pts), jed._pack_point_ext(qts)
    tp, tq = _ext_tensor(pts), _ext_tensor(qts)
    want, got = _canon_affine(jed.add(jp, jq), ted.add(tp, tq))
    assert got == want
    want, got = _canon_affine(jed.double(jp), ted.double(tp))
    assert got == want
    niels = [[(y + x) % P for x, y in qts], [(y - x) % P for x, y in qts],
             [ecmath.ED_D2 * x % P * y % P for x, y in qts]]
    jn = [JF.to_limbs(c) for c in niels]
    tn = [TF.limbs_tensor(TF.to_limbs(c)) for c in niels]
    jp64 = tuple(np.asarray(c).astype(np.uint64) for c in jp)
    want, got = _canon_affine(jed.madd_niels(jp64, *jn),
                              ted.madd_niels(tp, *tn))
    assert got == want
    host = [ecmath.ed_to_affine(ecmath.ed_point_add(
        ecmath.ed_to_extended(p), ecmath.ed_to_extended(q)))
        for p, q in zip(pts, qts)]
    assert want == host


def test_plain_split_kernel_on_jax_wire_and_tables():
    """The port's plain verify_core_split, fed the JAX package's own wire
    arrays and Niels tables, reproduces the JAX kernel's verdicts."""
    items = _signed_items(8)
    want = jed.verify_batch(items)
    *wire, precheck = jed.prepare_batch_split(items, device_tables=False)
    tabs = ted.load_tables_from_numpy(
        jed._b_window_table(16, 0) + jed._b_window_table(16, 128),
        device="cpu")
    args = ted.wire_to_device(*(np.asarray(a) for a in wire), device="cpu")
    ok = ted.verify_core_split(*args, *tabs)
    assert ok.dtype == torch.bool and ok.shape == (8,)
    assert list(ok.numpy() & precheck) == list(want)
    oracle = [ecmath.ed25519_verify(p, m, s) for p, s, m in items]
    assert list(want) == oracle and any(oracle) and not all(oracle)


def test_verify_batch_adversarial_matches_jax_and_oracle():
    items = _adversarial_items()
    want = list(jed.verify_batch(items))
    got = list(ted.verify_batch(items, device="cpu"))
    oracle = [tecmath.ed25519_verify(p, m, s) for p, s, m in items]
    assert got == want == oracle
    assert got == [False, False, False, True, False, False, False, False]


def test_wrapper_never_falls_back_off_the_cpu():
    """The wrapper runs the plain version only for CPU tensors: other
    devices launch the kernel or raise, and the CUDA build raises where
    nvcc is absent instead of degrading."""
    from corda_tpu_torch import _build
    meta = [torch.empty(s, dtype=d, device="meta") for s, d in
            (((16, 8), torch.int32), ((8, 8, 8), torch.uint8),
             ((8, 6, 16), torch.uint16), ((8, 16), torch.uint16))]
    with pytest.raises(ValueError):
        ted.verify_core_split(*meta, *meta[:1] * 6)
    if _build.nvcc_path() is None:
        with pytest.raises(_build.BuildError):
            _build.build_all(["ed25519_split"])
    assert ted.verify_core_split.launches == 0 or torch.cuda.is_available()
