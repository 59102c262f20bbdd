"""Differential tests: the port's ECDSA paths (kernels B3 and B4, their preps
and G tables) against the JAX package's corda_tpu.ops.weierstrass and the
host oracle ecmath.ecdsa_verify.

Inputs are made from numpy seeds and go to both packages. Every comparison
is exact: wire arrays and tables byte for byte, points after conversion to
affine coordinates, verdicts as bools. The JAX kernels are called once per
curve (module fixtures), at the shapes tests/test_ops_curves.py (secp256k1
hybrid, bucket 8) and tests/test_r1_halfgcd.py (secp256r1 split, bucket 16)
already compile; the plain ladders run at those buckets on the CPU.
"""
import functools
import hashlib

import numpy as np
import pytest
import torch

from corda_tpu.core.crypto import ecmath
from corda_tpu.ops import scalarprep as jsp
from corda_tpu.ops import weierstrass as jwc
from corda_tpu_torch import _build
from corda_tpu_torch.ops import field as TF
from corda_tpu_torch.ops import scalarprep as tsp
from corda_tpu_torch.ops import weierstrass as twc

K1, R1 = ecmath.SECP256K1, ecmath.SECP256R1
CURVES = {"secp256k1": K1, "secp256r1": R1}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _crafted_rn(curve, rng, msg: bytes, valid: bool):
    """A signature whose R has x(R) = r + n < p: the r + n candidate of the
    accept (k1) or the half-gcd fallback (r1). Unreachable by honest signing;
    built here by choosing R first and solving for the key:
    Q = r^-1 (s·R - e·G) makes (r, s) valid on ``msg``."""
    p, n = curve.p, curve.n
    while True:
        x = n + int(rng.integers(1, 1 << 60))
        z = (x * x * x + curve.a * x + curve.b) % p
        y = pow(z, (p + 1) // 4, p)
        if y * y % p == z:
            break
    r = x - n
    e = ecmath._bits2int(hashlib.sha256(msg).digest(), n) % n
    s = int(rng.integers(1, 1 << 62)) + (1 << 200)
    Q = curve.mul(pow(r, n - 2, n), curve.add(curve.mul(s, (x, y)),
                                              curve.mul(n - e, curve.g)))
    return (Q, msg, r, s if valid else s + 1)


def _items(curve, n: int, seed: int):
    """``n`` (pub, msg, r, s) items cycling through twelve kinds: valid,
    tampered message, r and s, high s, r = 0, r >= n, an off-curve key, a
    missing key, crafted r + n < p (valid and invalid) and a tiny r."""
    return list(_items_cached(curve.name, n, seed))


@functools.lru_cache(maxsize=None)
def _items_cached(name: str, n: int, seed: int):
    curve = CURVES[name]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        priv = int.from_bytes(rng.bytes(32), "little") % (curve.n - 1) + 1
        pub = curve.mul(priv, curve.g)
        msg = rng.bytes(24 + i % 7)
        r, s = ecmath.ecdsa_sign(curve, priv, msg)
        kind = i % 12
        if kind == 1:
            msg = msg + b"!"
        elif kind == 2:
            r = (r + 1) % curve.n or 1
        elif kind == 3:
            s = s + 1 if s + 1 <= curve.n // 2 else s - 1
        elif kind == 4:
            s = curve.n - s                       # the high-s twin
        elif kind == 5:
            r = 0
        elif kind == 6:
            r = r + curve.n
        elif kind == 7:
            pub = (pub[0], (pub[1] + 1) % curve.p)
        elif kind == 8:
            pub = None
        elif kind in (9, 10):
            out.append(_crafted_rn(curve, rng, msg, kind == 9))
            continue
        elif kind == 11:
            r = 1000
        out.append((pub, msg, r, s))
    return tuple(out)


#: The kinds of ``_mode_items``, in order: the first eight fill one bucket
#: of 8 with every edge case of a ladder.
MODE_KINDS = ("valid", "key G", "key -G", "rn valid", "rn invalid",
              "tampered msg", "high s", "no key", "tampered r", "tampered s",
              "r = 0", "r >= n", "off-curve key", "tiny r")


def _mode_items(curve, n: int, seed: int):
    """``n`` (pub, msg, r, s) items cycling through MODE_KINDS: besides the
    kinds of ``_items``, valid signatures under the keys G (private key 1:
    G + Q is a doubling) and -G (private key n - 1: G + Q is the
    identity)."""
    return list(_mode_items_cached(curve.name, n, seed))


@functools.lru_cache(maxsize=None)
def _mode_items_cached(name: str, n: int, seed: int):
    curve = CURVES[name]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = MODE_KINDS[i % len(MODE_KINDS)]
        priv = {"key G": 1, "key -G": curve.n - 1}.get(
            kind, int.from_bytes(rng.bytes(32), "little") % (curve.n - 1) + 1)
        pub = curve.mul(priv, curve.g)
        msg = rng.bytes(20 + i % 9)
        r, s = ecmath.ecdsa_sign(curve, priv, msg)
        if kind in ("rn valid", "rn invalid"):
            out.append(_crafted_rn(curve, rng, msg, kind == "rn valid"))
            continue
        if kind == "tampered msg":
            msg = msg + b"!"
        elif kind == "high s":
            s = curve.n - s
        elif kind == "no key":
            pub = None
        elif kind == "tampered r":
            r = (r + 1) % curve.n or 1
        elif kind == "tampered s":
            s = s + 1 if s + 1 <= curve.n // 2 else s - 1
        elif kind == "r = 0":
            r = 0
        elif kind == "r >= n":
            r = r + curve.n
        elif kind == "off-curve key":
            pub = (pub[0], (pub[1] + 1) % curve.p)
        elif kind == "tiny r":
            r = 1000
        out.append((pub, msg, r, s))
    return tuple(out)


def _oracle(curve, items):
    return np.asarray([pub is not None
                       and ecmath.ecdsa_verify(curve, pub, msg, r, s)
                       for pub, msg, r, s in items])


# ---------------------------------------------------------------------------
# Formulas
# ---------------------------------------------------------------------------

def _limbs(vals):
    return TF.limbs_tensor(TF.to_limbs(vals))


def _affine(pt, curve):
    X, Y, Z = (TF.from_limbs(TF.canon(c, curve.p)) for c in pt)
    out = []
    for x, y, z in zip(X, Y, Z):
        zi = pow(z, curve.p - 2, curve.p)
        out.append(None if z == 0 else (x * zi % curve.p, y * zi % curve.p))
    return out


@pytest.mark.parametrize("name", ["secp256k1", "secp256r1"])
def test_formulas_match_ecmath(name):
    """_add_k1/_add_m3, _madd_k1/_madd_w and dbl/_dbl_m3 equal ecmath's
    affine group law on random projective representatives, with P == Q,
    P == -Q and the identity (0:1:0) among the inputs."""
    curve = CURVES[name]
    rng = np.random.default_rng(7 if name == "secp256k1" else 8)
    p = curve.p

    def rand(m):
        return int.from_bytes(rng.bytes(32), "little") % (m - 1) + 1
    P = [curve.mul(rand(curve.n), curve.g) for _ in range(6)]
    Q = [curve.mul(rand(curve.n), curve.g) for _ in range(6)]
    Q[1], Q[2] = P[1], (P[2][0], (p - P[2][1]) % p)
    zs = [rand(p) for _ in P]
    Pp = (_limbs([x * z % p for (x, _), z in zip(P, zs)]),
          _limbs([y * z % p for (_, y), z in zip(P, zs)]), _limbs(zs))
    Qp = (_limbs([x for x, _ in Q]), _limbs([y for _, y in Q]),
          _limbs([1] * len(Q)))
    Qa = Qp[:2]
    ident = twc.identity((len(P),))
    want = [curve.add(a, b) for a, b in zip(P, Q)]
    if name == "secp256k1":
        b3 = 3 * curve.b
        add = twc._add_k1(Pp, Qp, p, b3)
        madd = twc._madd_k1(Pp, Qa, p, b3)
        dbl = twc.dbl(Pp, curve)
        id_add = twc._add_k1(ident, Qp, p, b3)
        id_dbl = twc.dbl(ident, curve)
    else:
        add = twc._add_m3(Pp, Qp, p, curve.b)
        madd = twc._madd_w(Pp, Qa, curve)
        dbl = twc._dbl_m3(Pp, p, curve.b)
        id_add = twc._add_m3(ident, Qp, p, curve.b)
        id_dbl = twc._dbl_m3(ident, p, curve.b)
    assert _affine(add, curve) == want
    assert _affine(madd, curve) == want
    assert _affine(dbl, curve) == [curve.add(a, a) for a in P]
    assert _affine(id_add, curve) == Q
    assert _affine(twc._madd_w(ident, Qa, curve), curve) == Q
    assert _affine(id_dbl, curve) == [None] * len(P)
    assert _affine(twc.add(Pp, ident, curve), curve) == P


# ---------------------------------------------------------------------------
# G tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["k1_wide", "r1_g", "r1_g_shifted"])
def test_g_tables_identical_to_jax(which):
    """The port's host-built affine G tables are byte-identical to the JAX
    package's, and load_*_tables_from_numpy installs the JAX arrays as the
    port's device-cached tables."""
    if which == "k1_wide":
        got = twc._g_window_table_wide(K1, 8)
        want = jwc._g_window_table_wide(K1, 8)
    else:
        shift = 0 if which == "r1_g" else 128
        got = twc._g_window_table_single(R1, 16, shift)
        want = jwc._g_window_table_single(R1, 16, shift)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    if which == "k1_wide":
        expect = want
        tabs = twc.load_hybrid_tables_from_numpy(expect, device="cpu")
        assert tabs is twc.hybrid_tables("cpu")
    else:
        expect = (jwc._g_window_table_single(R1, 16, 0)
                  + jwc._g_window_table_single(R1, 16, 128))
        tabs = twc.load_r1_split_tables_from_numpy(expect, device="cpu")
        assert all(a is b for a, b in zip(tabs, twc.r1_split_tables("cpu")))
    assert len(tabs) == len(expect)
    for t, w in zip(tabs, expect):
        assert np.array_equal(t.numpy(), w)
    with pytest.raises(ValueError):
        twc.load_hybrid_tables_from_numpy(want[:2], device="cpu")


# ---------------------------------------------------------------------------
# Host prep: byte-identical wire arrays
# ---------------------------------------------------------------------------

def _assert_arrays_equal(names, got, want):
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name


def _jax_hybrid(prep_out):
    """The JAX hybrid prep's outputs without its table arguments."""
    g_idx, q_bits, pts, r_limbs, _, _, _, precheck = prep_out
    return g_idx, q_bits, pts, r_limbs, precheck


def _jax_r1(prep_out):
    """The JAX split prep's outputs without its tables, with Q flattened."""
    g_idx, q_digits, (q_x, q_y), xd, *_, precheck, forced = prep_out
    return g_idx, q_digits, q_x, q_y, xd, precheck, forced


HYBRID_NAMES = ("g_idx", "q_bits", "pts", "r_limbs", "precheck")
R1_NAMES = ("g_idx", "q_digits", "q_x", "q_y", "xd_limbs", "precheck",
            "forced")


@pytest.mark.parametrize("route", ["native", "python"])
def test_hybrid_prep_identical_to_jax(route):
    """secp256k1 prep, native words and Python: the same wire arrays,
    precheck included, as the JAX package on adversarial items."""
    items = _items(K1, 12, 11)
    if route == "native":
        words = twc._items_to_words(items)
        _assert_arrays_equal(("e", "r", "s", "pub"), words,
                             jwc._items_to_words(items))
        got = twc._prepare_hybrid_native_words(*words)
        want = _jax_hybrid(jwc._prepare_hybrid_native_words(*words, 8))
    else:
        got = twc._prepare_hybrid_python(items)
        want = _jax_hybrid(jwc._prepare_hybrid_python(items, 8))
    _assert_arrays_equal(HYBRID_NAMES, got, want)
    assert list(got[-1]) == [i in (0, 1, 2, 3, 9, 10, 11) for i in range(12)]


@pytest.mark.parametrize("route", ["native", "python"])
def test_r1_split_prep_identical_to_jax(route):
    """secp256r1 half-gcd prep, native words and Python: the same wire
    arrays, effective precheck and forced host verdicts as the JAX package,
    with crafted r + n < p and tiny-r items falling back to the host."""
    items = _items(R1, 12, 12)
    stats = twc.r1_split_stats(reset=True)
    if route == "native":
        words = twc._items_to_words(items)
        got = twc._prepare_r1_split_native_words(*words)
        want = _jax_r1(jwc._prepare_r1_split_native_words(*words, 16))
    else:
        got = twc._prepare_r1_split_python(R1, items)
        want = _jax_r1(jwc._prepare_r1_split_python(R1, items, 16))
    _assert_arrays_equal(R1_NAMES, got, want)
    *_, precheck_eff, forced = got
    fallback = [9, 10, 11]
    assert not precheck_eff[fallback].any()
    assert list(forced[fallback]) == list(_oracle(R1, items)[fallback])
    assert forced[fallback].any()
    stats = twc.r1_split_stats(reset=True)
    assert stats == {"items": 12, "fallback": len(fallback)}


def test_scalarprep_bindings_match_jax():
    """The port's digest/DER word packing and half-gcd seams equal the JAX
    package's (native and Python)."""
    rng = np.random.default_rng(13)
    digests = [hashlib.sha256(rng.bytes(9)).digest() for _ in range(5)]
    assert np.array_equal(tsp.digests_to_words(digests, 4),
                          jsp.digests_to_words(digests, 4))
    sigs = [ecmath.ecdsa_sig_to_der(*ecmath.ecdsa_sign(K1, 5 + i, b"m"))
            for i in range(3)]
    sigs += [b"", b"\x30\x06\x02\x01\x80\x02\x01\x01", sigs[0] + b"\x00"]
    for got, want in zip(tsp.ecdsa_sigs_to_words(sigs),
                         jsp.ecdsa_sigs_to_words(sigs)):
        assert np.array_equal(got, want)
    assert tsp.R1_N == R1.n
    for k in (0, 1, 12345, R1.n - 1, R1.n, 1 << 128,
              int.from_bytes(rng.bytes(32), "little") % R1.n):
        want = jsp.r1_halfgcd_py(k)
        assert tsp.r1_halfgcd_py(k) == want
        assert tsp.r1_halfgcd(k) == want


# ---------------------------------------------------------------------------
# Plain kernels against the JAX kernels (one JAX call per curve)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k1_case():
    """Eight adversarial secp256k1 items (one JAX bucket), the JAX wire
    arrays and tables, and the JAX kernel's raw verdicts on them."""
    items = _items(K1, 8, 21)
    items[5] = _crafted_rn(K1, np.random.default_rng(22), b"rn", True)
    *args, precheck = jwc.prepare_batch_hybrid_wide(items, 8)
    ok = np.asarray(jwc._verify_kernel_hybrid_wide(*args, g_w=8))
    return items, [np.asarray(a) for a in args], precheck, ok


@pytest.fixture(scope="module")
def r1_case():
    """Sixteen adversarial secp256r1 items (one JAX bucket), the JAX wire
    arrays and tables, and the JAX kernel's raw verdicts on them."""
    items = _items(R1, 16, 23)
    *args, precheck, forced = jwc.prepare_batch_r1_split(R1, items, 16)
    ok = np.asarray(jwc._verify_kernel_r1_split(*args, curve_name="secp256r1",
                                                w=16))
    g_idx, q_digits, (q_x, q_y), xd, *tables = args
    arrs = [np.asarray(a) for a in (g_idx, q_digits, q_x, q_y, xd, *tables)]
    return items, arrs, precheck, forced, ok


def _tensors(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def test_plain_hybrid_matches_jax_kernel(k1_case):
    """Plain B3 on the JAX wire arrays and table gives the JAX kernel's
    verdicts bit for bit (an r + n < p item among them), and after the
    precheck the host oracle's."""
    items, arrs, precheck, want = k1_case
    assert ((np.asarray(arrs[0])[0] >> 18) & 1).any()      # an rn_ok row
    got = twc.verify_core_hybrid_wide(*_tensors(arrs)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got & precheck, _oracle(K1, items))


def test_plain_r1_split_matches_jax_kernel(r1_case):
    """Plain B4 on the JAX wire arrays and tables gives the JAX kernel's
    verdicts bit for bit; with the fallbacks' forced verdicts ORed back in,
    the host oracle's."""
    items, arrs, precheck, forced, want = r1_case
    got = twc.verify_core_r1_split(*_tensors(arrs)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal((got & precheck) | forced, _oracle(R1, items))


def test_reference_width_arguments_accepted(k1_case, r1_case):
    """The widths and static arguments the JAX package's callers pass
    (bench.py:152-156, corda_tpu/parallel/sharded.py:181, the r1 kernel's
    jit statics) are accepted at the port's fixed values, with the same
    wire arrays and verdicts as without them."""
    items, arrs, precheck, want = k1_case
    got = twc.prepare_batch_hybrid_wide(items, twc.HYBRID_G_WINDOW)
    for g, w in zip(got, [*arrs[:4], precheck]):
        assert np.array_equal(g, w)
    core = functools.partial(twc.verify_core_hybrid_wide,
                             g_w=twc.HYBRID_G_WINDOW)
    assert np.array_equal(core(*_tensors(arrs)).numpy(), want)
    items, arrs, precheck, forced, want = r1_case
    got = twc.prepare_batch_r1_split(R1, items, twc.R1_G_WINDOW)
    for g, w in zip(got, [*arrs[:5], precheck, forced]):
        assert np.array_equal(g, w)
    ok = twc.verify_core_r1_split(*_tensors(arrs), curve_name="secp256r1",
                                  w=twc.R1_G_WINDOW)
    assert np.array_equal(ok.numpy(), want)


@pytest.mark.parametrize("call", [
    lambda: twc.prepare_batch_hybrid_wide([], 4),
    lambda: twc.prepare_batch_r1_split(R1, [], 8),
    lambda: twc.prepare_batch_windowed_single(K1, [], 8),
    lambda: twc.verify_core_hybrid_wide(*[None] * 7, g_w=4),
    lambda: twc.verify_core_r1_split(*[None] * 11, w=8),
    lambda: twc.verify_core_r1_split(*[None] * 11, curve_name="secp256k1"),
    lambda: twc.verify_core_windowed_single(*[None] * 9, "secp256k1", w=8),
], ids=["hybrid_prep_g_w", "r1_prep_w", "windowed_prep_w", "hybrid_g_w",
        "r1_w", "r1_curve_name", "windowed_w"])
def test_other_widths_refused(call):
    """A width or curve other than the one the port's kernels are built
    for raises ValueError before any work, never a silently different
    wire form."""
    with pytest.raises(ValueError, match="the port's kernels take"):
        call()


# ---------------------------------------------------------------------------
# Batch entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("name", ["secp256k1", "secp256r1"])
def test_verify_batch_matches_oracle(name, route, monkeypatch):
    """verify_batch (item form, padded to a bucket) gives the host oracle's
    verdicts on adversarial items, with the native scalar prep and with the
    Python prep it falls back to; so does the words-form async path."""
    curve = CURVES[name]
    items = _items(curve, 12, 31)
    want = _oracle(curve, items)
    assert want.any() and not want.all()
    if route == "python":
        monkeypatch.setitem(tsp._STATE, "lib", None)
        assert not twc.words_prep_available(curve)
    assert np.array_equal(twc.verify_batch(curve, items, device="cpu"), want)
    if route == "python":
        return
    pending = twc.verify_batch_async_words(
        curve, *twc._items_to_words(items), device="cpu")
    assert pending.n == 12
    assert np.array_equal(twc.finish_batch(pending), want)
    assert twc.finish_batch(twc.verify_batch_async(curve, [],
                                                   device="cpu")).size == 0


def test_verify_batch_modes():
    """Every (curve, mode) pair the reference accepts runs on the CPU and
    agrees with "auto"; unknown or mismatched modes raise ValueError."""
    for curve, modes in ((K1, ("plain", "glv", "windowed", "hybrid")),
                         (R1, ("plain", "windowed", "halfgcd"))):
        items = _items(curve, 8, 41)
        auto = twc.verify_batch(curve, items, device="cpu")
        assert auto.any() and not auto.all()
        for mode in modes:
            got = twc.verify_batch(curve, items, mode=mode, device="cpu")
            assert np.array_equal(got, auto), (curve.name, mode)
    items = _items(K1, 1, 41)
    with pytest.raises(ValueError):
        twc.verify_batch(K1, items, mode="bogus", device="cpu")
    with pytest.raises(ValueError):
        twc.verify_batch(K1, items, mode="halfgcd", device="cpu")
    with pytest.raises(ValueError):
        twc.verify_batch(R1, items, mode="hybrid", device="cpu")
    with pytest.raises(ValueError, match="requires secp256k1"):
        twc.verify_batch(R1, items, mode="glv", device="cpu")


def test_cuda_wrappers_check_arguments_then_build(monkeypatch, tmp_path):
    """The CUDA wrappers refuse a wrong dtype or shape before anything
    else, and where no compiler can build the kernel they raise
    BuildError — never the plain version's verdicts."""
    args = _tensors([np.zeros((16, 8), np.int32),
                     np.zeros((16, 4, 8), np.uint8),
                     np.zeros((8, 4, 16), np.uint16),
                     np.zeros((8, 16), np.uint16),
                     np.zeros((1 << 18, 16), np.uint16),
                     np.zeros((1 << 18, 16), np.uint16),
                     np.zeros(1 << 18, np.uint8)])
    bad = list(args)
    bad[2] = bad[2].to(torch.int32)
    with pytest.raises(ValueError, match="pts"):
        twc.verify_core_hybrid_wide_cuda(*bad)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    for name in ("secp256k1_hybrid", "secp256r1_split"):
        monkeypatch.setitem(_build._TARGETS[name], "compiler", lambda: None)
    twc.load_hybrid_kernel.cache_clear()
    twc.load_r1_split_kernel.cache_clear()
    before = twc.verify_core_hybrid_wide.launches
    try:
        with pytest.raises(_build.BuildError, match="secp256k1_hybrid"):
            twc.verify_core_hybrid_wide_cuda(*args)
        with pytest.raises(_build.BuildError):
            twc.load_kernels()
    finally:
        twc.load_hybrid_kernel.cache_clear()
        twc.load_r1_split_kernel.cache_clear()
    assert twc.verify_core_hybrid_wide.launches == before
