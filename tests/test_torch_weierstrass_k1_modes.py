"""Differential tests of the secp256k1 verify modes that run kernels B5
(windowed) and B8 (plain Shamir, glv): the port's preps, plain ladders and
verdicts against the JAX package's corda_tpu.ops.weierstrass, ecmath's
group law and the host oracle ecmath.ecdsa_verify.

Inputs are made from numpy seeds (``_mode_items``: valid signatures, the
keys G and -G, crafted r + n < p signatures, and tampered, high-s, missing,
off-curve and out-of-range inputs). Every comparison is exact. The JAX
kernels are called once per mode (a module fixture) on one bucket of 8
items, the shape tests/test_ops_curves.py compiles for k1 "plain" and
"glv"; no JAX test compiles k1 "windowed", so its verdicts are held to the
oracle and to the port's own hybrid (B3) route instead.
"""
import numpy as np
import pytest
import torch

from corda_tpu.ops import weierstrass as jwc
from corda_tpu_torch import _build
from corda_tpu_torch.ops import weierstrass as twc
from test_torch_weierstrass import (K1, MODE_KINDS, _affine,
                                    _assert_arrays_equal, _mode_items,
                                    _oracle)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


#: Two full cycles of MODE_KINDS for the preps and ladders; one bucket of
#: eight (the JAX kernels' compiled shape) for the JAX verdicts.
PREP_ITEMS = 2 * len(MODE_KINDS)
SEED = 51


def _prep_items(n: int = PREP_ITEMS):
    """The first ``n`` of the module's items (generated once)."""
    return _mode_items(K1, PREP_ITEMS, SEED)[:n]


def _tensors(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _scalars(items):
    """(precheck, pubs, u1s, u2s) of the shared acceptance policy."""
    precheck, pubs, u1s, u2s, _, _ = twc._precheck_and_scalars(K1, items)
    return precheck, pubs, u1s, u2s


def _want_points(items):
    """ecmath's affine [u1]G + [u2]Q per item (None for the identity)."""
    _, pubs, u1s, u2s = _scalars(items)
    return [K1.add(K1.mul(u1, K1.g), K1.mul(u2, q))
            for q, u1, u2 in zip(pubs, u1s, u2s)]


# ---------------------------------------------------------------------------
# (a) host preps, byte for byte
# ---------------------------------------------------------------------------

def test_plain_prep_identical_to_jax():
    items = _prep_items()
    u1, u2, q_pts, r_cands, precheck = twc.prepare_batch(K1, items)
    j_u1, j_u2, j_q, j_rc, j_pre = jwc.prepare_batch(K1, items)
    _assert_arrays_equal(
        ("u1_bits", "u2_bits", "q_pts", "r_cands", "precheck"),
        (u1, u2, q_pts, r_cands, precheck),
        (j_u1, j_u2, np.stack([np.asarray(c) for c in j_q]), j_rc, j_pre))
    rejected = ("high s", "no key", "r = 0", "r >= n", "off-curve key")
    assert list(precheck) == [MODE_KINDS[i % len(MODE_KINDS)] not in rejected
                              for i in range(PREP_ITEMS)]


def test_glv_prep_identical_to_jax():
    items = _prep_items()
    got = twc.prepare_batch_glv(items)
    j_bits, j_pts, j_rc, j_pre = jwc.prepare_batch_glv(items)
    j_pts = np.stack([np.stack([np.asarray(c) for c in pt]) for pt in j_pts])
    _assert_arrays_equal(("bits4", "pts4", "r_cands", "precheck"), got,
                         (j_bits, j_pts, j_rc, j_pre))
    assert got[0].shape == (128, PREP_ITEMS, 4)


def test_windowed_prep_identical_to_jax():
    """k1 windowed is the Python prep in both packages (the native window
    prep is secp256r1's)."""
    items = _prep_items()
    got = twc.prepare_batch_windowed_single(K1, items)
    (j_g, j_q, (j_qx, j_qy), j_r, j_rn, *_tables,
     j_pre) = jwc.prepare_batch_windowed_single(K1, items, 16)
    _assert_arrays_equal(
        ("g_idx", "q_digits", "q_x", "q_y", "r_limbs", "rn_ok", "precheck"),
        got, (j_g, j_q, j_qx, j_qy, j_r, j_rn, j_pre))
    assert got[1].shape == (16, 4, PREP_ITEMS)
    assert got[5][[3, 4]].all()          # crafted r + n < p


def test_windowed_width_argument_accepted():
    """prepare_batch_windowed_single and verify_core_windowed_single take
    the JAX functions' width ``w`` at the port's R1_G_WINDOW, with the same
    arrays and verdicts as without it."""
    items = _prep_items(3)
    got = twc.prepare_batch_windowed_single(K1, items, twc.R1_G_WINDOW)
    _assert_arrays_equal(
        ("g_idx", "q_digits", "q_x", "q_y", "r_limbs", "rn_ok", "precheck"),
        got, twc.prepare_batch_windowed_single(K1, items))
    *wire, precheck = got
    ok = twc.verify_core_windowed_single(
        *_tensors(wire), *twc.windowed_tables(K1, "cpu"), "secp256k1",
        w=twc.R1_G_WINDOW)
    assert np.array_equal(ok.numpy() & precheck, _oracle(K1, items))


def test_glv_prep_keeps_the_128_bit_bound(monkeypatch):
    """A GLV half of more than 128 bits is refused, never truncated."""
    items = _prep_items(1)
    monkeypatch.setattr(twc, "glv_decompose", lambda k: (1 << 128, 0))
    with pytest.raises(OverflowError):
        twc.prepare_batch_glv(items)


def test_windowed_tables_load_from_jax():
    """The port's 2^16-row secp256k1 table is byte-identical to the JAX
    package's, and loading the JAX arrays installs them as the port's
    device-cached windowed table."""
    want = jwc._g_window_table_single(K1, 16)
    for g, w in zip(twc._g_window_table_single(K1, 16), want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    tabs = twc.load_windowed_tables_from_numpy({"secp256k1": want}, "cpu")
    assert all(a is b for a, b in zip(tabs["secp256k1"],
                                      twc.windowed_tables(K1, "cpu")))
    for t, w in zip(tabs["secp256k1"], want):
        assert np.array_equal(t.numpy(), w)
    with pytest.raises(ValueError):
        twc.load_windowed_tables_from_numpy({"secp256k1": want[:2]}, "cpu")
    with pytest.raises(ValueError, match="unknown curve"):
        twc.load_windowed_tables_from_numpy({"p384": want}, "cpu")


# ---------------------------------------------------------------------------
# (b) plain ladders against ecmath's group law
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "glv", "windowed"])
def test_plain_ladder_matches_ecmath(mode):
    """Each plain ladder's affine result is ecmath's [u1]G + [u2]Q (the
    identity for the items the precheck replaced)."""
    items = _prep_items()
    if mode == "plain":
        u1, u2, q = (torch.from_numpy(a.astype(np.int64))
                     for a in twc.prepare_batch(K1, items)[:3])
        g = tuple(torch.from_numpy(twc.F.to_limbs([v] * PREP_ITEMS).astype(
            np.int64)) for v in (K1.gx, K1.gy, 1))
        pt = twc.shamir_ladder(u1, u2, g, tuple(q), K1)
    elif mode == "glv":
        bits4, pts4, _, _ = twc.prepare_batch_glv(items)
        pts4 = torch.from_numpy(pts4.astype(np.int64))
        pt = twc.glv_ladder(torch.from_numpy(bits4.astype(np.int64)),
                            [tuple(p) for p in pts4], K1)
    else:
        g_idx, q_digits, q_x, q_y, *_ = twc.prepare_batch_windowed_single(
            K1, items)
        g_idx, q_digits, q_x, q_y = (torch.from_numpy(a.astype(np.int64))
                                     for a in (g_idx, q_digits, q_x, q_y))
        tab = tuple(t.to(torch.int64) for t in twc.windowed_tables(K1, "cpu"))
        pt = twc.windowed_ladder_single(g_idx, q_digits, (q_x, q_y), tab, K1)
    assert _affine(pt, K1) == _want_points(items)


# ---------------------------------------------------------------------------
# (c) verdicts: the JAX kernels and the host oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_verdicts():
    """One bucket of eight items and the JAX verify_batch verdicts of the
    two modes the JAX tests compile for secp256k1."""
    items = _prep_items(8)
    return items, {mode: np.asarray(jwc.verify_batch(K1, items, mode=mode))
                   for mode in ("plain", "glv")}


@pytest.mark.parametrize("mode", ["plain", "glv"])
def test_verdicts_match_jax_kernel(jax_verdicts, mode):
    items, want = jax_verdicts
    got = twc.verify_batch(K1, items, mode=mode, device="cpu")
    assert np.array_equal(got, want[mode])
    assert np.array_equal(got, _oracle(K1, items))
    assert got[:4].all() and not got[4:].any()


def test_windowed_verdicts_match_the_hybrid_route():
    """No JAX test compiles k1 windowed: its verdicts are held to the port's
    B3 route and the oracle on every kind, crafted r + n items included."""
    items = _prep_items(len(MODE_KINDS))
    got = twc.verify_batch(K1, items, mode="windowed", device="cpu")
    assert np.array_equal(got, twc.verify_batch(K1, items, mode="hybrid",
                                                device="cpu"))
    assert np.array_equal(got, _oracle(K1, items))


@pytest.mark.parametrize("mode", ["plain", "glv"])
def test_every_kind_matches_oracle(mode):
    items = _prep_items(len(MODE_KINDS))
    want = _oracle(K1, items)
    assert list(want) == [k in ("valid", "key G", "key -G", "rn valid")
                          for k in MODE_KINDS]
    assert np.array_equal(twc.verify_batch(K1, items, mode=mode,
                                           device="cpu"), want)


def test_cuda_wrappers_refuse_bad_arguments_before_building():
    """The B5/B8 CUDA wrappers refuse a wrong dtype, shape or curve with
    ValueError before they build or launch anything."""
    items = _prep_items(8)
    cases = (
        (twc.verify_core_cuda, list(twc.prepare_batch(K1, items)[:4]),
         [K1.name]),
        (twc.verify_core_glv_cuda, list(twc.prepare_batch_glv(items)[:3]),
         []),
        (twc.verify_core_windowed_single_cuda,
         list(twc.prepare_batch_windowed_single(K1, items)[:6])
         + [t.numpy() for t in twc.windowed_tables(K1, "cpu")], [K1.name]))
    builds = dict(_build.BUILD_COUNT)
    for fn, wire, extra in cases:
        args = _tensors(wire)
        for k in range(len(args)):
            bad = list(args)
            bad[k] = bad[k].to(torch.int64)
            with pytest.raises(ValueError):
                fn(*bad, *extra)
            bad[k] = args[k][:1].contiguous()
            with pytest.raises(ValueError):
                fn(*bad, *extra)
        if extra:
            with pytest.raises(ValueError, match="unknown curve"):
                fn(*args, "p384")
    assert dict(_build.BUILD_COUNT) == builds
