"""Differential tests of the secp256r1 verify modes that run kernels B5
(windowed) and B8 (plain Shamir): the port's preps (native and Python),
plain ladders and verdicts against the JAX package's
corda_tpu.ops.weierstrass and scalarprep, ecmath's group law and the host
oracle ecmath.ecdsa_verify.

Inputs are made from numpy seeds (``_mode_items``). Every comparison is
exact. The JAX kernels are called once per mode (a module fixture) on one
bucket of 8 items, the shape tests/test_ops_curves.py compiles for r1
"plain" and "windowed".
"""
import numpy as np
import pytest
import torch

from corda_tpu.ops import scalarprep as jsp
from corda_tpu.ops import weierstrass as jwc
from corda_tpu_torch import _build
from corda_tpu_torch.core.crypto.ecmath import WeierstrassCurve
from corda_tpu_torch.ops import scalarprep as tsp
from corda_tpu_torch.ops import weierstrass as twc
from test_torch_weierstrass import (MODE_KINDS, R1, _affine,
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


#: Two full cycles of MODE_KINDS, generated once; their first eight (one
#: bucket, the JAX kernels' compiled shape) feed the JAX verdicts.
PREP_ITEMS = 2 * len(MODE_KINDS)
SEED = 61

WINDOWED_NAMES = ("g_idx", "q_digits", "q_x", "q_y", "r_limbs", "rn_ok",
                  "precheck")


def _prep_items(n: int = PREP_ITEMS):
    return _mode_items(R1, PREP_ITEMS, SEED)[:n]


def _jax_windowed(prep_out):
    """The JAX windowed prep's outputs without its tables, Q flattened."""
    g, q, (qx, qy), r, rn, *_tables, pre = prep_out
    return g, q, qx, qy, r, rn, pre


# ---------------------------------------------------------------------------
# (a), (d) host preps, byte for byte
# ---------------------------------------------------------------------------

def test_plain_prep_identical_to_jax():
    items = _prep_items()
    got = twc.prepare_batch(R1, items)
    j_u1, j_u2, j_q, j_rc, j_pre = jwc.prepare_batch(R1, items)
    _assert_arrays_equal(
        ("u1_bits", "u2_bits", "q_pts", "r_cands", "precheck"), got,
        (j_u1, j_u2, np.stack([np.asarray(c) for c in j_q]), j_rc, j_pre))
    rn = [i for i in range(PREP_ITEMS) if MODE_KINDS[i % 14] == "rn valid"]
    assert not np.array_equal(got[3][0][rn], got[3][1][rn])   # r + n < p


@pytest.mark.parametrize("route", ["native", "python"])
def test_windowed_prep_identical_to_jax(route):
    """Native (sm_r1_prep) and Python windowed preps: the same wire arrays
    as the JAX package's, and the same as each other."""
    items = _prep_items()
    if route == "native":
        assert tsp.available()
        words = twc._items_to_words(items)
        got = twc._prepare_windowed_single_native_words(*words)
        want = _jax_windowed(jwc._prepare_windowed_single_native_words(
            *words, 16))
        assert np.array_equal(got[0], twc._prepare_windowed_single_python(
            R1, items)[0])
    else:
        got = twc._prepare_windowed_single_python(R1, items)
        want = _jax_windowed(jwc._prepare_windowed_single_python(R1, items,
                                                                 16))
    _assert_arrays_equal(WINDOWED_NAMES, got, want)
    _assert_arrays_equal(WINDOWED_NAMES, got,
                         twc._prepare_windowed_single_python(R1, items))
    assert got[1].shape == (16, 4, PREP_ITEMS)


def test_r1_prep_binding_identical_to_jax():
    """The port's sm_r1_prep binding returns the JAX binding's arrays."""
    words = twc._items_to_words(_prep_items())
    names = ("g_idx", "q_digits", "q_x", "q_y", "r_limbs", "rn_ok",
             "precheck")
    got = tsp.r1_prep(*words)
    _assert_arrays_equal(names, got, jsp.r1_prep(*words))
    assert got[1].shape == (64, PREP_ITEMS)


def test_windowed_tables_load_from_jax():
    """Loading the JAX package's secp256r1 table installs it as the port's
    windowed table, which is the split kernel's G table too (one cached
    copy)."""
    want = jwc._g_window_table_single(R1, 16)
    tabs = twc.load_windowed_tables_from_numpy({"secp256r1": want}, "cpu")
    split = twc.r1_split_tables("cpu")
    assert all(a is b for a, b in zip(tabs["secp256r1"],
                                      twc.windowed_tables(R1, "cpu")))
    assert all(a is b for a, b in zip(tabs["secp256r1"], split[:3]))
    for t, w in zip(tabs["secp256r1"], want):
        assert np.array_equal(t.numpy(), w)


# ---------------------------------------------------------------------------
# (b) plain ladders against ecmath's group law
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "windowed"])
def test_plain_ladder_matches_ecmath(mode):
    """Each plain ladder's affine result is ecmath's [u1]G + [u2]Q (the
    identity for the items the precheck replaced)."""
    items = _prep_items()
    _, pubs, u1s, u2s, _, _ = twc._precheck_and_scalars(R1, items)
    want = [R1.add(R1.mul(u1, R1.g), R1.mul(u2, q))
            for q, u1, u2 in zip(pubs, u1s, u2s)]
    if mode == "plain":
        u1, u2, q = (torch.from_numpy(a.astype(np.int64))
                     for a in twc.prepare_batch(R1, items)[:3])
        g = tuple(torch.from_numpy(twc.F.to_limbs([v] * PREP_ITEMS).astype(
            np.int64)) for v in (R1.gx, R1.gy, 1))
        pt = twc.shamir_ladder(u1, u2, g, tuple(q), R1)
    else:
        g_idx, q_digits, q_x, q_y, *_ = twc.prepare_batch_windowed_single(
            R1, items)
        g_idx, q_digits, q_x, q_y = (torch.from_numpy(a.astype(np.int64))
                                     for a in (g_idx, q_digits, q_x, q_y))
        tab = tuple(t.to(torch.int64) for t in twc.windowed_tables(R1, "cpu"))
        pt = twc.windowed_ladder_single(g_idx, q_digits, (q_x, q_y), tab, R1)
    assert _affine(pt, R1) == want


# ---------------------------------------------------------------------------
# (c) verdicts: the JAX kernels and the host oracle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_verdicts():
    """One bucket of eight items and the JAX verify_batch verdicts of the
    two modes the JAX tests compile for secp256r1."""
    items = _prep_items(8)
    return items, {mode: np.asarray(jwc.verify_batch(R1, items, mode=mode))
                   for mode in ("plain", "windowed")}


@pytest.mark.parametrize("mode", ["plain", "windowed"])
def test_verdicts_match_jax_kernel(jax_verdicts, mode):
    items, want = jax_verdicts
    got = twc.verify_batch(R1, items, mode=mode, device="cpu")
    assert np.array_equal(got, want[mode])
    assert np.array_equal(got, _oracle(R1, items))
    assert got[:4].all() and not got[4:].any()


@pytest.mark.parametrize("mode", ["plain", "windowed", "halfgcd"])
def test_every_kind_matches_oracle(mode):
    """Every kind, crafted r + n items included (the windowed accept's rn_ok
    candidate; half-gcd host fallbacks)."""
    items = _prep_items(len(MODE_KINDS))
    want = _oracle(R1, items)
    assert list(want) == [k in ("valid", "key G", "key -G", "rn valid")
                          for k in MODE_KINDS]
    assert np.array_equal(twc.verify_batch(R1, items, mode=mode,
                                           device="cpu"), want)


def test_windowed_without_native_prep(monkeypatch):
    """Without libscalarmath the windowed mode takes the Python prep and
    gives the same verdicts."""
    items = _prep_items(8)
    monkeypatch.setitem(tsp._STATE, "lib", None)
    assert np.array_equal(twc.verify_batch(R1, items, mode="windowed",
                                           device="cpu"),
                          _oracle(R1, items))


def test_other_curves_take_the_windowed_branch():
    """verify_batch_async sends a curve without a dedicated kernel to the
    windowed mode, as the reference does; a curve the kernels do not know
    is refused with ValueError, on the words path too."""
    other = WeierstrassCurve("p256-copy", R1.p, R1.a, R1.b, R1.gx, R1.gy,
                             R1.n)
    assert twc._check_mode(other, "auto") == "windowed"
    items = _prep_items(2)
    with pytest.raises(ValueError, match="unknown curve"):
        twc.verify_batch_async(other, items, device="cpu")
    with pytest.raises(ValueError, match="word-form"):
        twc.verify_batch_async_words(other, *twc._items_to_words(items),
                                     device="cpu")


def test_mode_kernels_raise_build_error_without_a_compiler(monkeypatch,
                                                           tmp_path):
    """Where no compiler can build them, the B5/B8 wrappers raise
    BuildError — never the plain version's verdicts — and count no
    launch."""
    items = _prep_items(8)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    targets = ("weierstrass_shamir", "secp256k1_glv", "weierstrass_windowed")
    for name in targets:
        monkeypatch.setitem(_build._TARGETS[name], "compiler", lambda: None)
    loads = (twc.load_shamir_kernel, twc.load_glv_kernel,
             twc.load_windowed_kernel)
    before = (twc.verify_core.launches, twc.verify_core_glv.launches,
              twc.verify_core_windowed_single.launches)
    plain_args = [torch.from_numpy(a)
                  for a in twc.prepare_batch(R1, items)[:4]]
    win_args = ([torch.from_numpy(a) for a in
                 twc.prepare_batch_windowed_single(R1, items)[:6]]
                + list(twc.windowed_tables(R1, "cpu")))
    for load in loads:
        load.cache_clear()
    try:
        with pytest.raises(_build.BuildError, match="weierstrass_shamir"):
            twc.verify_core_cuda(*plain_args, R1.name)
        with pytest.raises(_build.BuildError, match="weierstrass_windowed"):
            twc.verify_core_windowed_single_cuda(*win_args, R1.name)
        with pytest.raises(_build.BuildError, match="secp256k1_glv"):
            twc.load_glv_kernel()
    finally:
        for load in loads:
            load.cache_clear()
    assert (twc.verify_core.launches, twc.verify_core_glv.launches,
            twc.verify_core_windowed_single.launches) == before
