"""Differential tests of kernel B7 — the Ed25519 Shamir and windowed
ladders — against the JAX package (corda_tpu.ops.ed25519) and the host
oracle, on the CPU.

Inputs are made from a numpy seed. Every comparison is exact: prep arrays
byte for byte, tables word for word, verdicts as bools. The JAX kernels run
once each, at bucket 8 (the size tests/test_ops_curves.py compiles), in a
module fixture.
"""
import numpy as np
import pytest
import torch

from corda_tpu.core.crypto import ecmath
from corda_tpu.ops import ed25519 as jed
from corda_tpu.ops import scalarprep as jsp
from corda_tpu_torch.ops import ed25519 as ted
from corda_tpu_torch.ops import scalarprep as tsp

RNG = np.random.default_rng(2551907)

#: The adversarial kinds of an Ed25519 batch, in the order ``_items`` cycles
#: through them.
KINDS = ("valid", "s_bit", "msg_bit", "wrong_key", "s_ge_l", "r_sign",
         "r_y_ge_p", "bad_a", "bad_r", "short_sig", "valid_b")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tamper(kind, pub, sig, msg, other_pub):
    if kind == "s_bit":
        return pub, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:], msg
    if kind == "msg_bit":
        return pub, sig, msg[:-1] + bytes([msg[-1] ^ 1])
    if kind == "wrong_key":
        return other_pub, sig, msg
    if kind == "s_ge_l":
        s = int.from_bytes(sig[32:], "little") + ecmath.ED_L
        return pub, sig[:32] + s.to_bytes(32, "little"), msg
    if kind == "r_sign":
        return pub, sig[:31] + bytes([sig[31] ^ 0x80]) + sig[32:], msg
    if kind == "r_y_ge_p":
        return pub, (2**255 - 10).to_bytes(32, "little") + sig[32:], msg
    if kind == "bad_a":
        return b"\xff" * 32, sig, msg
    if kind == "bad_r":          # y = 2 is no curve point's y
        return pub, (2).to_bytes(32, "little") + sig[32:], msg
    if kind == "short_sig":
        return pub, sig[:63], msg
    return pub, sig, msg


def _items(n):
    """``n`` items cycling through KINDS, each signed by a fresh seeded key
    (``valid_b``: signed by a second key of the same batch)."""
    items, want = [], []
    seeds = [RNG.bytes(32) for _ in range(n)]
    pubs = [ecmath.ed25519_public_key(sd) for sd in seeds]
    for i in range(n):
        kind = KINDS[i % len(KINDS)]
        msg = RNG.bytes(24 + i % 40)
        sig = ecmath.ed25519_sign(seeds[i], msg)
        it = _tamper(kind, pubs[i], sig, msg, pubs[(i + 1) % n])
        items.append(it)
        want.append(kind in ("valid", "valid_b"))
    assert want == [ecmath.ed25519_verify(p, m, s) for p, s, m in items]
    return items, want


ITEMS8, WANT8 = _items(8)


@pytest.fixture(scope="module")
def jax_verdicts():
    """The JAX kernels' raw verdicts on ITEMS8, one call each."""
    s_bits, k_bits, neg_a, r_aff, _ = jed.prepare_batch(ITEMS8)
    shamir = np.asarray(jed._verify_kernel(s_bits, k_bits, neg_a, r_aff))
    *args, _ = jed.prepare_batch_windowed(ITEMS8)
    windowed = np.asarray(jed._verify_kernel_windowed(*args, w=16))
    return {"shamir": shamir, "windowed": windowed}


def _assert_same(got, want):
    """A port prep's arrays (tuples for points) equal the JAX prep's."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _assert_same(g, w)
            continue
        w = np.asarray(w)
        assert isinstance(g, np.ndarray)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_prepare_batch_byte_identical_to_jax():
    items, want = _items(22)
    got = ted.prepare_batch(items)
    _assert_same(got, jed.prepare_batch(items))
    assert list(got[-1]) == [k not in ("s_ge_l", "r_y_ge_p", "bad_a",
                                       "bad_r", "short_sig")
                             for k in (KINDS * 2)]


@pytest.mark.parametrize("w,native", [(16, True), (16, False), (8, False)])
def test_prepare_batch_windowed_byte_identical_to_jax(monkeypatch, w,
                                                      native):
    """Both routes of the windowed prep: native sm_ed_prep_plain at w = 16,
    the Python windows with the library switched off and at w = 8."""
    if native:
        assert tsp.available()
    else:
        monkeypatch.setattr(tsp, "available", lambda: False)
        monkeypatch.setattr(jsp, "available", lambda: False)
    items, _ = _items(22)
    got = ted.prepare_batch_windowed(items, w=w, device_tables=False)
    want = jed.prepare_batch_windowed(items, w=w, device_tables=False)
    _assert_same(got, want)
    assert got[1].shape == (256 // w, w // 2, 22)
    assert list(got[-1]) == [k not in ("s_ge_l", "r_y_ge_p", "bad_a",
                                       "short_sig") for k in (KINDS * 2)]


def test_windowed_prep_appends_the_cached_table():
    items, _ = _items(3)
    out = ted.prepare_batch_windowed(items, device="cpu")
    assert len(out) == 9
    for got, cached in zip(out[5:8], ted.windowed_table("cpu")):
        assert got is cached


def test_ed_prep_plain_binding_matches_jax():
    n = 40
    h = RNG.integers(0, 1 << 63, (n, 8), dtype=np.uint64) * 2 + 1
    s = RNG.integers(0, 1 << 63, (n, 4), dtype=np.uint64)
    s[:, 3] &= np.uint64((1 << 60) - 1)       # most below L ...
    s[::5, 3] = np.uint64(1 << 62)            # ... every fifth >= L
    got = tsp.ed_prep_plain(h, s)
    if jsp.available():
        want = jsp.ed_prep_plain(h, s)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    s_ints = [int.from_bytes(s[i].tobytes(), "little") for i in range(n)]
    assert list(got[2]) == [v < ecmath.ED_L for v in s_ints]
    k0 = int.from_bytes(h[1].tobytes(), "little") % ecmath.ED_L
    digits = [(k0 >> (2 * (127 - t))) & 3 for t in range(128)]
    assert list(got[1][:, 1]) == digits
    assert list(got[0][:, 1]) == [(s_ints[1] >> (16 * (15 - t))) & 0xFFFF
                                  for t in range(16)]


def test_plain_shamir_matches_the_jax_kernel(jax_verdicts):
    *wire, precheck = ted.prepare_batch(ITEMS8)
    ok = ted.verify_core(*ted.b7_to_device(wire, "cpu"))
    assert ok.dtype == torch.bool and ok.shape == (8,)
    assert np.array_equal(ok.numpy(), jax_verdicts["shamir"])
    assert list(ok.numpy() & precheck) == WANT8


def test_plain_windowed_matches_the_jax_kernel(jax_verdicts):
    *wire, precheck = ted.prepare_batch_windowed(ITEMS8, device_tables=False)
    ok = ted.verify_core_windowed(*ted.b7_to_device(wire, "cpu"),
                                  *ted.windowed_table("cpu"))
    assert np.array_equal(ok.numpy(), jax_verdicts["windowed"])
    assert list(ok.numpy() & precheck) == WANT8


def test_windowed_takes_the_reference_width(jax_verdicts):
    """verify_core_windowed takes the JAX function's ``w``
    (corda_tpu/parallel/sharded.py:121 passes ``w=B_WINDOW``) at B_WINDOW,
    with the JAX kernel's verdicts, and refuses another width."""
    *wire, _ = ted.prepare_batch_windowed(ITEMS8, device_tables=False)
    args = (*ted.b7_to_device(wire, "cpu"), *ted.windowed_table("cpu"))
    ok = ted.verify_core_windowed(*args, w=ted.B_WINDOW)
    assert np.array_equal(ok.numpy(), jax_verdicts["windowed"])
    with pytest.raises(ValueError, match="the port's kernels take"):
        ted.verify_core_windowed(*args, w=8)


@pytest.mark.parametrize("ladder", ["shamir", "windowed"])
def test_plain_ladders_match_the_oracle_on_a_wider_batch(ladder):
    items, want = _items(33)
    if ladder == "shamir":
        *wire, precheck = ted.prepare_batch(items)
        ok = ted.verify_core(*ted.b7_to_device(wire, "cpu"))
    else:
        *wire, precheck = ted.prepare_batch_windowed(items,
                                                     device_tables=False)
        ok = ted.verify_core_windowed(*ted.b7_to_device(wire, "cpu"),
                                      *ted.windowed_table("cpu"))
    assert list(ok.numpy() & precheck) == want
    assert want.count(True) == 6


def test_niels_table_loads_from_the_jax_arrays():
    """The windowed table installed from the JAX package's arrays is the
    port's own table, and the split kernel's low table is the same cached
    tensors (one copy per device for both kernels)."""
    tabs = ted.load_windowed_table_from_numpy(jed._b_window_table(16, 0),
                                              device="cpu")
    for t, own in zip(tabs, ted._b_window_table(16, 0)):
        assert t.dtype == torch.uint16 and np.array_equal(t.numpy(), own)
    assert all(a is b for a, b in zip(ted.windowed_table("cpu"), tabs))
    assert all(a is b for a, b in zip(ted.split_tables("cpu")[:3], tabs))
    with pytest.raises(ValueError):
        ted.load_windowed_table_from_numpy(tabs[:2], device="cpu")


def test_negate_and_select_match_jax():
    from corda_tpu.ops import field as JF
    from corda_tpu_torch.ops import field as TF
    P = ecmath.ED_P
    pts = [ecmath.ed_to_affine(ecmath.ed_scalar_mul(
        k, ecmath.ed_to_extended(ecmath.ED_B))) for k in (3, 5, 7, 11)]
    jp = jed._pack_point_ext(pts)
    tp = tuple(torch.from_numpy(np.asarray(c).astype(np.int64)) for c in jp)
    jn = jed.negate(tuple(np.asarray(c).astype(np.uint64) for c in jp))
    for j, t in zip(jn, ted.negate(tp)):
        assert [v % P for v in JF.from_limbs(np.asarray(j))] == \
            TF.from_limbs(TF.canon(t))
    idx = torch.tensor([3, 0, 2, 1])
    got = ted._select4(idx, *[tuple(c[k:k + 1].expand(4, 16) for c in tp)
                              for k in range(4)])
    for row, k in enumerate((3, 0, 2, 1)):
        assert all(torch.equal(g[row], c[k]) for g, c in zip(got, tp))


def test_b7_wrappers_never_fall_back_off_the_cpu():
    """The wrappers run the plain versions only for CPU tensors: other
    devices raise, and the CUDA builds raise where nvcc is absent instead of
    degrading."""
    from corda_tpu_torch import _build
    meta = torch.empty((256, 8), dtype=torch.uint8, device="meta")
    limbs = torch.empty((8, 16), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError):
        ted.verify_core(meta, meta, (limbs,) * 4, (limbs,) * 2)
    idx = torch.empty((16, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ted.verify_core_windowed(idx, meta, (limbs,) * 4, limbs, meta,
                                 limbs, limbs, limbs)
    if _build.nvcc_path() is None:
        for target in ("ed25519_shamir", "ed25519_windowed"):
            with pytest.raises(_build.BuildError):
                _build.build_all([target])
    assert (ted.verify_core.launches == 0
            and ted.verify_core_windowed.launches == 0
            or torch.cuda.is_available())
