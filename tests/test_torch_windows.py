"""The schedules of the B7 kernels in pure integers, on the CPU. B7 Shamir
(csrc/ed25519_shamir.cu): the 4-bit windows it reads from the wire's (256,
n) MSB-first bit planes rebuild s and k exactly; its constant {0..15}B
Niels rows are the host's; and its 64-window Straus ladder (window 0 from
the identity, then 4 doublings, one row of B and one of -A a window, the -A
rows by repeated addition) reaches [s]B + [k](-A) and gives the host
oracle's verdict on the known-answer rows. B7 windowed
(csrc/ed25519_windowed.cu): its base-16 digits of k, joined from the wire's
2-bit digits, rebuild k, and its 16 steps of 4 windows over the cached -A
rows and one Niels row of B reach [s]B + [k](-A) and, by re-encoding, the
host oracle's verdict. No JAX trace and no kernel run.
"""
import hashlib
import pathlib
import random
import re

import numpy as np
import pytest

from corda_tpu_torch.core.crypto import ecmath
from corda_tpu_torch.ops import ed25519 as ed
from corda_tpu_torch.ops import field as F
from corda_tpu_torch.ops import known_answers as ka

P = ecmath.ED_P
CSRC = pathlib.Path(ed.__file__).resolve().parent.parent / "csrc"


def _window_digits(bits: np.ndarray) -> np.ndarray:
    """(64, n) digits in base 16, most significant first, as the kernel's
    window_digit forms them: window w is planes 4w..4w+3 (low bit of each
    byte), the first plane the digit's high bit."""
    planes = (bits & 1).astype(np.int64).reshape(64, 4, -1)
    return (planes[:, 0] << 3) | (planes[:, 1] << 2) | (planes[:, 2] << 1) \
        | planes[:, 3]


def _from_digits(digits: np.ndarray) -> list[int]:
    out = []
    for col in digits.T:
        v = 0
        for d in col:
            v = 16 * v + int(d)
        out.append(v)
    return out


def test_window_recoding_rebuilds_the_scalars_from_the_bit_planes():
    """Edge scalars (0, 1, 15, 16, 2^252 - 1, 2^252, L - 1, every bit of
    a window set, the top plane set, 2^256 - 1) and random ones."""
    rng = random.Random(3)
    xs = [0, 1, 15, 16, 2**252 - 1, 2**252, ecmath.ED_L - 1, 0xF << 248,
          2**255, 2**256 - 1, 2**255 + 2**252 + 5] + [
        rng.randrange(2**256) for _ in range(40)]
    bits = F.scalars_to_bits(xs)
    assert bits[0, xs.index(2**255)] == 1
    assert _from_digits(_window_digits(bits)) == xs


def test_window_recoding_of_the_known_answer_prep():
    """The Shamir prep of the known-answer rows: s and k rebuilt from the
    wire's planes (0 for a row whose precheck failed)."""
    items = list(ka.ed25519_items())
    s_bits, k_bits, _, _, precheck = ed.prepare_batch(items)
    s_vals = _from_digits(_window_digits(s_bits))
    k_vals = _from_digits(_window_digits(k_bits))
    for i, (pub, sig, msg) in enumerate(items):
        if not precheck[i]:
            assert s_vals[i] == k_vals[i] == 0
            continue
        assert s_vals[i] == int.from_bytes(sig[32:], "little")
        h = hashlib.sha512(sig[:32] + pub + msg).digest()
        assert k_vals[i] == int.from_bytes(h, "little") % ecmath.ED_L
    assert not precheck.all() and precheck.any()


def _kernel_niels_rows() -> list[tuple[int, int, int]]:
    src = (CSRC / "ed25519_shamir.cu").read_text()
    body = re.search(r"ED_NIELS_B\[16 \* 24\] = \{(.*?)\};", src, re.S)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u",
                                            body.group(1))]
    assert len(words) == 16 * 24

    def fe(ws):
        return sum(w << (32 * i) for i, w in enumerate(ws))
    return [tuple(fe(words[24 * k + 8 * j: 24 * k + 8 * j + 8])
                  for j in range(3)) for k in range(16)]


def test_kernel_b_rows_are_the_multiples_of_the_base_point():
    for k, (yp, ym, td) in enumerate(_kernel_niels_rows()):
        if k == 0:
            x, y = 0, 1
        else:
            x, y = ecmath.ed_to_affine(ecmath.ed_scalar_mul(
                k, ecmath.ed_to_extended(ecmath.ED_B)))
        assert (yp, ym, td) == ((y + x) % P, (y - x) % P,
                                ecmath.ED_D2 * x * y % P)


def _madd_niels(acc, row):
    """The kernel's mixed addition of a Niels row (y + x, y - x, 2dxy)."""
    x1, y1, z1, t1 = acc
    yp, ym, td = row
    a, b, c, d = (y1 - x1) * ym, (y1 + x1) * yp, t1 * td, 2 * z1
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _to_cached(p):
    x, y, z, t = p
    return ((y - x) % P, (y + x) % P, z, ecmath.ED_D2 * t % P)


def _add_cached(acc, q):
    """The kernel's addition of a cached row (Y - X, Y + X, Z, 2dT)."""
    x1, y1, z1, t1 = acc
    ymx, ypx, z2, t2d = q
    a, b, c, d = (y1 - x1) * ymx, (y1 + x1) * ypx, t1 * t2d, 2 * z1 * z2
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def straus_model(s_bits, k_bits, neg_a, i):
    """Item ``i`` of the kernel's ladder in integers: X = [s]B + [k](-A)
    in extended coordinates."""
    b_rows = _kernel_niels_rows()
    a = tuple(F.from_limbs(c[i:i + 1].astype(np.int64))[0] for c in neg_a)
    a_rows = [(1, 1, 1, 0), _to_cached(a)]
    p = a
    for _ in range(14):
        p = _add_cached(p, a_rows[1])
        a_rows.append(_to_cached(p))
    sd = _window_digits(s_bits[:, i:i + 1])[:, 0]
    kd = _window_digits(k_bits[:, i:i + 1])[:, 0]
    acc = ecmath.ED_IDENTITY
    for w in range(64):
        if w:
            for _ in range(4):
                acc = ecmath.ed_point_double(acc)
        acc = _madd_niels(acc, b_rows[sd[w]])
        acc = _add_cached(acc, a_rows[kd[w]])
    return acc


@pytest.mark.parametrize("half", [0, 1])
def test_straus_model_reaches_sb_plus_k_neg_a_on_the_known_answer_rows(half):
    """On each known-answer row the model's point is [s]B + [k](-A) from
    the host's double-and-add, and X == Rx Z and Y == Ry Z (the kernel's
    accept) holds exactly where the host oracle accepts a row that passed
    the precheck."""
    items = list(ka.ed25519_items())
    s_bits, k_bits, neg_a, (rx, ry), precheck = ed.prepare_batch(items)
    s_vals = _from_digits(_window_digits(s_bits))
    k_vals = _from_digits(_window_digits(k_bits))
    base = ecmath.ed_to_extended(ecmath.ED_B)
    for i in range(half, len(items), 2):
        x, y, z, _ = straus_model(s_bits, k_bits, neg_a, i)
        a = tuple(F.from_limbs(c[i:i + 1].astype(np.int64))[0]
                  for c in neg_a)
        want = ecmath.ed_point_add(ecmath.ed_scalar_mul(s_vals[i], base),
                                   ecmath.ed_scalar_mul(k_vals[i], a))
        assert ecmath.ed_to_affine((x, y, z, 0)) == ecmath.ed_to_affine(want)
        r_x = F.from_limbs(rx[i:i + 1].astype(np.int64))[0]
        r_y = F.from_limbs(ry[i:i + 1].astype(np.int64))[0]
        accept = (x - r_x * z) % P == 0 and (y - r_y * z) % P == 0
        pub, sig, msg = items[i]
        assert (accept and bool(precheck[i])) == ecmath.ed25519_verify(
            pub, msg, sig)


def _joined_digits(a_digits: np.ndarray) -> np.ndarray:
    """(64, n) base-16 digits of k as the windowed kernel joins them
    (a_window_digit): 2-bit digits 2w and 2w + 1 of the wire's (16, 8, n),
    the first the high half."""
    flat = (a_digits.reshape(128, -1) & 3).astype(np.int64)
    return (flat[0::2] << 2) | flat[1::2]


def test_joined_digits_rebuild_k_from_the_windowed_prep():
    """The windowed prep of the known-answer rows: k rebuilt from the
    joined digits (0 for a row whose precheck failed), and s from b_idx's
    16-bit windows."""
    items = list(ka.ed25519_items())
    b_idx, a_digits, _, _, _, precheck = ed.prepare_batch_windowed(
        items, device_tables=False)
    assert a_digits.shape == (16, 8, len(items))
    k_vals = _from_digits(_joined_digits(a_digits))
    s_vals = [sum(int(w) << (16 * (15 - j)) for j, w in enumerate(col))
              for col in b_idx.T]
    for i, (pub, sig, msg) in enumerate(items):
        if not precheck[i]:
            assert s_vals[i] == k_vals[i] == 0
            continue
        assert s_vals[i] == int.from_bytes(sig[32:], "little")
        h = hashlib.sha512(sig[:32] + pub + msg).digest()
        assert k_vals[i] == int.from_bytes(h, "little") % ecmath.ED_L
    assert not precheck.all() and precheck.any()


def windowed_model(b_idx, a_digits, neg_a, i):
    """Item ``i`` of the windowed kernel's ladder in integers: 16 steps of
    4 windows (4 doublings, none in window 0, and the cached row [k_w](-A))
    and one Niels row [b_idx[step]]B; X = [s]B + [k](-A) extended."""
    a = tuple(F.from_limbs(c[i:i + 1].astype(np.int64))[0] for c in neg_a)
    a_rows = [(1, 1, 1, 0), _to_cached(a)]
    p = a
    for _ in range(14):
        p = _add_cached(p, a_rows[1])
        a_rows.append(_to_cached(p))
    kd = _joined_digits(a_digits[:, :, i:i + 1])[:, 0]
    base = ecmath.ed_to_extended(ecmath.ED_B)
    acc = ecmath.ED_IDENTITY
    for w in range(64):
        if w:
            for _ in range(4):
                acc = ecmath.ed_point_double(acc)
        acc = _add_cached(acc, a_rows[kd[w]])
        if w % 4 == 3:
            j = int(b_idx[w // 4, i])
            x, y = (ecmath.ed_to_affine(ecmath.ed_scalar_mul(j, base))
                    if j else (0, 1))
            acc = _madd_niels(acc, ((y + x) % P, (y - x) % P,
                                    ecmath.ED_D2 * x * y % P))
    return acc


@pytest.mark.parametrize("half", [0, 1])
def test_windowed_model_reaches_sb_plus_k_neg_a_on_the_known_answer_rows(
        half):
    """On each known-answer row the model's point is [s]B + [k](-A) from
    the host's double-and-add, and the kernel's accept (after one
    inversion, the canonical y equals the wire's and x's parity its sign
    bit) holds exactly where the host oracle accepts a row that passed the
    precheck."""
    items = list(ka.ed25519_items())
    b_idx, a_digits, neg_a, r_y, r_sign, precheck = \
        ed.prepare_batch_windowed(items, device_tables=False)
    k_vals = _from_digits(_joined_digits(a_digits))
    base = ecmath.ed_to_extended(ecmath.ED_B)
    for i in range(half, len(items), 2):
        x, y, z, _ = windowed_model(b_idx, a_digits, neg_a, i)
        a = tuple(F.from_limbs(c[i:i + 1].astype(np.int64))[0]
                  for c in neg_a)
        s = sum(int(w) << (16 * (15 - j)) for j, w in enumerate(b_idx[:, i]))
        want = ecmath.ed_point_add(ecmath.ed_scalar_mul(s, base),
                                   ecmath.ed_scalar_mul(k_vals[i], a))
        assert ecmath.ed_to_affine((x, y, z, 0)) == ecmath.ed_to_affine(want)
        zi = pow(z, P - 2, P)
        wire_y = F.from_limbs(r_y[i:i + 1].astype(np.int64))[0]
        accept = (y * zi % P == wire_y
                  and (x * zi % P) & 1 == int(r_sign[i]))
        pub, sig, msg = items[i]
        assert (accept and bool(precheck[i])) == ecmath.ed25519_verify(
            pub, msg, sig)
