"""Plain Ed25519 (RFC 8032) and ECDSA (secp256k1, secp256r1; SEC 1, FIPS
186-4) signing and verification on Python integers.

This is the benchmark's yardstick: the input makers sign with it and the
reference judges the program's verdicts with it. It imports nothing but the
standard library, so it stays independent of the program under test.

Speed comes from tables, not from cleverness in the arithmetic:

- a fixed-base comb over the generator (32 windows of 8 bits, 255 affine
  points each) makes a signature 32 mixed additions;
- a per-key comb (64 windows of 4 bits, 15 affine points each) makes the
  variable-base half of a verification 64 mixed additions, once a key signs
  many items.

Verification semantics follow the program's documented ones: Ed25519 is
cofactorless, rejects s >= L and any A or R whose y is not below p, and
compares the encoding of [s]B - [k]A with R's bytes; ECDSA takes SHA-256 of
the message, requires 1 <= r, s < n and the low-s form s <= n / 2, a
compressed SEC 1 key on the curve, and x([u1]G + [u2]Q) = r mod n.
"""
from __future__ import annotations

import hashlib

# ---------------------------------------------------------------------------
# Ed25519
# ---------------------------------------------------------------------------

ED_P = 2 ** 255 - 19
ED_L = 2 ** 252 + 27742317777372353535851937790883648493
ED_D = -121665 * pow(121666, ED_P - 2, ED_P) % ED_P
ED_D2 = 2 * ED_D % ED_P
_SQRT_M1 = pow(2, (ED_P - 1) // 4, ED_P)
_ED_BY = 4 * pow(5, ED_P - 2, ED_P) % ED_P


def _ed_recover_x(y: int, sign: int) -> int | None:
    """x of the point with this y and x's low bit ``sign`` (RFC 8032
    5.1.3), or None where there is none."""
    if y >= ED_P:
        return None
    x2 = (y * y - 1) * pow(ED_D * y * y + 1, ED_P - 2, ED_P) % ED_P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (ED_P + 3) // 8, ED_P)
    if (x * x - x2) % ED_P:
        x = x * _SQRT_M1 % ED_P
    if (x * x - x2) % ED_P:
        return None
    if x & 1 != sign:
        x = ED_P - x
    return x


_ED_BX = _ed_recover_x(_ED_BY, 0)


def ed_decode(enc: bytes) -> tuple[int, int] | None:
    """Affine (x, y) of a 32-byte point encoding, None if it decodes to no
    point (y >= p included)."""
    if len(enc) != 32:
        return None
    v = int.from_bytes(enc, "little")
    y = v & ((1 << 255) - 1)
    x = _ed_recover_x(y, v >> 255)
    return None if x is None else (x, y)


def ed_encode_affine(x: int, y: int) -> bytes:
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _ed_niels(x: int, y: int) -> tuple[int, int, int]:
    """An affine point as (y + x, y - x, 2 d x y), the operand of a mixed
    addition."""
    return ((y + x) % ED_P, (y - x) % ED_P, ED_D2 * x * y % ED_P)


def _ed_madd(P, q):
    """Extended (X, Y, Z, T) plus an affine Niels point; complete on
    Ed25519 (the unified a = -1 formulas)."""
    X1, Y1, Z1, T1 = P
    ypx, ymx, xy2d = q
    p = ED_P
    a = (Y1 - X1) * ymx % p
    b = (Y1 + X1) * ypx % p
    c = T1 * xy2d % p
    d = 2 * Z1
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % p, g * h % p, f * g % p, e * h % p)


def _ed_add(P, Q):
    """Extended plus extended (complete)."""
    X1, Y1, Z1, T1 = P
    X2, Y2, Z2, T2 = Q
    p = ED_P
    a = (Y1 - X1) * (Y2 - X2) % p
    b = (Y1 + X1) * (Y2 + X2) % p
    c = T1 * ED_D2 % p * T2 % p
    d = 2 * Z1 * Z2 % p
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % p, g * h % p, f * g % p, e * h % p)


def _ed_affine(P) -> tuple[int, int]:
    X, Y, Z, _ = P
    zi = pow(Z, ED_P - 2, ED_P)
    return X * zi % ED_P, Y * zi % ED_P


def _batch_inverse(values: list[int], p: int) -> list[int]:
    """Every inverse mod p of nonzero ``values`` with one exponentiation."""
    prefix = [1] * (len(values) + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % p
    inv = pow(prefix[-1], p - 2, p)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = prefix[i] * inv % p
        inv = inv * values[i] % p
    return out


_ED_IDENTITY = (0, 1, 1, 0)


def _ed_comb(x: int, y: int, window_bits: int, windows: int) -> list:
    """Comb table of the affine point (x, y): row i holds j 2^(w i) P for
    j = 1 .. 2^w - 1, as Niels points."""
    p = ED_P
    base = (x, y, 1, x * y % p)
    rows_ext = []
    per = (1 << window_bits) - 1
    for _ in range(windows):
        row = [base]
        for _ in range(per - 1):
            row.append(_ed_add(row[-1], base))
        rows_ext.append(row)
        nxt = _ed_add(row[-1], base)      # 2^w times base
        base = nxt
    flat = [pt for row in rows_ext for pt in row]
    zinv = _batch_inverse([pt[2] for pt in flat], p)
    niels = [_ed_niels(pt[0] * zi % p, pt[1] * zi % p)
             for pt, zi in zip(flat, zinv)]
    return [niels[i * per:(i + 1) * per] for i in range(windows)]


def _ed_comb_mul(table, k: int, window_bits: int):
    acc = _ED_IDENTITY
    mask = (1 << window_bits) - 1
    for row in table:
        digit = k & mask
        k >>= window_bits
        if digit:
            acc = _ed_madd(acc, row[digit - 1])
    return acc


_ED_B_TABLE = None


def _ed_b_table():
    global _ED_B_TABLE
    if _ED_B_TABLE is None:
        _ED_B_TABLE = _ed_comb(_ED_BX, _ED_BY, 8, 32)
    return _ED_B_TABLE


def ed_base_mul(k: int):
    """[k]B in extended coordinates, k < 2^256."""
    return _ed_comb_mul(_ed_b_table(), k, 8)


def ed_public_key(seed: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return ed_encode_affine(*_ed_affine(ed_base_mul(a)))


def ed_sign(seed: bytes, msg: bytes, public: bytes | None = None) -> bytes:
    """RFC 8032 5.1.6 signature of ``msg`` by the key of ``seed``."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    pub = public if public is not None else ed_encode_affine(
        *_ed_affine(ed_base_mul(a)))
    r = int.from_bytes(hashlib.sha512(h[32:] + msg).digest(), "little") % ED_L
    R = ed_encode_affine(*_ed_affine(ed_base_mul(r)))
    k = int.from_bytes(hashlib.sha512(R + pub + msg).digest(),
                       "little") % ED_L
    s = (r + k * a) % ED_L
    return R + s.to_bytes(32, "little")


class EdKey:
    """A public key prepared for many verifications: its decoded point and
    a comb table of -A (None where the key decodes to no point)."""

    __slots__ = ("encoded", "table")

    def __init__(self, encoded: bytes):
        self.encoded = bytes(encoded)
        pt = ed_decode(self.encoded)
        self.table = (None if pt is None
                      else _ed_comb((-pt[0]) % ED_P, pt[1], 4, 64))

    def verify(self, sig: bytes, msg: bytes, check_s: bool = True) -> bool:
        """The verdict on ``sig`` over ``msg``. ``check_s=False`` drops the
        s < L rule: the broken guarantee of the benchmark's control."""
        if self.table is None or len(sig) != 64:
            return False
        s = int.from_bytes(sig[32:], "little")
        if check_s and s >= ED_L:
            return False
        R = sig[:32]
        k = int.from_bytes(hashlib.sha512(R + self.encoded + msg).digest(),
                           "little") % ED_L
        P = _ed_add(ed_base_mul(s % (1 << 256)),
                    _ed_comb_mul(self.table, k, 4))
        return ed_encode_affine(*_ed_affine(P)) == R


def ed_verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
    return EdKey(pub).verify(sig, msg)


# ---------------------------------------------------------------------------
# ECDSA over short Weierstrass curves
# ---------------------------------------------------------------------------

class Curve:
    """y^2 = x^3 + a x + b over F_p, generator G of prime order n."""

    def __init__(self, name, p, a, b, gx, gy, n):
        self.name, self.p, self.a, self.b, self.n = name, p, a, b, n
        self.g = (gx, gy)
        self._g_table = None

    def on_curve(self, pt) -> bool:
        x, y = pt
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    # Jacobian (X, Y, Z); None is the point at infinity
    def _double(self, P):
        if P is None:
            return None
        X1, Y1, Z1 = P
        p = self.p
        if Y1 == 0:
            return None
        yy = Y1 * Y1 % p
        s = 4 * X1 * yy % p
        zz = Z1 * Z1 % p
        m = (3 * X1 * X1 + self.a * zz * zz) % p
        x3 = (m * m - 2 * s) % p
        y3 = (m * (s - x3) - 8 * yy * yy) % p
        z3 = 2 * Y1 * Z1 % p
        return (x3, y3, z3)

    def _madd(self, P, q):
        """Jacobian plus affine (x2, y2), every case handled."""
        if P is None:
            return (q[0], q[1], 1)
        X1, Y1, Z1 = P
        x2, y2 = q
        p = self.p
        z1z1 = Z1 * Z1 % p
        u2 = x2 * z1z1 % p
        s2 = y2 * Z1 % p * z1z1 % p
        h = (u2 - X1) % p
        r = (s2 - Y1) % p
        if h == 0:
            return self._double(P) if r == 0 else None
        hh = h * h % p
        hhh = h * hh % p
        v = X1 * hh % p
        x3 = (r * r - hhh - 2 * v) % p
        y3 = (r * (v - x3) - Y1 * hhh) % p
        z3 = Z1 * h % p
        return (x3, y3, z3)

    def _add(self, P, Q):
        if Q is None:
            return P
        if P is None:
            return Q
        X2, Y2, Z2 = Q
        zi = pow(Z2, self.p - 2, self.p)
        zi2 = zi * zi % self.p
        return self._madd(P, (X2 * zi2 % self.p, Y2 * zi2 % self.p * zi
                              % self.p))

    def affine(self, P):
        if P is None:
            return None
        X, Y, Z = P
        zi = pow(Z, self.p - 2, self.p)
        zi2 = zi * zi % self.p
        return X * zi2 % self.p, Y * zi2 % self.p * zi % self.p

    def comb(self, pt, window_bits: int, windows: int) -> list:
        """Row i holds j 2^(w i) P for j = 1 .. 2^w - 1, affine."""
        p = self.p
        per = (1 << window_bits) - 1
        flat = []
        base = pt
        for _ in range(windows):
            row = [(base[0], base[1], 1)]
            for _ in range(per - 1):
                row.append(self._madd(row[-1], base))
            flat.extend(row)
            base = self.affine(self._madd(row[-1], base))
        zinv = _batch_inverse([P[2] for P in flat], p)
        aff = []
        for (X, Y, _), zi in zip(flat, zinv):
            zi2 = zi * zi % p
            aff.append((X * zi2 % p, Y * zi2 % p * zi % p))
        return [aff[i * per:(i + 1) * per] for i in range(windows)]

    def comb_mul(self, table, k: int, window_bits: int):
        acc = None
        mask = (1 << window_bits) - 1
        for row in table:
            digit = k & mask
            k >>= window_bits
            if digit:
                acc = self._madd(acc, row[digit - 1])
        return acc

    def base_mul(self, k: int):
        if self._g_table is None:
            self._g_table = self.comb(self.g, 8, 32)
        return self.comb_mul(self._g_table, k % self.n, 8)

    def compress(self, pt) -> bytes:
        x, y = pt
        return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")

    def decompress(self, enc: bytes):
        """The affine point of a compressed SEC 1 encoding, None if it
        names no point of the curve."""
        if len(enc) != 33 or enc[0] not in (2, 3):
            return None
        x = int.from_bytes(enc[1:], "big")
        p = self.p
        if x >= p:
            return None
        z = (x * x * x + self.a * x + self.b) % p
        y = pow(z, (p + 1) // 4, p)      # p = 3 mod 4 on both curves
        if y * y % p != z:
            return None
        if y & 1 != enc[0] & 1:
            y = p - y
        return (x, y)


SECP256K1 = Curve(
    "secp256k1", 2 ** 256 - 2 ** 32 - 977, 0, 7,
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141)

SECP256R1 = Curve(
    "secp256r1", 2 ** 256 - 2 ** 224 + 2 ** 192 + 2 ** 96 - 1,
    -3 % (2 ** 256 - 2 ** 224 + 2 ** 192 + 2 ** 96 - 1),
    0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551)


def ecdsa_public_key(curve: Curve, priv: int) -> bytes:
    return curve.compress(curve.affine(curve.base_mul(priv)))


def ecdsa_sign(curve: Curve, priv: int, msg: bytes, nonce: int) -> tuple:
    """(r, s) in low-s form, signing SHA-256 of ``msg`` with the nonce
    ``nonce`` (1 <= nonce < n; the caller draws it from its seed)."""
    n = curve.n
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big") % n
    while True:
        R = curve.affine(curve.base_mul(nonce))
        r = R[0] % n
        if r:
            s = pow(nonce, n - 2, n) * (e + r * priv) % n
            if s:
                return r, (s if s <= n // 2 else n - s)
        nonce = nonce * 0x9E3779B97F4A7C15 % n or 1


def der_encode(r: int, s: int) -> bytes:
    def integer(v: int) -> bytes:
        body = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
        if body[0] & 0x80:
            body = b"\x00" + body
        return b"\x02" + bytes([len(body)]) + body
    seq = integer(r) + integer(s)
    return b"\x30" + bytes([len(seq)]) + seq


def der_decode(sig: bytes) -> tuple[int, int] | None:
    """(r, s) of a DER signature, None if it is not one."""
    if len(sig) < 8 or sig[0] != 0x30 or sig[1] != len(sig) - 2:
        return None
    out, i = [], 2
    for _ in range(2):
        if i + 2 > len(sig) or sig[i] != 0x02:
            return None
        ln = sig[i + 1]
        body = sig[i + 2:i + 2 + ln]
        if ln == 0 or len(body) != ln or body[0] & 0x80:
            return None
        if ln > 1 and body[0] == 0 and not body[1] & 0x80:
            return None
        out.append(int.from_bytes(body, "big"))
        i += 2 + ln
    return None if i != len(sig) else (out[0], out[1])


class EcKey:
    """A compressed SEC 1 public key prepared for many verifications."""

    __slots__ = ("curve", "encoded", "table")

    def __init__(self, curve: Curve, encoded: bytes):
        self.curve = curve
        self.encoded = bytes(encoded)
        pt = curve.decompress(self.encoded)
        self.table = None if pt is None else curve.comb(pt, 4, 64)

    def verify(self, sig: bytes, msg: bytes, low_s: bool = True) -> bool:
        """The verdict on DER ``sig`` over ``msg``. ``low_s=False`` drops
        the low-s rule."""
        if self.table is None:
            return False
        rs = der_decode(sig)
        if rs is None:
            return False
        r, s = rs
        c = self.curve
        n = c.n
        if not (0 < r < n and 0 < s < n):
            return False
        if low_s and s > n // 2:
            return False
        e = int.from_bytes(hashlib.sha256(msg).digest(), "big") % n
        w = pow(s, n - 2, n)
        X = c._add(c.base_mul(e * w % n),
                   c.comb_mul(self.table, r * w % n, 4))
        if X is None:
            return False
        return c.affine(X)[0] % n == r


def ecdsa_verify(curve: Curve, pub: bytes, sig: bytes, msg: bytes) -> bool:
    return EcKey(curve, pub).verify(sig, msg)
