"""Pure-Python elliptic-curve arithmetic: the host reference implementation.

This module is the *authoritative host semantics* that the batched GPU kernels in
``corda_tpu_torch.ops`` are differentially tested against, and the signing path (signing is
host-side and low-volume; verification is the device-batched hot path — reference call
stack SURVEY.md §3.3, Crypto.kt:368-511).

Implemented from the public standards:
- Ed25519: RFC 8032 (EdDSA), curve edwards25519, SHA-512.
- ECDSA over secp256k1 / secp256r1: SEC 1 v2, deterministic nonces per RFC 6979.

No code is taken from the reference repo (which delegates to BouncyCastle/i2p-EdDSA).
"""
from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Ed25519 (RFC 8032)
# ---------------------------------------------------------------------------

ED_P = 2**255 - 19
ED_L = 2**252 + 27742317777372353535851937790883648493
ED_D = (-121665 * pow(121666, ED_P - 2, ED_P)) % ED_P
ED_D2 = (2 * ED_D) % ED_P
# Base point B: y = 4/5, x recovered with sign bit 0.
_ED_BY = (4 * pow(5, ED_P - 2, ED_P)) % ED_P


def _ed_recover_x(y: int, sign: int) -> int | None:
    if y >= ED_P:
        return None
    x2 = (y * y - 1) * pow(ED_D * y * y + 1, ED_P - 2, ED_P) % ED_P
    if x2 == 0:
        return None if sign else 0
    # p % 8 == 5: candidate root x = x2^((p+3)/8)
    x = pow(x2, (ED_P + 3) // 8, ED_P)
    if (x * x - x2) % ED_P != 0:
        x = x * pow(2, (ED_P - 1) // 4, ED_P) % ED_P
    if (x * x - x2) % ED_P != 0:
        return None
    if (x & 1) != sign:
        x = ED_P - x
    return x


_ED_BX = _ed_recover_x(_ED_BY, 0)
ED_B = (_ED_BX, _ED_BY)  # affine base point


def ed_point_add(P, Q):
    """Extended-coordinate unified addition (add-2008-hwcd-3, a=-1 curve)."""
    x1, y1, z1, t1 = P
    x2, y2, z2, t2 = Q
    a = (y1 - x1) * (y2 - x2) % ED_P
    b = (y1 + x1) * (y2 + x2) % ED_P
    c = t1 * ED_D2 * t2 % ED_P
    d = 2 * z1 * z2 % ED_P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % ED_P, g * h % ED_P, f * g % ED_P, e * h % ED_P)


def ed_point_double(P):
    """dbl-2008-hwcd."""
    x1, y1, z1, _ = P
    a = x1 * x1 % ED_P
    b = y1 * y1 % ED_P
    c = 2 * z1 * z1 % ED_P
    h = (a + b) % ED_P
    e = (h - (x1 + y1) * (x1 + y1)) % ED_P
    g = (a - b) % ED_P
    f = (c + g) % ED_P
    return (e * f % ED_P, g * h % ED_P, f * g % ED_P, e * h % ED_P)


ED_IDENTITY = (0, 1, 1, 0)


def ed_to_extended(aff):
    x, y = aff
    return (x, y, 1, x * y % ED_P)


def ed_scalar_mul(s: int, P) -> tuple:
    """Double-and-add over extended coords (host path; not constant-time — fine for
    verification and for test fixtures; signing uses it too, acceptable for a
    framework whose threat model matches the reference's dev/sim usage)."""
    Q = ED_IDENTITY
    Pe = P
    while s > 0:
        if s & 1:
            Q = ed_point_add(Q, Pe)
        Pe = ed_point_double(Pe)
        s >>= 1
    return Q


def ed_to_affine(P):
    x, y, z, _ = P
    zi = pow(z, ED_P - 2, ED_P)
    return (x * zi % ED_P, y * zi % ED_P)


def ed_point_compress(aff) -> bytes:
    x, y = aff
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def ed_point_decompress(data: bytes):
    if len(data) != 32:
        return None
    val = int.from_bytes(data, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    x = _ed_recover_x(y, sign)
    if x is None:
        return None
    return (x, y)


def _sha512_int(*chunks: bytes) -> int:
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "little")


def ed25519_secret_expand(seed: bytes):
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def ed25519_public_key(seed: bytes) -> bytes:
    a, _ = ed25519_secret_expand(seed)
    return ed_point_compress(ed_to_affine(ed_scalar_mul(a, ed_to_extended(ED_B))))


def ed25519_sign(seed: bytes, msg: bytes, public: bytes | None = None) -> bytes:
    a, prefix = ed25519_secret_expand(seed)
    A = public if public is not None else ed25519_public_key(seed)
    r = _sha512_int(prefix, msg) % ED_L
    R = ed_point_compress(ed_to_affine(ed_scalar_mul(r, ed_to_extended(ED_B))))
    k = _sha512_int(R, A, msg) % ED_L
    s = (r + k * a) % ED_L
    return R + s.to_bytes(32, "little")


def ed25519_verify(public: bytes, msg: bytes, sig: bytes) -> bool:
    if len(sig) != 64:
        return False
    A = ed_point_decompress(public)
    if A is None:
        return False
    R = ed_point_decompress(sig[:32])
    if R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= ED_L:
        return False
    k = _sha512_int(sig[:32], public, msg) % ED_L
    lhs = ed_scalar_mul(s, ed_to_extended(ED_B))
    rhs = ed_point_add(ed_to_extended(R), ed_scalar_mul(k, ed_to_extended(A)))
    # Projective comparison: x1 z2 == x2 z1 and y1 z2 == y2 z1.
    x1, y1, z1, _ = lhs
    x2, y2, z2, _ = rhs
    return (x1 * z2 - x2 * z1) % ED_P == 0 and (y1 * z2 - y2 * z1) % ED_P == 0


# ---------------------------------------------------------------------------
# Short Weierstrass curves (secp256k1, secp256r1) + ECDSA (SEC 1, RFC 6979)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WeierstrassCurve:
    name: str
    p: int
    a: int
    b: int
    gx: int
    gy: int
    n: int

    @property
    def g(self):
        return (self.gx, self.gy)

    def is_on_curve(self, P) -> bool:
        if P is None:
            return True
        x, y = P
        return (y * y - x * x * x - self.a * x - self.b) % self.p == 0

    # Affine group law (host oracle path: clarity over speed).
    def add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2 and (y1 + y2) % self.p == 0:
            return None
        if P == Q:
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, self.p - 2, self.p) % self.p
        else:
            lam = (y2 - y1) * pow(x2 - x1, self.p - 2, self.p) % self.p
        x3 = (lam * lam - x1 - x2) % self.p
        y3 = (lam * (x1 - x3) - y1) % self.p
        return (x3, y3)

    def mul(self, s: int, P):
        R = None
        while s > 0:
            if s & 1:
                R = self.add(R, P)
            P = self.add(P, P)
            s >>= 1
        return R


SECP256K1 = WeierstrassCurve(
    name="secp256k1",
    p=2**256 - 2**32 - 977,
    a=0,
    b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
)

SECP256R1 = WeierstrassCurve(
    name="secp256r1",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
)


def _bits2int(data: bytes, n: int) -> int:
    v = int.from_bytes(data, "big")
    blen = len(data) * 8
    nlen = n.bit_length()
    if blen > nlen:
        v >>= blen - nlen
    return v


def rfc6979_nonce(curve: WeierstrassCurve, priv: int, digest: bytes) -> int:
    """Deterministic ECDSA nonce (RFC 6979, HMAC-SHA256)."""
    qlen = (curve.n.bit_length() + 7) // 8
    h1 = _bits2int(digest, curve.n) % curve.n
    x_b = priv.to_bytes(qlen, "big")
    h_b = h1.to_bytes(qlen, "big")
    V = b"\x01" * 32
    K = b"\x00" * 32
    K = hmac.new(K, V + b"\x00" + x_b + h_b, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    K = hmac.new(K, V + b"\x01" + x_b + h_b, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    while True:
        t = b""
        while len(t) < qlen:
            V = hmac.new(K, V, hashlib.sha256).digest()
            t += V
        k = _bits2int(t[:qlen], curve.n)
        if 1 <= k < curve.n:
            return k
        K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()


def ecdsa_sign(curve: WeierstrassCurve, priv: int, msg: bytes) -> tuple[int, int]:
    """Sign SHA-256(msg); returns (r, s) with low-s normalisation."""
    digest = hashlib.sha256(msg).digest()
    e = _bits2int(digest, curve.n) % curve.n
    while True:
        k = rfc6979_nonce(curve, priv, digest)
        R = curve.mul(k, curve.g)
        r = R[0] % curve.n
        if r == 0:
            continue
        s = (e + r * priv) * pow(k, curve.n - 2, curve.n) % curve.n
        if s == 0:
            continue
        if s > curve.n // 2:
            s = curve.n - s
        return r, s


def ecdsa_verify(curve: WeierstrassCurve, pub, msg: bytes, r: int, s: int) -> bool:
    # Low-s only (matching the signer's normalisation): rejects the s' = n - s
    # malleated twin so each message/key pair has exactly one accepted signature.
    if not (1 <= r < curve.n and 1 <= s <= curve.n // 2):
        return False
    if pub is None or not curve.is_on_curve(pub):
        return False
    digest = hashlib.sha256(msg).digest()
    e = _bits2int(digest, curve.n) % curve.n
    w = pow(s, curve.n - 2, curve.n)
    u1 = e * w % curve.n
    u2 = r * w % curve.n
    X = curve.add(curve.mul(u1, curve.g), curve.mul(u2, pub))
    if X is None:
        return False
    return X[0] % curve.n == r


# -- DER encoding of ECDSA signatures (interop with the `cryptography` oracle) --

def _der_int(v: int) -> bytes:
    b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    if b[0] & 0x80:
        b = b"\x00" + b
    return b"\x02" + bytes([len(b)]) + b


def ecdsa_sig_to_der(r: int, s: int) -> bytes:
    body = _der_int(r) + _der_int(s)
    return b"\x30" + bytes([len(body)]) + body


def ecdsa_sig_from_der(data: bytes) -> tuple[int, int]:
    """Strict DER (r, s) parse: rejects truncated input, bad tags, and trailing
    garbage, so every (r, s) has exactly one accepted encoding (no malleability
    via re-encoding). Raises ValueError on any malformation."""
    if len(data) < 8 or data[0] != 0x30:
        raise ValueError("bad DER signature")
    if data[1] != len(data) - 2:
        raise ValueError("bad DER signature length")
    idx = 2

    def read_int(i):
        if i + 2 > len(data) or data[i] != 0x02:
            raise ValueError("bad DER integer")
        ln = data[i + 1]
        if ln == 0 or i + 2 + ln > len(data):
            raise ValueError("bad DER integer length")
        body = data[i + 2:i + 2 + ln]
        if body[0] & 0x80:
            raise ValueError("negative DER integer")
        if ln > 1 and body[0] == 0 and not (body[1] & 0x80):
            raise ValueError("non-minimal DER integer")
        return int.from_bytes(body, "big"), i + 2 + ln

    r, idx = read_int(idx)
    s, idx = read_int(idx)
    if idx != len(data):
        raise ValueError("trailing bytes after DER signature")
    return r, s


# ---------------------------------------------------------------------------
# GLV endomorphism for secp256k1 (verification speed: halves ladder length)
# ---------------------------------------------------------------------------
# secp256k1 has an efficient endomorphism phi(x, y) = (beta*x, y) = [lambda]P
# (j-invariant 0 curve). Scalars split as k = k1 + k2*lambda (mod n) with
# |k1|, |k2| < 2^128 via the standard lattice basis (GLV 2001; the constants
# are the well-known public secp256k1 values). Used by the device ECDSA kernel
# to run a 4-scalar 129-bit Shamir ladder instead of a 2-scalar 256-bit one.

SECP256K1_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
SECP256K1_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
_GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_GLV_B2 = _GLV_A1


def glv_decompose(k: int) -> tuple[int, int]:
    """k (mod n) -> (k1, k2), signed, |k1|,|k2| < 2^128, with
    k1 + k2*lambda == k (mod n)."""
    n = SECP256K1.n
    c1 = (_GLV_B2 * k + n // 2) // n
    c2 = (-_GLV_B1 * k + n // 2) // n
    k1 = k - c1 * _GLV_A1 - c2 * _GLV_A2
    k2 = -c1 * _GLV_B1 - c2 * _GLV_B2
    return k1, k2
