"""Key material for the pluggable signature schemes.

Key encodings are raw, deterministic and scheme-specific (not ASN.1/X.509 — the
canonical codec in ``core.serialization`` frames them):

- Ed25519: 32-byte compressed point (RFC 8032) / 32-byte seed.
- ECDSA (both curves): 33-byte SEC1 compressed point / 32-byte big-endian scalar.
- RSA: DER SubjectPublicKeyInfo / PKCS#8 (delegated to the ``cryptography`` library).

Reference parity: Crypto.kt key generation + key classes; CryptoUtils.kt helpers
(``toStringShort`` = "DL" + base58(sha256(encoded))).
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from functools import total_ordering

from . import ecmath
from .base58 import b58encode
from .secure_hash import SecureHash
from .schemes import (
    SignatureScheme, RSA_SHA256, ECDSA_SECP256K1_SHA256, ECDSA_SECP256R1_SHA256,
    EDDSA_ED25519_SHA512, SPHINCS256_SHA256, DEFAULT_SIGNATURE_SCHEME,
)


@total_ordering
class PublicKey:
    """Base of all verification keys, including :class:`CompositeKey`.

    Equality/hash are over (scheme id, encoded bytes) so keys can be used as dict keys
    and set members everywhere the reference uses ``java.security.PublicKey``.
    """

    __slots__ = ("scheme", "encoded")

    def __init__(self, scheme: SignatureScheme, encoded: bytes):
        self.scheme = scheme
        self.encoded = bytes(encoded)

    # -- composite-key compatible surface (CryptoUtils.kt) -------------------
    @property
    def keys(self) -> frozenset["PublicKey"]:
        """The set of leaf keys: for a plain key, itself."""
        return frozenset((self,))

    def is_fulfilled_by(self, keys) -> bool:
        if isinstance(keys, PublicKey):
            keys = (keys,)
        return self in set(keys)

    def contains_any(self, other_keys) -> bool:
        return not self.keys.isdisjoint(set(other_keys))

    # -- identity ------------------------------------------------------------
    def to_string_short(self) -> str:
        return "DL" + b58encode(SecureHash.sha256(self.encoded).bytes)

    def __eq__(self, other):
        return (isinstance(other, PublicKey)
                and self.scheme.scheme_number_id == other.scheme.scheme_number_id
                and self.encoded == other.encoded)

    def __lt__(self, other):
        return (self.scheme.scheme_number_id, self.encoded) < (
            other.scheme.scheme_number_id, other.encoded)

    def __hash__(self):
        return hash((self.scheme.scheme_number_id, self.encoded))

    def __repr__(self):
        return f"PublicKey({self.scheme.scheme_code_name}, {self.to_string_short()[:14]}…)"


@dataclass(frozen=True)
class PrivateKey:
    scheme: SignatureScheme
    encoded: bytes = field(repr=False)

    def __hash__(self):
        return hash((self.scheme.scheme_number_id, self.encoded))


@dataclass(frozen=True)
class KeyPair:
    public: PublicKey
    private: PrivateKey


# ---------------------------------------------------------------------------
# SEC1 point encoding for the ECDSA curves
# ---------------------------------------------------------------------------

def sec1_compress(curve: ecmath.WeierstrassCurve, point) -> bytes:
    x, y = point
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


def sec1_decompress_cached(curve: ecmath.WeierstrassCurve, data: bytes):
    """sec1_decompress with the modular square root memoized per (curve,
    encoding). Decompression costs a 256-bit modpow; verification workloads
    see the same signer keys over and over (per-party keys across a ledger),
    so the batcher's host prep rides this cache."""
    return _decompress_lru(curve.name, data)


@functools.lru_cache(maxsize=65536)
def _decompress_lru(curve_name: str, data: bytes):
    curve = (ecmath.SECP256K1 if curve_name == "secp256k1"
             else ecmath.SECP256R1)
    return sec1_decompress(curve, data)


def sec1_pub_row_cached(curve: ecmath.WeierstrassCurve, data: bytes):
    """``sec1_decompress_cached`` in the native preps' wire format: the (8,)
    little-endian u64 row (x ‖ y, 32 LE bytes each) that sm_k1_prep /
    sm_r1_prep consume. Memoized per (curve, encoding) — the batcher's ECDSA
    prep copies one cached row per item instead of paying decompress plus
    two ``to_bytes`` round trips (the Weierstrass analog of the Ed25519
    kernel's per-signer A′ row cache). Returns None for invalid encodings."""
    return _pub_row_lru(curve.name, bytes(data))


@functools.lru_cache(maxsize=65536)
def _pub_row_lru(curve_name: str, data: bytes):
    import numpy as np
    pt = _decompress_lru(curve_name, data)
    if pt is None:
        return None
    # frombuffer over bytes is read-only — safe to share across batches
    return np.frombuffer(pt[0].to_bytes(32, "little")
                         + pt[1].to_bytes(32, "little"), dtype="<u8")


def sec1_decompress(curve: ecmath.WeierstrassCurve, data: bytes):
    if len(data) == 65 and data[0] == 4:
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
        return (x, y) if curve.is_on_curve((x, y)) else None
    if len(data) != 33 or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= curve.p:
        return None
    y2 = (pow(x, 3, curve.p) + curve.a * x + curve.b) % curve.p
    y = pow(y2, (curve.p + 1) // 4, curve.p)  # p ≡ 3 (mod 4) for both curves
    if y * y % curve.p != y2:
        return None
    if (y & 1) != (data[0] & 1):
        y = curve.p - y
    return (x, y)


_ECDSA_CURVES = {
    ECDSA_SECP256K1_SHA256.scheme_number_id: ecmath.SECP256K1,
    ECDSA_SECP256R1_SHA256.scheme_number_id: ecmath.SECP256R1,
}


def curve_for_scheme(scheme: SignatureScheme) -> ecmath.WeierstrassCurve:
    return _ECDSA_CURVES[scheme.scheme_number_id]


# ---------------------------------------------------------------------------
# Key generation
# ---------------------------------------------------------------------------

def generate_keypair(scheme: SignatureScheme = DEFAULT_SIGNATURE_SCHEME,
                     entropy: bytes | None = None) -> KeyPair:
    """Generate a key pair. ``entropy`` (32 bytes) makes generation deterministic —
    used by tests and by the deterministic ledger generator (GeneratedLedger parity).
    """
    sid = scheme.scheme_number_id
    if sid == EDDSA_ED25519_SHA512.scheme_number_id:
        seed = entropy if entropy is not None else os.urandom(32)
        pub = ecmath.ed25519_public_key(seed)
        return KeyPair(PublicKey(scheme, pub), PrivateKey(scheme, seed))
    if sid in _ECDSA_CURVES:
        curve = _ECDSA_CURVES[sid]
        raw = entropy if entropy is not None else os.urandom(32)
        d = (int.from_bytes(raw, "big") % (curve.n - 1)) + 1
        pub_pt = curve.mul(d, curve.g)
        return KeyPair(
            PublicKey(scheme, sec1_compress(curve, pub_pt)),
            PrivateKey(scheme, d.to_bytes(32, "big")),
        )
    if sid == SPHINCS256_SHA256.scheme_number_id:
        from . import sphincs
        entropy = entropy if entropy is not None else os.urandom(32)
        pub, priv = sphincs.keygen(entropy)
        return KeyPair(PublicKey(scheme, pub), PrivateKey(scheme, priv))
    if sid == RSA_SHA256.scheme_number_id:
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.hazmat.primitives import serialization
        if entropy is not None:
            raise ValueError("deterministic RSA key generation is not supported")
        key = rsa.generate_private_key(public_exponent=65537, key_size=3072)
        pub = key.public_key().public_bytes(
            serialization.Encoding.DER, serialization.PublicFormat.SubjectPublicKeyInfo)
        priv = key.private_bytes(
            serialization.Encoding.DER, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())
        return KeyPair(PublicKey(scheme, pub), PrivateKey(scheme, priv))
    raise ValueError(f"Key generation not supported for scheme {scheme}")
