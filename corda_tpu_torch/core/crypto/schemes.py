"""Pluggable signature schemes.

Reference parity: Crypto.kt:77-165 — five schemes (RSA_SHA256, ECDSA_SECP256K1_SHA256,
ECDSA_SECP256R1_SHA256, EDDSA_ED25519_SHA512 (default), SPHINCS256_SHA256) plus the
COMPOSITE pseudo-scheme. Scheme numbers match the reference so serialized scheme ids
line up across implementations.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SignatureScheme:
    scheme_number_id: int
    scheme_code_name: str
    algorithm_name: str
    key_size: int | None
    description: str

    def __str__(self) -> str:
        return self.scheme_code_name


RSA_SHA256 = SignatureScheme(1, "RSA_SHA256", "RSA", 3072, "RSA PKCS#1 v1.5 with SHA-256")
ECDSA_SECP256K1_SHA256 = SignatureScheme(2, "ECDSA_SECP256K1_SHA256", "ECDSA", 256, "ECDSA over secp256k1 with SHA-256")
ECDSA_SECP256R1_SHA256 = SignatureScheme(3, "ECDSA_SECP256R1_SHA256", "ECDSA", 256, "ECDSA over secp256r1 (NIST P-256) with SHA-256")
EDDSA_ED25519_SHA512 = SignatureScheme(4, "EDDSA_ED25519_SHA512", "EdDSA", 256, "Ed25519 (RFC 8032) with SHA-512")
SPHINCS256_SHA256 = SignatureScheme(5, "SPHINCS-256_SHA512_256", "SPHINCS256", 256, "SPHINCS-256 hash-based signature (post-quantum)")
COMPOSITE_KEY = SignatureScheme(6, "COMPOSITE", "COMPOSITE", None, "Weighted-threshold composite key of other schemes")

ALL_SCHEMES = (RSA_SHA256, ECDSA_SECP256K1_SHA256, ECDSA_SECP256R1_SHA256,
               EDDSA_ED25519_SHA512, SPHINCS256_SHA256, COMPOSITE_KEY)

#: Default scheme, as in the reference (Crypto.kt:170).
DEFAULT_SIGNATURE_SCHEME = EDDSA_ED25519_SHA512

_BY_ID = {s.scheme_number_id: s for s in ALL_SCHEMES}
_BY_NAME = {s.scheme_code_name: s for s in ALL_SCHEMES}


def scheme_by_id(num: int) -> SignatureScheme:
    try:
        return _BY_ID[num]
    except KeyError:
        raise ValueError(f"Unsupported signature scheme id {num}")


def scheme_by_name(name: str) -> SignatureScheme:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"Unsupported signature scheme {name!r}")
