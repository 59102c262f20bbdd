"""Signing and verification dispatch across schemes — the ``Crypto`` facade.

Reference parity: Crypto.kt doSign (:368-432), doVerify (:438-511), isValid (:518-544);
DigitalSignature.WithKey (DigitalSignature.kt:25); CryptoUtils.kt:49.

The hot path in production is NOT this module: batched verification runs on the GPU
via ``corda_tpu_torch.ops`` / the verifier service. This host path is the semantic
oracle, the signing path, and the route for schemes with no device kernel
(SPHINCS-256, RSA).
Dispatch is on ``scheme_number_id`` (an int), so keys built by any package that
shares the scheme numbers route the same way.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass

from . import ecmath
from .keys import PublicKey, PrivateKey, KeyPair, curve_for_scheme, sec1_decompress
from .schemes import (
    SignatureScheme, RSA_SHA256, ECDSA_SECP256K1_SHA256, ECDSA_SECP256R1_SHA256,
    EDDSA_ED25519_SHA512, SPHINCS256_SHA256,
)


class SignatureException(Exception):
    pass


@dataclass(frozen=True)
class DigitalSignature:
    """A raw signature (scheme-specific encoding: Ed25519 = 64-byte RFC 8032;
    ECDSA = DER (r,s); RSA = PKCS#1 block)."""

    bytes: bytes

    def __hash__(self):
        return hash(self.bytes)


@dataclass(frozen=True)
class DigitalSignatureWithKey(DigitalSignature):
    """A signature bundled with the verification key (DigitalSignature.WithKey)."""

    by: PublicKey

    def verify(self, content: bytes) -> bool:
        """Raise on invalid signature; return True on success (doVerify semantics)."""
        return Crypto.do_verify(self.by, self.bytes, content)

    def is_valid(self, content: bytes) -> bool:
        """Non-throwing validity check (isValid semantics)."""
        return Crypto.is_valid(self.by, self.bytes, content)

    def without_key(self) -> DigitalSignature:
        return DigitalSignature(self.bytes)

    def __hash__(self):
        return hash((self.bytes, self.by))


# Alias matching the transaction-layer naming.
TransactionSignature = DigitalSignatureWithKey


def _openssl_ecdsa_verify(scheme_id: int, encoded: bytes, content: bytes,
                          r: int, s: int):
    """OpenSSL-backed ECDSA curve-equation check, or None when the
    ``cryptography`` package is unavailable. Policy (ranges, low-s, curve
    membership, DER canonicalisation) is enforced by the CALLER; the (r, s)
    pair is re-encoded to canonical DER here so OpenSSL never sees the
    caller's encoding quirks."""
    try:
        key = _openssl_key(scheme_id, encoded)
    except Exception:
        return None
    if key is None:
        return None
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    try:
        key.verify(ecmath.ecdsa_sig_to_der(r, s), content,
                   ec.ECDSA(hashes.SHA256()))
        return True
    except InvalidSignature:
        return False


def _openssl_ed25519_verify(encoded: bytes, content: bytes, signature: bytes):
    """OpenSSL-backed Ed25519 equation check, or None when unavailable.
    Structural policy is enforced by the CALLER with our own decoder."""
    try:
        key = _openssl_ed_key(encoded)
    except Exception:
        return None
    if key is None:
        return None
    from cryptography.exceptions import InvalidSignature
    try:
        key.verify(signature, content)
        return True
    except InvalidSignature:
        return False


@functools.lru_cache(maxsize=65536)
def _openssl_ed_key(encoded: bytes):
    try:
        from cryptography.hazmat.primitives.asymmetric import ed25519
    except ImportError:
        return None
    return ed25519.Ed25519PublicKey.from_public_bytes(encoded)


@functools.lru_cache(maxsize=65536)
def _openssl_key(scheme_id: int, encoded: bytes):
    """Decode + cache an OpenSSL EC public key object per encoding (the
    point decompression is the expensive part and keys repeat heavily)."""
    try:
        from cryptography.hazmat.primitives.asymmetric import ec
    except ImportError:
        return None
    curve_obj = (ec.SECP256K1()
                 if scheme_id == ECDSA_SECP256K1_SHA256.scheme_number_id
                 else ec.SECP256R1())
    return ec.EllipticCurvePublicKey.from_encoded_point(curve_obj, encoded)


class Crypto:
    """Scheme dispatch (mirror of the reference ``Crypto`` object)."""

    @staticmethod
    def do_sign(private: PrivateKey, content: bytes,
                public: PublicKey | None = None) -> bytes:
        sid = private.scheme.scheme_number_id
        if sid == EDDSA_ED25519_SHA512.scheme_number_id:
            pub_bytes = public.encoded if public is not None else None
            return ecmath.ed25519_sign(private.encoded, content, public=pub_bytes)
        if sid in (ECDSA_SECP256K1_SHA256.scheme_number_id,
                   ECDSA_SECP256R1_SHA256.scheme_number_id):
            curve = curve_for_scheme(private.scheme)
            d = int.from_bytes(private.encoded, "big")
            r, s = ecmath.ecdsa_sign(curve, d, content)
            return ecmath.ecdsa_sig_to_der(r, s)
        if sid == RSA_SHA256.scheme_number_id:
            from cryptography.hazmat.primitives.asymmetric import padding
            from cryptography.hazmat.primitives import hashes, serialization
            key = serialization.load_der_private_key(private.encoded, password=None)
            return key.sign(content, padding.PKCS1v15(), hashes.SHA256())
        if sid == SPHINCS256_SHA256.scheme_number_id:
            from . import sphincs
            return sphincs.sign(private.encoded, content)
        raise SignatureException(f"Unsupported scheme for signing: {private.scheme}")

    @staticmethod
    def sign_with_key(keypair_or_private, content: bytes, public: PublicKey | None = None
                      ) -> DigitalSignatureWithKey:
        if isinstance(keypair_or_private, KeyPair):
            private, public = keypair_or_private.private, keypair_or_private.public
        else:
            private = keypair_or_private
            if public is None:
                raise ValueError("public key required when signing with a bare private key")
        return DigitalSignatureWithKey(Crypto.do_sign(private, content, public), public)

    @staticmethod
    def is_valid(public: PublicKey, signature: bytes, content: bytes) -> bool:
        sid = public.scheme.scheme_number_id
        if sid == EDDSA_ED25519_SHA512.scheme_number_id:
            # structural policy (canonical point decodes, s < L) decided by
            # OUR decoder — identical to the device kernel precheck; the
            # verification equation itself then rides OpenSSL when present
            # (RFC 8032 cofactorless, same equation as ecmath/kernels)
            if (len(signature) != 64
                    or ecmath.ed_point_decompress(public.encoded) is None
                    or ecmath.ed_point_decompress(signature[:32]) is None
                    or int.from_bytes(signature[32:], "little") >= ecmath.ED_L):
                return False
            fast = _openssl_ed25519_verify(public.encoded, content, signature)
            if fast is not None:
                return fast
            return ecmath.ed25519_verify(public.encoded, content, signature)
        if sid in (ECDSA_SECP256K1_SHA256.scheme_number_id,
                   ECDSA_SECP256R1_SHA256.scheme_number_id):
            curve = curve_for_scheme(public.scheme)
            point = sec1_decompress(curve, public.encoded)
            if point is None:
                return False
            try:
                r, s = ecmath.ecdsa_sig_from_der(signature)
            except (ValueError, IndexError):
                return False
            # The acceptance POLICY (ranges incl. low-s, on-curve key,
            # canonical DER) is decided above/by ecdsa_verify's prechecks —
            # identically to the device kernels' precheck. Once policy
            # passes, the curve-equation check itself is implementation-
            # independent, so the host path may ride OpenSSL (~100x the
            # pure-Python ladder; this is the batcher's sub-crossover /
            # p50@batch=1 path) with the pure ladder as fallback oracle.
            if not (1 <= r < curve.n and 1 <= s <= curve.n // 2):
                return False
            fast = _openssl_ecdsa_verify(public.scheme.scheme_number_id,
                                         public.encoded, content, r, s)
            if fast is not None:
                return fast
            return ecmath.ecdsa_verify(curve, point, content, r, s)
        if sid == RSA_SHA256.scheme_number_id:
            from cryptography.hazmat.primitives.asymmetric import padding
            from cryptography.hazmat.primitives import hashes, serialization
            from cryptography.exceptions import InvalidSignature
            key = serialization.load_der_public_key(public.encoded)
            try:
                key.verify(signature, content, padding.PKCS1v15(), hashes.SHA256())
                return True
            except InvalidSignature:
                return False
        if sid == SPHINCS256_SHA256.scheme_number_id:
            from . import sphincs
            return sphincs.verify(public.encoded, content, signature)
        raise SignatureException(f"Unsupported scheme for verification: {public.scheme}")

    @staticmethod
    def do_verify(public: PublicKey, signature: bytes, content: bytes) -> bool:
        """Throwing verify (doVerify semantics, Crypto.kt:438-511)."""
        if not content:
            raise SignatureException("Signing of an empty array is not permitted")
        if not Crypto.is_valid(public, signature, content):
            raise SignatureException(
                f"Signature by {public.to_string_short()} did not verify")
        return True


def sha256_digest(content: bytes) -> bytes:
    return hashlib.sha256(content).digest()
