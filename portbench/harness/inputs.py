"""What every input maker shares: keys, signatures and tampering derived
from the seed.

Everything is derived from the seed by SHA-256, so the same seed gives the
same keys, messages and tampering on any machine, whatever the pool's
width. Signing is plain (``plaincrypto``). The input makers themselves are
the entries' (``entries/<entry>.py``): they run in chunks on a process pool.
"""
from __future__ import annotations

import functools
import hashlib

from . import plaincrypto as pc
from .yardsticks import tamper_ecdsa, tamper_ed25519

#: Corda's scheme names (Crypto.kt) and the plain curve of each ECDSA one.
ED25519 = "EDDSA_ED25519_SHA512"
SECP256K1 = "ECDSA_SECP256K1_SHA256"
SECP256R1 = "ECDSA_SECP256R1_SHA256"
EC_CURVES = {SECP256K1: pc.SECP256K1, SECP256R1: pc.SECP256R1}
SCHEMES = (ED25519, SECP256K1, SECP256R1)

#: Invalid variants a tampered signature takes in turn (``yardsticks``).
TAMPER_KINDS = 7


def digest(seed: int, *parts) -> bytes:
    """32 bytes derived from the seed and a label."""
    return hashlib.sha256(repr((int(seed),) + parts).encode()).digest()


@functools.lru_cache(maxsize=None)
def signer(seed: int, scheme: str, role: str, j: int):
    """(private part, public encoding) of signer ``j`` of ``role``."""
    if scheme == ED25519:
        sk = digest(seed, scheme, role, j)
        return sk, pc.ed_public_key(sk)
    curve = EC_CURVES[scheme]
    priv = int.from_bytes(digest(seed, scheme, role, j), "big") \
        % (curve.n - 1) + 1
    return priv, pc.ecdsa_public_key(curve, priv)


def _nonce(seed: int, scheme: str, label) -> int:
    n = EC_CURVES[scheme].n
    return int.from_bytes(digest(seed, "nonce", label), "big") % (n - 1) + 1


def sign(seed: int, scheme: str, priv, pub: bytes, msg: bytes, label):
    """A valid signature of ``msg``: 64 bytes (Ed25519) or DER (ECDSA)."""
    if scheme == ED25519:
        return pc.ed_sign(priv, msg, public=pub)
    nonce = _nonce(seed, scheme, label)
    return pc.der_encode(*pc.ecdsa_sign(EC_CURVES[scheme], priv, msg, nonce))


def bad_signature(seed, scheme, priv, pub, msg, kind, other_pub, label):
    """(signing key's encoding, signature) of tampered variant ``kind`` of
    the signature over ``msg`` (``yardsticks``' seven kinds a scheme; kinds
    0-5 keep a decodable key, 6 gives an undecodable one). A kind that
    changes the message signs the changed one and keeps ``msg``."""
    if scheme == ED25519:
        good = (pub, pc.ed_sign(priv, msg, public=pub), msg)
        p, s, m = tamper_ed25519(good, kind, other_pub, pc.ED_L)
        if m != msg:        # a signature over another message
            s = pc.ed_sign(priv, m, public=pub)
        return p, s
    curve = EC_CURVES[scheme]
    nonce = _nonce(seed, scheme, label)
    r, s = pc.ecdsa_sign(curve, priv, msg, nonce)
    p, m, r, s = tamper_ecdsa(curve.n, (pub, msg, r, s), kind, other_pub)
    if m != msg:
        r, s = pc.ecdsa_sign(curve, priv, m, nonce)
    return p, pc.der_encode(r, s)


def owner_scheme(config: dict, party: int) -> str:
    """The scheme of owner ``party``'s key: the configuration's owner
    schemes in turn, so that its parties split evenly over them."""
    schemes = config["owner_schemes"]
    return schemes[party % len(schemes)]


def check_config(config: dict) -> None:
    """Refuse a configuration that the input makers cannot build."""
    schemes = list(config["owner_schemes"]) + [config["notary_scheme"]]
    unknown = [s for s in schemes if s not in SCHEMES]
    if unknown:
        raise ValueError(f"configuration {config.get('name')}: no plain "
                         f"signer for {unknown}")
    parties = config["parties"]
    if parties < 1 or parties % len(config["owner_schemes"]):
        raise ValueError(f"configuration {config.get('name')}: {parties} "
                         "parties do not split evenly over "
                         f"{len(config['owner_schemes'])} owner schemes")
