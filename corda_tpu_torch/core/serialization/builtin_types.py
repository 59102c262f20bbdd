"""Whitelist registrations for the crypto-layer primitives.

(DefaultWhitelist.kt analog — the types every wire message may contain.)
"""
from __future__ import annotations

from . import codec
from ..crypto.secure_hash import SecureHash
from ..crypto.keys import PublicKey
from ..crypto.composite import CompositeKey
from ..crypto.schemes import scheme_by_id, COMPOSITE_KEY
from ..crypto.signatures import DigitalSignature, DigitalSignatureWithKey


def _pubkey_to_fields(key: PublicKey) -> list:
    return [key.scheme.scheme_number_id, key.encoded]


def _pubkey_from_fields(fields: list) -> PublicKey:
    sid, encoded = fields
    if sid == COMPOSITE_KEY.scheme_number_id:
        return CompositeKey.decode(encoded)
    return PublicKey(scheme_by_id(sid), encoded)


codec.register_type("SecureHash", SecureHash,
                    to_fields=lambda h: [h.bytes],
                    from_fields=lambda f: SecureHash(f[0]))
codec.register_type("PublicKey", PublicKey, _pubkey_to_fields, _pubkey_from_fields)
# CompositeKey shares the PublicKey wire shape (scheme id distinguishes them).
codec._BY_CLASS[CompositeKey] = "PublicKey"
codec.register_type("DigitalSignature", DigitalSignature,
                    to_fields=lambda s: [s.bytes],
                    from_fields=lambda f: DigitalSignature(f[0]))
codec.register_type("DigitalSignature.WithKey", DigitalSignatureWithKey,
                    to_fields=lambda s: [s.bytes, s.by],
                    from_fields=lambda f: DigitalSignatureWithKey(f[0], f[1]))
