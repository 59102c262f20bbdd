"""Deterministic canonical serialization — the wire, checkpoint and Merkle-leaf codec.

Replaces the reference's Kryo stack (core/.../serialization/Kryo.kt — which the
reference itself flags as a placeholder wire format). Design goals, in order:

1. **Deterministic**: one object graph → exactly one byte string (sorted maps/sets,
   canonical int widths, no object references/backrefs). Merkle leaf hashes are
   SHA-256 of these bytes (``serialized_hash`` — MerkleTransaction.kt:16-18 coupling),
   so determinism is consensus-critical.
2. **Whitelisted**: only registered types deserialize (CordaClassResolver.kt:1-225
   security model) — attacker-supplied bytes can never construct arbitrary objects.
3. **Versioned**: a one-byte format version leads every top-level message.
"""
from .codec import (
    serializable, serialize, deserialize, serialized_hash, to_wire, from_wire,
    SerializationError, register_type, registered_name,
)
from . import builtin_types as _builtin_types  # noqa: F401  (whitelist side effects)

__all__ = [
    "serializable", "serialize", "deserialize", "serialized_hash",
    "to_wire", "from_wire", "SerializationError", "register_type", "registered_name",
]
