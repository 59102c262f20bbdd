"""Content hashes.

Reference parity: core/src/main/kotlin/net/corda/core/crypto/SecureHash.kt.
Notably the Merkle path uses a *single* SHA-256 for both leaf and node hashes
(SecureHash.kt:24,36 — ``sha256Twice`` exists but is unused by MerkleTree).
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class SecureHash:
    """An immutable 32-byte SHA-256 content hash."""

    bytes: bytes

    SIZE = 32

    def __post_init__(self):
        if len(self.bytes) != self.SIZE:
            raise ValueError(f"SecureHash must be {self.SIZE} bytes, got {len(self.bytes)}")

    # -- constructors -------------------------------------------------------
    @staticmethod
    def sha256(data: bytes) -> "SecureHash":
        return SecureHash(hashlib.sha256(data).digest())

    @staticmethod
    def sha256_twice(data: bytes) -> "SecureHash":
        return SecureHash.sha256(hashlib.sha256(data).digest())

    @staticmethod
    def parse(hex_str: str) -> "SecureHash":
        return SecureHash(bytes.fromhex(hex_str))

    @staticmethod
    def random_sha256() -> "SecureHash":
        return SecureHash.sha256(os.urandom(32))

    @staticmethod
    def zero_hash() -> "SecureHash":
        return SecureHash(b"\x00" * SecureHash.SIZE)

    @staticmethod
    def all_ones_hash() -> "SecureHash":
        return SecureHash(b"\xff" * SecureHash.SIZE)

    # -- combinators --------------------------------------------------------
    def hash_concat(self, other: "SecureHash") -> "SecureHash":
        """Merkle node combine: single SHA-256 of the 64-byte concatenation."""
        return SecureHash.sha256(self.bytes + other.bytes)

    def re_hash(self) -> "SecureHash":
        return SecureHash.sha256(self.bytes)

    # -- misc ---------------------------------------------------------------
    def hex(self) -> str:
        return self.bytes.hex()

    def prefix_chars(self, n: int = 6) -> str:
        return self.hex()[:n].upper()

    def __str__(self) -> str:
        return self.hex().upper()

    def __repr__(self) -> str:
        return f"SecureHash({self.hex()[:16]}…)"

    def __hash__(self) -> int:
        return int.from_bytes(self.bytes[:8], "big")


def sha256(data: bytes) -> SecureHash:
    return SecureHash.sha256(data)


def sha256_twice(data: bytes) -> SecureHash:
    return SecureHash.sha256_twice(data)


def hash_concat(left: SecureHash, right: SecureHash) -> SecureHash:
    return left.hash_concat(right)
