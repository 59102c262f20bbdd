"""Base58 encoding (Bitcoin alphabet).

Reference parity: core/src/main/java/net/corda/core/crypto/Base58.java — used for
peer queue naming and key display.
"""
from __future__ import annotations

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(_ALPHABET)}


def b58encode(data: bytes) -> str:
    n_zeros = len(data) - len(data.lstrip(b"\x00"))
    num = int.from_bytes(data, "big")
    out = []
    while num > 0:
        num, rem = divmod(num, 58)
        out.append(_ALPHABET[rem])
    return "1" * n_zeros + "".join(reversed(out))


def b58decode(s: str) -> bytes:
    n_ones = len(s) - len(s.lstrip("1"))
    num = 0
    for c in s:
        try:
            num = num * 58 + _INDEX[c]
        except KeyError:
            raise ValueError(f"Invalid base58 character: {c!r}")
    body = num.to_bytes((num.bit_length() + 7) // 8, "big") if num else b""
    return b"\x00" * n_ones + body
