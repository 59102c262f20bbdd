"""Helpers of corda_tpu/ops/weierstrass.py that the Ed25519 slice uses.

The secp256k1 / secp256r1 kernels themselves come with later slices of the
port; until then this module holds the shared pieces ``ed25519.py`` needs:
the 16-way point select, Montgomery batch inversion and the scalar-window
extraction used by the pure-Python prep fallback."""
from __future__ import annotations

import numpy as np
import torch


def select_tree(table, idx: torch.Tensor):
    """16-way batched point select over a 16-entry table of coordinate
    tuples: fold by index bit (LSB first) — a binary tree of 15 two-way
    selects per coordinate. ``idx``: (B,) integer tensor in [0, 16)."""
    level = list(table)
    for j in range(4):
        b = ((idx >> j) & 1).bool().unsqueeze(-1)
        level = [tuple(torch.where(b, hi_c, lo_c)
                       for lo_c, hi_c in zip(lo, hi))
                 for lo, hi in zip(level[0::2], level[1::2])]
    return level[0]


def _batch_modinv(values, n: int):
    """Montgomery's trick: invert many nonzero values mod prime n with ONE
    modpow + 3(B-1) modmuls."""
    if not values:
        return []
    prefix, acc = [], 1
    for v in values:
        acc = acc * v % n
        prefix.append(acc)
    inv = pow(acc, n - 2, n)
    out = [0] * len(values)
    for i in range(len(values) - 1, 0, -1):
        out[i] = inv * prefix[i - 1] % n
        inv = inv * values[i] % n
    out[0] = inv
    return out


def _bits_to_windows(bits: np.ndarray) -> np.ndarray:
    """(nbits, B) MSB-first bit array → (nbits/2, B) 2-bit digits, MSB-first
    (a leading zero bit is prepended when nbits is odd)."""
    if bits.shape[0] % 2:
        bits = np.concatenate(
            [np.zeros((1,) + bits.shape[1:], bits.dtype), bits])
    return bits[0::2] * 2 + bits[1::2]


def _bits_to_w_windows(bits: np.ndarray, w: int) -> np.ndarray:
    """(nbits, B) MSB-first bits → (nbits//w, B) w-bit digits, MSB-first."""
    n_w = bits.shape[0] // w
    grouped = bits[: n_w * w].reshape(n_w, w, *bits.shape[1:])
    weights = (1 << np.arange(w - 1, -1, -1, dtype=np.uint32))
    return np.tensordot(weights, grouped.astype(np.uint32), axes=([0], [1]))
