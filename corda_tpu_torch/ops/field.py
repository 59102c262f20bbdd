"""p25519 field arithmetic: host limb helpers and the plain PyTorch engine.

Port of corda_tpu/ops/field.py for the Ed25519 slice. Three parts:

- **Host helpers**, bit-identical copies of the JAX package's:
  ``to_limbs``/``from_limbs`` (16-bit little-endian limbs), ``bucket_size``
  (power-of-two batch padding) and ``scalars_to_bits`` (MSB-first bit planes).
- **The plain PyTorch engine** over p = 2^255 - 19: ``mul``, ``sqr``,
  ``add``, ``sub``, ``mul_const``, ``canon`` and ``inv25519`` on
  ``int64[..., 16]`` tensors of 16-bit limbs. It is the plain version that
  the CPU tests hold against the JAX engine and that ``chip_smoke.py`` holds
  the CUDA kernel against. Contract: every limb in [0, 2^17); the value is
  any residue below 2^257 (not reduced below p). Products of two limbs stay
  below 2^34 and a column of 16 of them below 2^38, so int64 lanes never
  overflow; ``canon`` is the only operation that reduces fully.
- ``device_table_cache``: per-device cache of the constant lookup tables the
  kernels take as arguments.

The CUDA device functions of the same engine (8 x 32-bit limbs) are in
``csrc/field25519.cuh``; only ``canon`` results must agree between the two
layouts.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

NLIMB = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

P25519 = 2**255 - 19
#: 2^256 mod p: a carry out of limb 15 re-enters limb 0 times 38.
FOLD25519 = 38


# ---------------------------------------------------------------------------
# Host <-> limb conversion (copies of the JAX package's helpers)
# ---------------------------------------------------------------------------

def to_limbs(x, n: int = NLIMB) -> np.ndarray:
    """Python int(s) → u64 limb array ((n,) or (B, n)), canonical limbs.

    The batch path packs each value to little-endian bytes and views them as
    u16 limbs in one numpy pass — one Python-level call per value instead of
    ``n`` bigint shift/mask pairs."""
    if isinstance(x, (int, np.integer)):
        return np.array([(int(x) >> (LIMB_BITS * i)) & MASK for i in range(n)],
                        dtype=np.uint64)
    nbytes = n * 2
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in x)
    return np.frombuffer(buf, dtype="<u2").reshape(
        len(x), n).astype(np.uint64)


def from_limbs(a):
    """Limb array (numpy or tensor, possibly relaxed) → Python int(s)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    arr = np.asarray(a).astype(np.uint64)
    if arr.ndim == 1:
        return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr))
    return [from_limbs(row) for row in arr]


def bucket_size(n: int, floor: int = 8) -> int:
    """Next power of two >= n (>= floor). Batch kernels pad to bucket sizes
    so the set of launched shapes stays small."""
    b = floor
    while b < n:
        b *= 2
    return b


def scalars_to_bits(xs, nbits: int = 256) -> np.ndarray:
    """Python ints → (nbits, B) u8 bit array, MSB first. ``nbits`` need not
    be byte-aligned: values are packed into the enclosing byte count and the
    excess high-order rows sliced off (every scalar must fit nbits)."""
    nbytes = (nbits + 7) // 8
    packed = np.frombuffer(
        b"".join(int(x).to_bytes(nbytes, "big") for x in xs),
        dtype=np.uint8).reshape(len(xs), nbytes)
    bits = np.unpackbits(packed, axis=1, bitorder="big")  # (B, 8*nbytes) MSB
    if nbits % 8:
        if bits[:, : 8 * nbytes - nbits].any():
            raise ValueError(f"scalar exceeds {nbits} bits")
    return np.ascontiguousarray(bits[:, -nbits:].T).astype(np.uint8)


# ---------------------------------------------------------------------------
# Plain PyTorch p25519 engine (int64 lanes, 16-bit limbs, limbs < 2^17)
# ---------------------------------------------------------------------------

def _offset_dominating(limb_bound: int, p: int = P25519) -> list[int]:
    """Limbs of a multiple of p whose every limb is >= ``limb_bound``:
    adding it before subtracting a contract element keeps every limb
    non-negative without changing the residue."""
    need = [limb_bound] * NLIMB
    s = sum(b << (LIMB_BITS * i) for i, b in enumerate(need))
    m = s // p + 1
    r = m * p - s                     # in (0, p]: fits 16 limbs
    digits = [need[i] + ((r >> (LIMB_BITS * i)) & MASK) for i in range(NLIMB)]
    assert sum(d << (LIMB_BITS * i) for i, d in enumerate(digits)) == m * p
    return digits


#: Subtraction offset: dominates every contract limb (< 2^17); its limbs
#: are < 2^17 + 2^16, so a + OFF - b stays below 2^19 per limb.
_SUB_OFFSET = _offset_dominating(1 << 17)
_P_LIMBS = [int(v) for v in to_limbs(P25519)]

_CONST_CACHE: dict = {}


def _const_tensor(vals, device) -> torch.Tensor:
    key = (tuple(vals), str(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = _CONST_CACHE[key] = torch.tensor(vals, dtype=torch.int64,
                                              device=device)
    return t


def const(v: int, device="cpu") -> torch.Tensor:
    """Canonical limbs of the field constant ``v`` as an int64 (16,) tensor."""
    return _const_tensor([int(x) for x in to_limbs(v % P25519)], device)


def _carry(v: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel carry passes over 16 non-negative limbs: every limb keeps
    its low 16 bits and hands the rest to the next limb; limb 15's carry
    (weight 2^256) re-enters limb 0 times 38."""
    for _ in range(passes):
        hi = v >> LIMB_BITS
        lo = v & MASK
        v = lo + torch.cat([hi[..., 15:] * FOLD25519, hi[..., :15]], dim=-1)
    return v


def _columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns: (..., 16) x (..., 16) → (..., 31) with
    col_k = sum_{i+j=k} a_i b_j. The (16, 16) outer product is skewed into
    anti-diagonals by laying rows out at width 32 and re-reading the flat
    buffer at width 31 (element (i, j) lands at row i, column i + j)."""
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)                 # (..., 16, 16)
    shape = prod.shape[:-2]
    prod = torch.nn.functional.pad(prod, (0, 16))             # (..., 16, 32)
    flat = prod.reshape(*shape, 512)[..., :496]
    return flat.reshape(*shape, 16, 31).sum(dim=-2)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b mod p. Columns < 2^38; folding columns 16..30 times 38 onto
    0..14 keeps them < 2^44; three carry passes bring every limb back
    under 2^17 (2^44 → < 2^34 → < 2^19 → < 2^17)."""
    cols = _columns(a, b)
    lo = cols[..., :16]
    hi = torch.nn.functional.pad(cols[..., 16:], (0, 1))     # (..., 16)
    return _carry(lo + FOLD25519 * hi, 3)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p: limbs < 2^18, one carry pass → < 2^17."""
    return _carry(a + b, 1)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p, borrow-free: a + OFF - b with OFF a multiple of p whose
    limbs dominate b's; limbs stay in [0, 2^19), one pass → < 2^17."""
    off = _const_tensor(_SUB_OFFSET, a.device)
    return _carry(a + off - b, 1)


def mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    """a·c mod p for a small constant c (0 <= c < 2^20)."""
    if not 0 <= c < (1 << 20):
        raise ValueError("mul_const takes 0 <= c < 2^20")
    return _carry(a * c, 2)


def _sweep(v: torch.Tensor):
    """Sequential exact carry: canonical 16-bit limbs plus the carry out."""
    out = []
    carry = torch.zeros_like(v[..., 0])
    for i in range(NLIMB):
        t = v[..., i] + carry
        out.append(t & MASK)
        carry = t >> LIMB_BITS
    return torch.stack(out, dim=-1), carry


def _cond_sub_p(v: torch.Tensor) -> torch.Tensor:
    """v - p where v >= p, else v, for canonical limbs."""
    out = []
    borrow = torch.zeros_like(v[..., 0])
    for i in range(NLIMB):
        t = v[..., i] - _P_LIMBS[i] - borrow
        out.append(t & MASK)
        borrow = (t >> LIMB_BITS) & 1
    d = torch.stack(out, dim=-1)
    return torch.where((borrow == 0).unsqueeze(-1), d, v)


def canon(a: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of the residue (value < p). The sweep leaves a carry
    of at most 2 (value < 2^257); folding it times 38 and sweeping again
    leaves at most 1, whose fold cannot carry again. The value is then
    < 2^256 = 2p + 38, so two conditional subtractions of p finish."""
    v, carry = _sweep(a)
    for _ in range(2):
        v = torch.cat([(v[..., :1] + FOLD25519 * carry.unsqueeze(-1)),
                       v[..., 1:]], dim=-1)
        v, carry = _sweep(v)
    return _cond_sub_p(_cond_sub_p(v))


def _sqr_n(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = sqr(a)
    return a


def inv25519(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) by the curve25519 addition chain (254 squarings + 11
    multiplies); inv25519(0) = 0, as in the JAX package."""
    z2 = sqr(a)
    z8 = _sqr_n(z2, 2)
    z9 = mul(z8, a)
    z11 = mul(z9, z2)
    z22 = sqr(z11)
    z_5_0 = mul(z22, z9)
    z_10_0 = mul(_sqr_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(_sqr_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(_sqr_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(_sqr_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(_sqr_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(_sqr_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(_sqr_n(z_200_0, 50), z_50_0)
    return mul(_sqr_n(z_250_0, 5), z11)


def one_like(a: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(a)
    out[..., 0] = 1
    return out


def limbs_tensor(arr, device="cpu") -> torch.Tensor:
    """Host limb array (u16 wire rows or u64 limbs) → int64 engine tensor."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(arr).astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# Per-device constant-table cache
# ---------------------------------------------------------------------------

_DEVICE_TABLE_CACHE: dict = {}
_DEVICE_TABLE_LOCK = threading.Lock()


def _to_device_tensors(arrs, device: torch.device) -> tuple:
    """Host arrays → contiguous tensors on ``device``. On CUDA the copying
    stream is synchronised: cached tables are later read from other
    streams (the batcher's), which must not race the upload."""
    out = tuple(a.to(device).contiguous() if isinstance(a, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrs)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return out


def device_table_cache(key, build, device) -> tuple:
    """Committed lookup tables per (key, device): ``build()`` runs once per
    key (host numpy arrays) and its arrays are copied to ``device`` once;
    repeat calls hand back the same tensors. Builds are serialized under a
    lock so the batcher's prep pool cannot race two multi-MB builds."""
    device = torch.device(device)
    full = (key, str(device))
    tabs = _DEVICE_TABLE_CACHE.get(full)
    if tabs is None:
        with _DEVICE_TABLE_LOCK:
            tabs = _DEVICE_TABLE_CACHE.get(full)
            if tabs is None:
                tabs = _DEVICE_TABLE_CACHE[full] = _to_device_tensors(
                    build(), device)
    return tabs


def install_device_tables(key, tabs, device) -> tuple:
    """Put already-built tables (numpy or tensors) into the cache for
    ``(key, device)``, replacing what was there."""
    device = torch.device(device)
    out = _to_device_tensors(tabs, device)
    with _DEVICE_TABLE_LOCK:
        _DEVICE_TABLE_CACHE[(key, str(device))] = out
    return out
