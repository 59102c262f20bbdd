"""Field arithmetic: host limb helpers and the plain PyTorch engine.

Port of corda_tpu/ops/field.py. Three parts:

- **Host helpers**, bit-identical copies of the JAX package's:
  ``to_limbs``/``from_limbs`` (16-bit little-endian limbs), ``bucket_size``
  (power-of-two batch padding) and ``scalars_to_bits`` (MSB-first bit planes).
- **The plain PyTorch engine** over the three primes of the verifiers,
  p25519 = 2^255 - 19, PSECP (secp256k1) and PSECR1 (P-256): ``mul``,
  ``sqr``, ``add``, ``sub``, ``mul_const``, ``canon`` and ``is_zero`` take
  the prime as ``p`` (default p25519), plus ``inv25519``, on
  ``int64[..., 16]`` tensors of 16-bit limbs. It is the plain version that
  the CPU tests hold against the JAX engine and that ``chip_smoke.py`` holds
  the CUDA kernels against. Contract: every limb is signed with magnitude
  below 2^17; the value is any integer of that form congruent to the
  residue (not reduced). Products of two limbs stay below 2^34 and a column
  of 16 of them below 2^38, so int64 lanes never overflow; ``canon`` is the
  only operation that reduces fully, and only ``canon`` results have to
  agree with the JAX engine, whose relaxed limbs differ.
- ``device_table_cache``: per-device cache of the constant lookup tables the
  kernels take as arguments.

The CUDA device functions of the same engine (8 x 32-bit words) are in
``csrc/field25519.cuh``, ``csrc/field_k1.cuh`` and ``csrc/field_p256.cuh``.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

NLIMB = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

P25519 = 2**255 - 19
PSECP = 2**256 - 2**32 - 977
PSECR1 = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
#: 2^256 mod p25519: a carry out of limb 15 re-enters limb 0 times 38.
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
# Plain PyTorch engine (int64 lanes, 16-bit signed limbs, |limb| < 2^17)
# ---------------------------------------------------------------------------

#: 2^256 mod p for each prime, as signed coefficients on 16-bit limbs:
#: a carry out of limb 15 (weight 2^256) re-enters limb ``off`` times
#: ``coef``. p25519: 38; secp256k1: 2^32 + 977; P-256 (Solinas):
#: 2^224 - 2^192 - 2^96 + 1.
_FOLD_SPEC = {
    P25519: ((0, FOLD25519),),
    PSECP: ((0, 977), (2, 1)),
    PSECR1: ((0, 1), (6, -1), (12, -1), (14, 1)),
}
for _p, _spec in _FOLD_SPEC.items():
    assert sum(c << (LIMB_BITS * o) for o, c in _spec) == (1 << 256) % _p
#: Exclusive bound of every limb's magnitude between operations.
LIMB_BOUND = 1 << 17


def _fold_rows(p: int) -> list[list[int]]:
    """Row k: 2^(256 + 16k) mod p (k = 0..14, the high product columns) as
    small signed coefficients on limbs 0..15, found by re-applying the fold
    spec to the highest limb at or above 16 until none is left."""
    rows = []
    for k in range(NLIMB - 1):
        vec = [0] * (2 * NLIMB + 1)
        vec[NLIMB + k] = 1
        while any(vec[NLIMB:]):
            q = max(i for i in range(NLIMB, len(vec)) if vec[i])
            c, vec[q] = vec[q], 0
            for off, coef in _FOLD_SPEC[p]:
                vec[q - NLIMB + off] += c * coef
        rows.append(vec[:NLIMB])
        assert (sum(c << (LIMB_BITS * i) for i, c in enumerate(rows[-1]))
                - (1 << (256 + LIMB_BITS * k))) % p == 0
    return rows


_FOLD_ROWS = {p: _fold_rows(p) for p in _FOLD_SPEC}
#: Largest column of a product of two contract elements, and the bound of a
#: limb after the high columns are folded down.
_COL_BOUND = NLIMB * (LIMB_BOUND - 1) ** 2
_MUL_BOUND = {p: _COL_BOUND * (1 + max(sum(abs(r[j]) for r in rows)
                                       for j in range(NLIMB)))
              for p, rows in _FOLD_ROWS.items()}
assert max(_MUL_BOUND.values()) < (1 << 62)


@functools.lru_cache(maxsize=None)
def _passes(p: int, bound: int) -> int:
    """Carry passes that bring limbs of magnitude <= ``bound`` under the
    contract, from an exact walk of the bounds (a pass leaves
    lo in [0, 2^16) plus the carries it receives, each at most
    ceil(bound / 2^16) times its coefficient)."""
    b = [bound] * NLIMB
    for n in range(16):
        if max(b) < LIMB_BOUND:
            return n
        hi = [(x + MASK) >> LIMB_BITS for x in b]
        nb = [MASK + (hi[i - 1] if i else 0) for i in range(NLIMB)]
        for off, coef in _FOLD_SPEC[p]:
            nb[off] += abs(coef) * hi[NLIMB - 1]
        b = nb
    raise AssertionError("carry passes do not converge")


_CONST_CACHE: dict = {}


def _const_tensor(vals, device) -> torch.Tensor:
    key = (tuple(vals), str(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = _CONST_CACHE[key] = torch.tensor(vals, dtype=torch.int64,
                                              device=device)
    return t


def const(v: int, device="cpu", p: int = P25519) -> torch.Tensor:
    """Canonical limbs of the field constant ``v`` as an int64 (16,) tensor."""
    return _const_tensor([int(x) for x in to_limbs(v % p)], device)


def _fold_vec(p: int, device) -> torch.Tensor:
    vec = [0] * NLIMB
    for off, coef in _FOLD_SPEC[p]:
        vec[off] = coef
    return _const_tensor(vec, device)


def _carry(v: torch.Tensor, p: int, bound: int) -> torch.Tensor:
    """Parallel carry passes until every limb is back under the contract:
    each limb keeps its low 16 bits and hands the rest (an arithmetic
    shift, so negative limbs carry negatively) to the next limb; limb 15's
    carry re-enters through the fold spec."""
    if _passes(p, bound):
        fold = _fold_vec(p, v.device)
    for _ in range(_passes(p, bound)):
        hi = v >> LIMB_BITS
        v = ((v & MASK) + torch.nn.functional.pad(hi[..., :15], (1, 0))
             + hi[..., 15:] * fold)
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


def mul(a: torch.Tensor, b: torch.Tensor, p: int = P25519) -> torch.Tensor:
    """a·b mod p. Columns stay below 16·(2^17)^2 = 2^38 in magnitude; the 15
    high columns fold onto the low 16 through the rows of 2^(256+16k) mod p
    (``_FOLD_ROWS``), and carry passes bring the limbs back under 2^17."""
    cols = _columns(a, b)
    rows = _const_tensor(tuple(x for r in _FOLD_ROWS[p] for x in r),
                         a.device).view(NLIMB - 1, NLIMB)
    v = cols[..., :16] + (cols[..., 16:].unsqueeze(-1) * rows).sum(dim=-2)
    return _carry(v, p, _MUL_BOUND[p])


def sqr(a: torch.Tensor, p: int = P25519) -> torch.Tensor:
    return mul(a, a, p)


def add(a: torch.Tensor, b: torch.Tensor, p: int = P25519) -> torch.Tensor:
    """a + b mod p: limbs below 2^18 in magnitude, carried back."""
    return _carry(a + b, p, 2 * (LIMB_BOUND - 1))


def sub(a: torch.Tensor, b: torch.Tensor, p: int = P25519) -> torch.Tensor:
    """a - b mod p: limbs are signed, so no offset is needed."""
    return _carry(a - b, p, 2 * (LIMB_BOUND - 1))


def mul_const(a: torch.Tensor, c: int, p: int = P25519) -> torch.Tensor:
    """a·c mod p for a small constant c (0 <= c < 2^20)."""
    if not 0 <= c < (1 << 20):
        raise ValueError("mul_const takes 0 <= c < 2^20")
    return _carry(a * c, p, c * (LIMB_BOUND - 1))


def _sweep(v: torch.Tensor):
    """Sequential exact carry: canonical 16-bit limbs plus the (signed)
    carry out of limb 15."""
    out = []
    carry = torch.zeros_like(v[..., 0])
    for i in range(NLIMB):
        t = v[..., i] + carry
        out.append(t & MASK)
        carry = t >> LIMB_BITS
    return torch.stack(out, dim=-1), carry


def _cond_sub_p(v: torch.Tensor, p: int) -> torch.Tensor:
    """v - p where v >= p, else v, for canonical limbs."""
    out = []
    borrow = torch.zeros_like(v[..., 0])
    for i, pl in enumerate(int(x) for x in to_limbs(p)):
        t = v[..., i] - pl - borrow
        out.append(t & MASK)
        borrow = (t >> LIMB_BITS) & 1
    d = torch.stack(out, dim=-1)
    return torch.where((borrow == 0).unsqueeze(-1), d, v)


def canon(a: torch.Tensor, p: int = P25519) -> torch.Tensor:
    """Canonical limbs of the residue (value in [0, p)). A contract element
    is L + c·2^256 with L in [0, 2^256) after a sweep and c in [-3, 2];
    folding c·(2^256 mod p) back and sweeping leaves a carry in {-1, 0, 1},
    and the second fold leaves a value in [0, 2^256) (2^256 mod p < 2^225
    for all three primes); the third round is then a no-op kept as margin.
    2^256 < 2p + 38, so two conditional subtractions of p finish."""
    fold = _fold_vec(p, a.device)
    v, carry = _sweep(a)
    for _ in range(3):
        v, carry = _sweep(v + carry.unsqueeze(-1) * fold)
    return _cond_sub_p(_cond_sub_p(v, p), p)


def is_zero(a: torch.Tensor, p: int = P25519) -> torch.Tensor:
    """a ≡ 0 (mod p), per item (bool (...,))."""
    return (canon(a, p) == 0).all(dim=-1)


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
