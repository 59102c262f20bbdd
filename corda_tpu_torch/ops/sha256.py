"""Batched SHA-256 and Merkle levels (kernel B6) and the host packing helpers.

Port of corda_tpu/ops/sha256.py. Same functions, same shapes, bit-exact
against hashlib and the host ``MerkleTree``:

- ``sha256_blocks``: hash B pre-padded messages of a common block count.
- ``hash_pairs``: one Merkle level — SHA-256 of 64-byte (left‖right) pairs.
- ``merkle_root``: the tree over a power-of-two leaf batch.

Words are 32-bit big-endian message words as native values. The device
functions take torch tensors of ``int32`` (or ``uint32``, viewed as int32)
holding those bits, or numpy ``uint32`` arrays (which become CPU tensors),
and return int32 tensors of the same bits on the input's device. A CPU
tensor runs the plain PyTorch version (int64 lanes masked to 32 bits:
torch has no uint32 shifts on the CPU); a CUDA tensor launches the
hand-written kernel of ``csrc/sha256.cu`` or raises — it never falls back.
``hash_pairs.launches``, ``merkle_root.launches`` (one per level kernel)
and ``sha256_blocks.launches`` count the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from .. import _build
from . import _cuda as cu

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.uint32)

_IV = np.array([0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19], dtype=np.uint32)

# Constant second block for 64-byte messages: 0x80 marker then length 512 bits.
_PAD_BLOCK_64B = np.zeros(16, dtype=np.uint32)
_PAD_BLOCK_64B[0] = 0x80000000
_PAD_BLOCK_64B[15] = 512

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Word tensors
# ---------------------------------------------------------------------------

def as_words(x) -> torch.Tensor:
    """``x`` as an int32 tensor of the same 32-bit words: numpy arrays are
    converted to uint32 and become CPU tensors; torch uint32 tensors are
    viewed as int32."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return x.view(torch.int32)
        if x.dtype != torch.int32:
            raise TypeError(f"expected int32 or uint32 words, got {x.dtype}")
        return x
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32))


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """An int32 word tensor (any device) as a numpy uint32 array."""
    return t.detach().cpu().numpy().view(np.uint32)


def _to_lanes(t: torch.Tensor) -> torch.Tensor:
    """int32 words → int64 lanes holding the unsigned values."""
    return t.to(torch.int64) & _M32


def _from_lanes(t: torch.Tensor) -> torch.Tensor:
    """int64 lanes in [0, 2^32) → int32 words of the same bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (int64 lanes masked to 32 bits)
# ---------------------------------------------------------------------------

def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress_plain(state: list, w: list) -> list:
    """One compression: ``state`` 8 and ``w`` 16 int64 lane tensors (or
    ints) → the 8 new state words. ``w`` is the rolling schedule window and
    is overwritten."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t >= 16:
            w15, w2 = w[(t + 1) % 16], w[(t + 14) % 16]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            w[t % 16] = (w[t % 16] + s0 + w[(t + 9) % 16] + s1) & _M32
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = h + s1 + ch + int(_K[t]) + w[t % 16]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & _M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & _M32
    return [(x + y) & _M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _iv_lanes(like: torch.Tensor) -> list:
    return [torch.full_like(like, int(v)) for v in _IV]


def sha256_blocks_plain(blocks: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sha256_blocks` on int32 words."""
    lanes = _to_lanes(blocks)
    if lanes.shape[-2] == 0:
        out = torch.from_numpy(_IV.view(np.int32).copy()).to(blocks.device)
        return out.expand(*blocks.shape[:-2], 8).contiguous()
    state = _iv_lanes(lanes[..., 0, 0])
    for k in range(lanes.shape[-2]):
        state = _compress_plain(state, [lanes[..., k, i] for i in range(16)])
    return _from_lanes(torch.stack(state, dim=-1))


def hash_pairs_plain(pairs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`hash_pairs` on int32 words."""
    lanes = _to_lanes(pairs)
    state = _compress_plain(_iv_lanes(lanes[..., 0]),
                            [lanes[..., i] for i in range(16)])
    state = _compress_plain(state, [int(v) for v in _PAD_BLOCK_64B])
    return _from_lanes(torch.stack(state, dim=-1))


def merkle_root_plain(leaves: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`merkle_root` on int32 words (power-of-two
    leaf count > 1)."""
    buf = leaves
    while buf.shape[-2] > 1:
        half = buf.shape[-2] // 2
        buf = hash_pairs_plain(buf.reshape(*buf.shape[:-2], half, 16))
    return buf[..., 0, :]


# ---------------------------------------------------------------------------
# CUDA wrappers (csrc/sha256.cu)
# ---------------------------------------------------------------------------

_LAUNCH_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def load_kernel():
    """The B6 library, built from ``csrc/`` at first use. Raises
    :class:`_build.BuildError` when it cannot be built."""
    lib = _build.load("sha256")
    lib.sha256_hash_pairs.restype = ctypes.c_int
    lib.sha256_hash_pairs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_void_p]
    lib.sha256_blocks.restype = ctypes.c_int
    lib.sha256_blocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_void_p]
    cu.bind_error_string(lib, "sha256")
    return lib


def _check_cuda_words(t: torch.Tensor, last: int, name: str) -> None:
    if t.dtype != torch.int32 or t.dim() < 1 or t.shape[-1] != last:
        raise ValueError(f"{name}: expected int32 (..., {last}), got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch_pairs(lib, pairs: torch.Tensor) -> torch.Tensor:
    """One hash_pairs_kernel launch on the current stream (not counted)."""
    n = pairs.numel() // 16
    out = torch.empty(*pairs.shape[:-1], 8, dtype=torch.int32,
                      device=pairs.device)
    with torch.cuda.device(pairs.device):
        stream = torch.cuda.current_stream(pairs.device).cuda_stream
        rc = lib.sha256_hash_pairs(pairs.data_ptr(), out.data_ptr(), n,
                                   stream)
    cu.raise_on_error(lib, "sha256", rc, "sha256 hash_pairs")
    return out


def hash_pairs_cuda(pairs: torch.Tensor) -> torch.Tensor:
    """Launch hash_pairs_kernel on the current stream of ``pairs``' device
    without synchronising."""
    _check_cuda_words(pairs, 16, "pairs")
    out = _launch_pairs(load_kernel(), pairs)
    with _LAUNCH_LOCK:
        hash_pairs.launches += 1
    return out


def merkle_root_cuda(leaves: torch.Tensor) -> torch.Tensor:
    """One hash_pairs_kernel launch per level on shrinking buffers, all on
    the current stream without a synchronise."""
    _check_cuda_words(leaves, 8, "leaves")
    lib = load_kernel()
    buf = leaves
    while buf.shape[-2] > 1:
        half = buf.shape[-2] // 2
        buf = _launch_pairs(lib, buf.view(*buf.shape[:-2], half, 16))
        with _LAUNCH_LOCK:
            merkle_root.launches += 1
    return buf[..., 0, :]


def sha256_blocks_cuda(blocks: torch.Tensor) -> torch.Tensor:
    """Launch sha256_blocks_kernel on the current stream of ``blocks``'
    device without synchronising."""
    _check_cuda_words(blocks, 16, "blocks")
    if blocks.dim() < 2:
        raise ValueError("blocks: expected (..., n_blocks, 16)")
    lib = load_kernel()
    n_blocks = blocks.shape[-2]
    out = torch.empty(*blocks.shape[:-2], 8, dtype=torch.int32,
                      device=blocks.device)
    n = out.numel() // 8
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        rc = lib.sha256_blocks(blocks.data_ptr(), out.data_ptr(), n,
                               n_blocks, stream)
    cu.raise_on_error(lib, "sha256", rc, "sha256_blocks")
    with _LAUNCH_LOCK:
        sha256_blocks.launches += 1
    return out


# ---------------------------------------------------------------------------
# Entry points: dispatch by the tensor's device
# ---------------------------------------------------------------------------

def _dispatch(t: torch.Tensor, plain, cuda):
    if t.device.type == "cpu":
        return plain(t)
    if t.device.type == "cuda":
        return cuda(t.contiguous())
    raise ValueError(f"unsupported device {t.device}")


def sha256_blocks(blocks) -> torch.Tensor:
    """Hash a batch of pre-padded messages: ``blocks`` (..., n_blocks, 16)
    big-endian words → digests (..., 8) int32 words."""
    return _dispatch(as_words(blocks), sha256_blocks_plain,
                     sha256_blocks_cuda)


def hash_pairs(pairs) -> torch.Tensor:
    """One Merkle level: ``pairs`` (..., 16) = left‖right digests (64
    bytes) → SHA-256 digests (..., 8). Single-SHA-256 node combine
    (SecureHash.kt:36)."""
    return _dispatch(as_words(pairs), hash_pairs_plain, hash_pairs_cuda)


def merkle_root(leaves) -> torch.Tensor:
    """Merkle root over (..., N, 8) leaf digests, N a power of two (callers
    zero-pad per MerkleTree.kt:27-41). Returns (..., 8)."""
    leaves = as_words(leaves)
    n = leaves.shape[-2]
    if n & (n - 1):
        raise ValueError("merkle_root requires a power-of-two leaf count "
                         "(zero-pad)")
    if n == 1:
        return leaves[..., 0, :]
    return _dispatch(leaves, merkle_root_plain, merkle_root_cuda)


#: Kernel launches through each wrapper (the CPU path launches nothing).
sha256_blocks.launches = 0
hash_pairs.launches = 0
merkle_root.launches = 0


# ---------------------------------------------------------------------------
# Host-side packing helpers (byte-identical to the JAX package's)
# ---------------------------------------------------------------------------

def pad_message(data: bytes, n_blocks: int | None = None) -> np.ndarray:
    """SHA-256 padding → (n_blocks, 16) u32 big-endian words."""
    bit_len = len(data) * 8
    padded = data + b"\x80"
    while len(padded) % 64 != 56:
        padded += b"\x00"
    padded += bit_len.to_bytes(8, "big")
    arr = np.frombuffer(padded, dtype=">u4").astype(np.uint32).reshape(-1, 16)
    if n_blocks is not None:
        if arr.shape[0] > n_blocks:
            raise ValueError("message longer than n_blocks")
        if arr.shape[0] < n_blocks:
            raise ValueError("pad_message produces exact block count; bucket "
                             "messages by size before batching")
    return arr


def pack_batch(messages: list[bytes]) -> np.ndarray:
    """Pack equal-block-count messages into (B, n_blocks, 16) u32."""
    arrs = [pad_message(m) for m in messages]
    n = arrs[0].shape[0]
    if any(a.shape[0] != n for a in arrs):
        raise ValueError("all messages in a batch must pad to the same block "
                         "count")
    return np.stack(arrs)


def digests_to_bytes(digests) -> list[bytes]:
    """(B, 8) u32 → list of 32-byte digests (a word tensor is read back to
    the host first; one ``tobytes`` for the whole batch)."""
    if isinstance(digests, torch.Tensor):
        digests = words_to_numpy(as_words(digests))
    raw = np.asarray(digests, dtype=np.uint32).astype(">u4").tobytes()
    return [raw[i:i + 32] for i in range(0, len(raw), 32)]


def digests_from_bytes(hashes: list[bytes]) -> np.ndarray:
    """list of 32-byte digests → (B, 8) u32."""
    return np.stack([np.frombuffer(h, dtype=">u4").astype(np.uint32)
                     for h in hashes])
