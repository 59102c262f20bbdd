"""The port's SHA-256/Merkle functions (B6, corda_tpu_torch.ops.sha256)
against the JAX package's jitted kernels, hashlib and the host MerkleTree.

Every comparison is exact (bit for bit): the same numpy uint32 inputs go
through the JAX function and the port's plain PyTorch version on the CPU.
The JAX calls stay at the shapes tests/test_ops_sha256.py compiles.
"""
import hashlib
import os
import re

import numpy as np
import pytest
import torch

from corda_tpu.core.crypto import MerkleTree as JaxMerkleTree
from corda_tpu.core.crypto import SecureHash as JaxSecureHash
from corda_tpu.core.crypto.merkle import pad_to_power_of_two as jax_pad
from corda_tpu.ops import sha256 as jsha
from corda_tpu_torch import _build
from corda_tpu_torch.core.crypto import MerkleTree, SecureHash
from corda_tpu_torch.core.crypto.merkle import pad_to_power_of_two
from corda_tpu_torch.ops import sha256 as tsha


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _u32(x) -> np.ndarray:
    """A JAX array or a port word tensor as numpy uint32."""
    if isinstance(x, torch.Tensor):
        return tsha.words_to_numpy(x)
    return np.asarray(x, dtype=np.uint32)


def _rand_words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


# The message batches of tests/test_ops_sha256.py: 1, 2 and 16 blocks.
_BLOCK_CASES = {
    "1-block": [b"", b"abc", b"a" * 55],
    "2-block": [bytes(np.random.default_rng(1).integers(0, 256, 100,
                                                         dtype=np.uint8))
                for _ in range(8)],
    "16-block": [bytes(np.random.default_rng(2).integers(0, 256, 1000,
                                                          dtype=np.uint8))
                 for _ in range(4)],
}


@pytest.mark.parametrize("case", list(_BLOCK_CASES))
def test_sha256_blocks_equals_jax_and_hashlib(case):
    msgs = _BLOCK_CASES[case]
    batch = tsha.pack_batch(msgs)
    np.testing.assert_array_equal(batch, jsha.pack_batch(msgs))
    got = tsha.sha256_blocks(batch)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(_u32(got), _u32(jsha.sha256_blocks(batch)))
    assert tsha.digests_to_bytes(got) == [hashlib.sha256(m).digest()
                                          for m in msgs]


def test_hash_pairs_equals_jax_and_hash_concat():
    rng = np.random.default_rng(0)
    left = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(16)]
    right = [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
             for _ in range(16)]
    pairs = np.concatenate([tsha.digests_from_bytes(left),
                            tsha.digests_from_bytes(right)], axis=1)
    got = tsha.hash_pairs(pairs)
    np.testing.assert_array_equal(_u32(got), _u32(jsha.hash_pairs(pairs)))
    for l, r, d in zip(left, right, tsha.digests_to_bytes(got)):
        assert d == SecureHash(l).hash_concat(SecureHash(r)).bytes


@pytest.mark.parametrize("n_leaves", [1, 2, 8, 64, 256])
def test_merkle_root_equals_jax_and_host_tree(n_leaves):
    leaves = [SecureHash.sha256(bytes([i % 256, i // 256]))
              for i in range(n_leaves)]
    words = tsha.digests_from_bytes([h.bytes for h in
                                     pad_to_power_of_two(leaves)])
    got = tsha.merkle_root(words)
    np.testing.assert_array_equal(_u32(got), _u32(jsha.merkle_root(words)))
    host = MerkleTree.get_merkle_tree(leaves).hash
    jax_leaves = [JaxSecureHash(h.bytes) for h in leaves]
    assert host.bytes == JaxMerkleTree.get_merkle_tree(jax_leaves).hash.bytes
    assert [h.bytes for h in jax_pad(jax_leaves)] == [
        h.bytes for h in pad_to_power_of_two(leaves)]
    assert tsha.digests_to_bytes(got[None])[0] == host.bytes


def test_random_block_counts_equal_hashlib():
    """Messages of a random length each (0..600 bytes), grouped by block
    count; every group through sha256_blocks equals hashlib."""
    rng = np.random.default_rng(7)
    msgs = [bytes(rng.integers(0, 256, int(rng.integers(0, 600)),
                               dtype=np.uint8)) for _ in range(96)]
    groups: dict[int, list[bytes]] = {}
    for m in msgs:
        groups.setdefault(tsha.pad_message(m).shape[0], []).append(m)
    assert len(groups) >= 5
    for n_blocks, group in groups.items():
        got = tsha.sha256_blocks(tsha.pack_batch(group))
        assert tsha.digests_to_bytes(got) == [hashlib.sha256(m).digest()
                                              for m in group], n_blocks


def test_hash_pairs_and_roots_with_leading_dims_equal_host():
    rng = np.random.default_rng(3)
    pairs = _rand_words(rng, 3, 5, 16)
    got = tsha.hash_pairs(pairs)
    assert got.shape == (3, 5, 8)
    raw = pairs.astype(">u4").tobytes()
    want = [hashlib.sha256(raw[64 * i:64 * i + 64]).digest()
            for i in range(15)]
    assert tsha.digests_to_bytes(got.reshape(15, 8)) == want
    leaves = _rand_words(rng, 2, 3, 16, 8)
    roots = tsha.merkle_root(leaves)
    assert roots.shape == (2, 3, 8)
    for idx in np.ndindex(2, 3):
        hashes = [SecureHash(row.astype(">u4").tobytes())
                  for row in leaves[idx]]
        assert (tsha.digests_to_bytes(roots[idx][None])[0]
                == MerkleTree.root_hash(hashes).bytes)


def test_helpers_are_byte_identical_to_jax():
    rng = np.random.default_rng(4)
    for n in (0, 1, 55, 56, 63, 64, 119, 120, 200):
        m = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        np.testing.assert_array_equal(tsha.pad_message(m),
                                      jsha.pad_message(m))
        assert tsha.pad_message(m).dtype == np.uint32
    msgs = [os.urandom(70) for _ in range(5)]
    np.testing.assert_array_equal(tsha.pack_batch(msgs), jsha.pack_batch(msgs))
    digests = _rand_words(rng, 6, 8)
    assert tsha.digests_to_bytes(digests) == jsha.digests_to_bytes(digests)
    assert tsha.digests_to_bytes(tsha.as_words(digests)) == \
        jsha.digests_to_bytes(digests)
    hashes = jsha.digests_to_bytes(digests)
    np.testing.assert_array_equal(tsha.digests_from_bytes(hashes),
                                  jsha.digests_from_bytes(hashes))
    for fn in (tsha.pad_message, jsha.pad_message):
        with pytest.raises(ValueError):
            fn(b"x" * 100, n_blocks=1)
        with pytest.raises(ValueError):
            fn(b"x", n_blocks=2)
    for fn in (tsha.pack_batch, jsha.pack_batch):
        with pytest.raises(ValueError):
            fn([b"x", b"y" * 100])


def test_merkle_root_errors_and_single_leaf():
    for fn in (tsha.merkle_root, jsha.merkle_root):
        with pytest.raises(ValueError):
            fn(np.zeros((3, 8), dtype=np.uint32))
        with pytest.raises(ValueError):
            fn(np.zeros((2, 6, 8), dtype=np.uint32))
    leaf = _rand_words(np.random.default_rng(5), 4, 1, 8)
    before = tsha.merkle_root.launches
    got = tsha.merkle_root(leaf)
    np.testing.assert_array_equal(_u32(got), leaf[:, 0, :])
    assert tsha.merkle_root.launches == before


def test_word_tensor_conversions():
    arr = np.array([[0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF] * 3 + [5]],
                   dtype=np.uint32)
    words = tsha.as_words(arr)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(tsha.words_to_numpy(words), arr)
    as_u32 = torch.from_numpy(arr)
    assert as_u32.dtype == torch.uint32
    assert torch.equal(tsha.as_words(as_u32), words)
    assert torch.equal(tsha.hash_pairs(as_u32), tsha.hash_pairs(arr))
    with pytest.raises(TypeError):
        tsha.hash_pairs(torch.zeros(1, 16, dtype=torch.int64))


def test_cuda_wrappers_check_arguments_and_raise_build_errors(monkeypatch,
                                                              tmp_path):
    """The CUDA wrappers refuse arguments the kernel does not take before
    loading anything, and a library that cannot be built raises
    KernelError (BuildError) — nothing falls back to the plain version."""
    with pytest.raises(ValueError):
        tsha.hash_pairs_cuda(torch.zeros(4, 8, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsha.merkle_root_cuda(torch.zeros(4, 16, dtype=torch.int64))
    with pytest.raises(ValueError):
        tsha.sha256_blocks_cuda(
            torch.zeros(2, 1, 32, dtype=torch.int32)[..., ::2])
    monkeypatch.setitem(_build._TARGETS["sha256"], "compiler", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    tsha.load_kernel.cache_clear()
    try:
        for fn, t in ((tsha.hash_pairs_cuda, torch.zeros(4, 16)),
                      (tsha.merkle_root_cuda, torch.zeros(4, 8)),
                      (tsha.sha256_blocks_cuda, torch.zeros(4, 1, 16))):
            before = (tsha.hash_pairs.launches, tsha.merkle_root.launches,
                      tsha.sha256_blocks.launches)
            with pytest.raises(_build.KernelError, match="no compiler"):
                fn(t.to(torch.int32))
            assert (tsha.hash_pairs.launches, tsha.merkle_root.launches,
                    tsha.sha256_blocks.launches) == before
    finally:
        tsha.load_kernel.cache_clear()


def _cu_table(src: str, name: str) -> list[int]:
    body = re.search(name + r"\[64\] = \{(.*?)\};", src, re.S).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]{8})u", body)]


def test_kernel_source_constants():
    """SHA_K and the pad block's W + K in csrc/sha256.cu equal the plain
    version's constants and schedule."""
    src = open(os.path.join(_build.CSRC, "sha256.cu")).read()
    k = [int(v) for v in tsha._K]
    assert _cu_table(src, "SHA_K") == k
    w = [int(v) for v in tsha._PAD_BLOCK_64B]
    m = 0xFFFFFFFF

    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & m
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & m)
    assert _cu_table(src, "PAD_WK") == [(a + b) & m for a, b in zip(w, k)]
