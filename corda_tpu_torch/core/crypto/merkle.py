"""Merkle trees and partial (tear-off) Merkle proofs — host semantics.

Reference parity: MerkleTree.kt:27-66 (bottom-up build, leaf list zero-padded to the
next power of two, node hash = single SHA-256 of the 64-byte concatenation) and
PartialMerkleTree.kt (tear-off proofs used by FilteredTransaction and oracles).

The batched device implementation (the level reduction as CUDA kernel B6)
lives in ``corda_tpu_torch.ops.sha256`` (``merkle_root``, ``hash_pairs``; the
bulk seams are ``core.transactions.batch_merkle``) and is tested
bit-exact against this module.
"""
from __future__ import annotations

from dataclasses import dataclass

from .secure_hash import SecureHash


class MerkleTreeException(Exception):
    pass


@dataclass(frozen=True)
class MerkleTree:
    """A full binary Merkle tree node (leaves are trees with no children)."""

    hash: SecureHash
    left: "MerkleTree | None" = None
    right: "MerkleTree | None" = None

    @property
    def is_leaf(self) -> bool:
        return self.left is None

    @staticmethod
    def get_merkle_tree(all_leaves_hashes: list[SecureHash]) -> "MerkleTree":
        """Build bottom-up; pad the leaf level with zero-hashes to a power of two."""
        if not all_leaves_hashes:
            raise MerkleTreeException("Cannot calculate Merkle root on empty hash list.")
        leaves = pad_to_power_of_two(all_leaves_hashes)
        level = [MerkleTree(h) for h in leaves]
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), 2):
                l, r = level[i], level[i + 1]
                nxt.append(MerkleTree(l.hash.hash_concat(r.hash), l, r))
            level = nxt
        return level[0]

    @staticmethod
    def root_hash(all_leaves_hashes: list[SecureHash]) -> SecureHash:
        return MerkleTree.get_merkle_tree(all_leaves_hashes).hash


def pad_to_power_of_two(hashes: list[SecureHash]) -> list[SecureHash]:
    n = 1
    while n < len(hashes):
        n <<= 1
    return list(hashes) + [SecureHash.zero_hash()] * (n - len(hashes))


# ---------------------------------------------------------------------------
# Partial Merkle trees (tear-offs)
# ---------------------------------------------------------------------------

# Proof-tree nodes: exactly one of the reference's PartialTree variants.
@dataclass(frozen=True)
class _IncludedLeaf:
    hash: SecureHash


@dataclass(frozen=True)
class _Leaf:
    hash: SecureHash


@dataclass(frozen=True)
class _Node:
    left: "PartialTree"
    right: "PartialTree"


PartialTree = _IncludedLeaf | _Leaf | _Node


@dataclass(frozen=True)
class PartialMerkleTree:
    """A pruned Merkle tree revealing only the included leaves plus the minimal set
    of sibling hashes needed to recompute the root."""

    root: PartialTree

    @staticmethod
    def build(merkle_tree: MerkleTree, included_hashes: list[SecureHash]) -> "PartialMerkleTree":
        used: set[SecureHash] = set()
        tree = _prune(merkle_tree, set(included_hashes), used)
        missing = set(included_hashes) - used
        if missing:
            raise MerkleTreeException(
                f"Some of the provided hashes are not in the tree: {missing}")
        return PartialMerkleTree(tree)

    def verify(self, expected_root: SecureHash, hashes_to_check: list[SecureHash]) -> bool:
        root_hash, included = _rebuild(self.root)
        return root_hash == expected_root and set(hashes_to_check) == set(included)

    @property
    def included_hashes(self) -> list[SecureHash]:
        return _rebuild(self.root)[1]


def _prune(tree: MerkleTree, include: set[SecureHash], used: set[SecureHash]) -> PartialTree:
    if tree.is_leaf:
        if tree.hash in include:
            used.add(tree.hash)
            return _IncludedLeaf(tree.hash)
        return _Leaf(tree.hash)
    left = _prune(tree.left, include, used)
    right = _prune(tree.right, include, used)
    if isinstance(left, _Leaf) and isinstance(right, _Leaf):
        return _Leaf(tree.hash)  # collapse fully-hidden subtrees to one hash
    return _Node(left, right)


def _rebuild(node: PartialTree) -> tuple[SecureHash, list[SecureHash]]:
    if isinstance(node, _IncludedLeaf):
        return node.hash, [node.hash]
    if isinstance(node, _Leaf):
        return node.hash, []
    lh, li = _rebuild(node.left)
    rh, ri = _rebuild(node.right)
    return lh.hash_concat(rh), li + ri
