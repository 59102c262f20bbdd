"""Transaction tear-offs: FilteredLeaves + FilteredTransaction.

Reference parity: MerkleTransaction.kt:70-170 — reveal a predicate-selected subset
of components plus a partial Merkle tree proving membership under the tx id, so
oracles/non-validating notaries sign without seeing the rest (privacy).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..crypto.merkle import MerkleTree, PartialMerkleTree
from ..crypto.secure_hash import SecureHash
from ..serialization import register_type, serialized_hash
from .wire import TraversableTransaction, WireTransaction


class FilteredLeaves(TraversableTransaction):
    """The revealed components of a torn transaction."""

    def __init__(self, inputs=(), attachments=(), outputs=(), commands=(),
                 notary=None, must_sign=(), type=None, time_window=None):
        self.inputs = tuple(inputs)
        self.attachments = tuple(attachments)
        self.outputs = tuple(outputs)
        self.commands = tuple(commands)
        self.notary = notary
        self.must_sign = tuple(must_sign)
        self.type = type
        self.time_window = time_window

    def check_with_fun(self, checking_fun) -> bool:
        """Force type checking over every revealed component so a signer can't be
        tricked into signing over unexpected extras (MerkleTransaction.kt:95-100)."""
        checks = [checking_fun(c) for c in self.available_components]
        return bool(checks) and all(checks)

    def __eq__(self, other):
        return (isinstance(other, FilteredLeaves)
                and self.available_components == other.available_components)

    def __hash__(self):
        return hash(tuple(self.available_component_hashes))


@dataclass(frozen=True)
class FilteredTransaction:
    root_hash: SecureHash
    filtered_leaves: FilteredLeaves
    partial_merkle_tree: PartialMerkleTree

    @staticmethod
    def build_filtered_transaction(wtx: WireTransaction, predicate) -> "FilteredTransaction":
        def keep(items):
            return tuple(i for i in items if predicate(i))

        leaves = FilteredLeaves(
            inputs=keep(wtx.inputs),
            attachments=keep(wtx.attachments),
            outputs=keep(wtx.outputs),
            commands=keep(wtx.commands),
            notary=wtx.notary if wtx.notary is not None and predicate(wtx.notary) else None,
            must_sign=keep(wtx.must_sign),
            type=wtx.type if wtx.type is not None and predicate(wtx.type) else None,
            time_window=(wtx.time_window
                         if wtx.time_window is not None and predicate(wtx.time_window)
                         else None),
        )
        included = leaves.available_component_hashes
        pmt = PartialMerkleTree.build(wtx.merkle_tree, included)
        return FilteredTransaction(wtx.id, leaves, pmt)

    def verify(self) -> bool:
        """Check every revealed component is proven under ``root_hash``."""
        hashes = self.filtered_leaves.available_component_hashes
        if not hashes:
            raise ValueError("Transaction without included leaves cannot be verified")
        return self.partial_merkle_tree.verify(self.root_hash, hashes)


# -- wire registrations ------------------------------------------------------

def _tree_to_wire(node) -> list:
    from ..crypto.merkle import _IncludedLeaf, _Leaf, _Node
    if isinstance(node, _IncludedLeaf):
        return [0, node.hash]
    if isinstance(node, _Leaf):
        return [1, node.hash]
    return [2, _tree_to_wire(node.left), _tree_to_wire(node.right)]


def _tree_from_wire(w):
    from ..crypto.merkle import _IncludedLeaf, _Leaf, _Node
    if w[0] == 0:
        return _IncludedLeaf(w[1])
    if w[0] == 1:
        return _Leaf(w[1])
    return _Node(_tree_from_wire(w[1]), _tree_from_wire(w[2]))


register_type("PartialMerkleTree", PartialMerkleTree,
              to_fields=lambda t: [_tree_to_wire(t.root)],
              from_fields=lambda f: PartialMerkleTree(_tree_from_wire(f[0])))
register_type(
    "FilteredLeaves", FilteredLeaves,
    to_fields=lambda l: [list(l.inputs), list(l.attachments), list(l.outputs),
                         list(l.commands), l.notary, list(l.must_sign), l.type,
                         l.time_window],
    from_fields=lambda f: FilteredLeaves(*f))
register_type("FilteredTransaction", FilteredTransaction,
              to_fields=lambda t: [t.root_hash, t.filtered_leaves, t.partial_merkle_tree],
              from_fields=lambda f: FilteredTransaction(*f))
