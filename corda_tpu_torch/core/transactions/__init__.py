"""Transaction types: wire format, signed wrapper, resolved (verifiable) form,
tear-offs, the builder and the bulk Merkle seams (own copies of the
reference package's transactions modules of the same names).

Reference parity: core/.../transactions/ (WireTransaction.kt, SignedTransaction.kt,
LedgerTransaction.kt, MerkleTransaction.kt, TransactionBuilder.kt).
"""
from .wire import WireTransaction, TraversableTransaction
from .signed import SignedTransaction, SignaturesMissingException
from .ledger import LedgerTransaction, TransactionForContract, InOutGroup
from .filtered import FilteredLeaves, FilteredTransaction
from .builder import TransactionBuilder

__all__ = [
    "WireTransaction", "TraversableTransaction", "SignedTransaction",
    "SignaturesMissingException", "LedgerTransaction", "TransactionForContract",
    "InOutGroup", "FilteredLeaves", "FilteredTransaction", "TransactionBuilder",
]
