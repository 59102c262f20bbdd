"""Transaction types: wire format, signed wrapper, resolved (verifiable) form,
tear-offs and the bulk Merkle seams (own copies of corda_tpu.core.transactions'
modules of the same names; the transaction builder is not ported yet).

Reference parity: core/.../transactions/ (WireTransaction.kt, SignedTransaction.kt,
LedgerTransaction.kt, MerkleTransaction.kt).
"""
from .wire import WireTransaction, TraversableTransaction
from .signed import SignedTransaction, SignaturesMissingException
from .ledger import LedgerTransaction, TransactionForContract, InOutGroup
from .filtered import FilteredLeaves, FilteredTransaction

__all__ = [
    "WireTransaction", "TraversableTransaction", "SignedTransaction",
    "SignaturesMissingException", "LedgerTransaction", "TransactionForContract",
    "InOutGroup", "FilteredLeaves", "FilteredTransaction",
]
