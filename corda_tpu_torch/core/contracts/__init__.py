"""The ledger algebra: states, commands, transaction-verification rules.

Own copies of corda_tpu.core.contracts' modules of the same names, with the
same registered wire names and field orders (``Amount`` and the currency
helpers of ``amount.py``, the clause library, the attachment contract and
the contract sandbox are not ported yet).

Reference parity: core/.../contracts/ (Structures.kt,
TransactionVerification.kt, TransactionTypes.kt).
"""
from .structures import (
    Contract, ContractState, OwnableState, FungibleAsset, LinearState, SchedulableState,
    ScheduledActivity, TransactionState, StateRef, StateAndRef, Command,
    AuthenticatedObject, CommandData, TypeOnlyCommandData, MoveCommand, IssueCommand,
    ExitCommand, TimeWindow, PartyAndReference, Issued, UniqueIdentifier, Attachment,
    requireThat,
)
from .exceptions import (
    TransactionVerificationException, TransactionResolutionException,
    AttachmentResolutionException, ContractRejection, MoreThanOneNotary,
    SignersMissing, DuplicateInputStates, InvalidNotaryChange,
    NotaryChangeInWrongTransactionType, TransactionMissingEncumbranceException,
)
from .transaction_types import TransactionType

__all__ = [
    "Contract", "ContractState", "OwnableState", "FungibleAsset", "LinearState",
    "SchedulableState", "ScheduledActivity", "TransactionState", "StateRef",
    "StateAndRef", "Command", "AuthenticatedObject", "CommandData",
    "TypeOnlyCommandData", "MoveCommand", "IssueCommand", "ExitCommand", "TimeWindow",
    "PartyAndReference", "Issued", "UniqueIdentifier", "Attachment", "requireThat",
    "TransactionVerificationException", "TransactionResolutionException",
    "AttachmentResolutionException", "ContractRejection", "MoreThanOneNotary",
    "SignersMissing", "DuplicateInputStates", "InvalidNotaryChange",
    "NotaryChangeInWrongTransactionType", "TransactionMissingEncumbranceException",
    "TransactionType",
]
