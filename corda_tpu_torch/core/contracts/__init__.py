"""The ledger algebra: states, commands, amounts, transaction-verification rules.

Own copies of the reference package's contracts modules of the same names
(``amount.py`` with ``Amount`` and the currency helpers among them), with
the same registered wire names and field orders. The clause library, the
attachment contract and the contract sandbox are not ported yet.

Reference parity: core/.../contracts/ (Structures.kt, Amount.kt,
TransactionVerification.kt, TransactionTypes.kt).
"""
from .structures import (
    Contract, ContractState, OwnableState, FungibleAsset, LinearState, SchedulableState,
    ScheduledActivity, TransactionState, StateRef, StateAndRef, Command,
    AuthenticatedObject, CommandData, TypeOnlyCommandData, MoveCommand, IssueCommand,
    ExitCommand, TimeWindow, PartyAndReference, Issued, UniqueIdentifier, Attachment,
    requireThat,
)
from .amount import Amount, Currency, USD, GBP, EUR, CHF
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
    "Amount", "Currency", "USD", "GBP", "EUR", "CHF",
    "TransactionVerificationException", "TransactionResolutionException",
    "AttachmentResolutionException", "ContractRejection", "MoreThanOneNotary",
    "SignersMissing", "DuplicateInputStates", "InvalidNotaryChange",
    "NotaryChangeInWrongTransactionType", "TransactionMissingEncumbranceException",
    "TransactionType",
]
