"""Commodity claims — fungible assets whose product is a commodity, not a
currency.

Reference parity: finance CommodityContract.kt (the "cut-n-paste of Cash"
the reference itself documents — an OnLedgerAsset over Commodity products).
This package DE-duplicates instead: the Issue/Move/Exit group
clauses are generic over FungibleAsset amounts (finance.cash), so this
module adds only the Commodity product type, the state, and the contract
shell reusing them.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.contracts.amount import Amount
from ..core.contracts.clauses import AnyOf, GroupClauseVerifier, verify_clause
from ..core.contracts.structures import (CommandData, FungibleAsset, Issued,
                                         PartyAndReference,
                                         TypeOnlyCommandData)
from ..core.crypto.keys import PublicKey
from ..core.crypto.secure_hash import SecureHash
from ..core.serialization import register_type, serializable
from .cash import Contract, ExitClause, IssueClause, MoveClause


@serializable("finance.Commodity")
@dataclass(frozen=True)
class Commodity:
    """A tradeable commodity (reference Commodity data class): identified by
    its commodity code, e.g. "FCOJ" — frozen concentrated orange juice."""

    commodity_code: str
    display_name: str = ""
    default_fraction_digits: int = 0

    def __str__(self):
        return self.commodity_code


# INDEPENDENT command types (not subclasses of Cash's): in a mixed
# cash+commodity transaction each contract's isinstance filter must see
# ONLY its own commands — a shared hierarchy would apply cash conservation
# to commodity commands and vice versa (review r3).

@serializable("Commodity.Issue")
@dataclass(frozen=True)
class Issue(TypeOnlyCommandData):
    """Issue commodity claims (CommodityContract.Commands.Issue)."""


@serializable("Commodity.Move")
@dataclass(frozen=True)
class Move(TypeOnlyCommandData):
    """Move commodity claims (CommodityContract.Commands.Move)."""


@serializable("Commodity.Exit")
@dataclass(frozen=True)
class Exit(CommandData):
    """Exit commodity claims (CommodityContract.Commands.Exit)."""

    amount: Amount  # Amount[Issued[Commodity]]


@serializable("finance.CommodityState")
@dataclass(frozen=True)
class CommodityState(FungibleAsset):
    """An amount of an issued commodity owned by a key
    (CommodityContract.State)."""

    amount: Amount        # Amount[Issued[Commodity]]
    owner: PublicKey

    @property
    def contract(self) -> "CommodityContract":
        return COMMODITY_PROGRAM

    @property
    def participants(self):
        return [self.owner]

    @property
    def issuer(self) -> PartyAndReference:
        return self.amount.token.issuer

    @property
    def exit_keys(self) -> set[PublicKey]:
        return {self.owner, self.amount.token.issuer.party.owning_key}

    def with_new_owner(self, new_owner: PublicKey):
        return (Move(), CommodityState(self.amount, new_owner))


class CommodityIssueClause(IssueClause):
    issue_command = Issue
    required_commands = (Issue,)


class CommodityMoveClause(MoveClause):
    move_command = Move
    exit_command = Exit
    required_commands = (Move,)


class CommodityExitClause(ExitClause):
    exit_command = Exit
    required_commands = (Exit,)


class CommodityGroupClause(GroupClauseVerifier):
    def __init__(self):
        super().__init__(AnyOf(CommodityIssueClause(), CommodityMoveClause(),
                               CommodityExitClause()))

    def group_states(self, tx):
        return tx.group_states(CommodityState, lambda s: s.amount.token)


class CommodityContract(Contract):
    """The commodity contract (CommodityContract.kt), sharing the cash
    clauses — conservation per (issuer, commodity) token group, issuer-signed
    issuance, owner-signed moves, owner+issuer-signed exits."""

    legal_contract_reference = SecureHash.sha256(
        b"corda_tpu.finance.CommodityContract: commodity claims")

    Issue = Issue
    Move = Move
    Exit = Exit
    State = CommodityState

    def verify(self, tx) -> None:
        commands = [c for c in tx.commands
                    if isinstance(c.value, (Issue, Move, Exit))]
        verify_clause(tx, CommodityGroupClause(), commands)

    @staticmethod
    def generate_issue(builder, amount: Amount, issuer: PartyAndReference,
                       owner: PublicKey, notary) -> None:
        """amount: Amount[Commodity] → Amount[Issued[Commodity]] output."""
        issued = Amount(amount.quantity, Issued(issuer, amount.token))
        builder.add_output_state(CommodityState(issued, owner), notary)
        builder.add_command(Issue(), issuer.party.owning_key)

    @staticmethod
    def generate_move(builder, sar, new_owner: PublicKey) -> PublicKey:
        """Move one whole holding to ``new_owner``; returns the key that
        must sign."""
        builder.add_input_state(sar)
        builder.add_output_state(
            CommodityState(sar.state.data.amount, new_owner),
            sar.state.notary)
        builder.add_command(Move(), sar.state.data.owner)
        return sar.state.data.owner


COMMODITY_PROGRAM = CommodityContract()
