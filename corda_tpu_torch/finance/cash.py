"""Cash — the fungible-asset contract, written in the clause framework.

Reference parity: finance/.../contracts/asset/Cash.kt:1-222 (clause-based
verify over (issuer, currency) groups) and OnLedgerAsset.kt:1-258
(generate_issue/generate_spend/generate_exit builder helpers).

Conservation rules per group (Cash.Clauses):
- Issue: no inputs consumed, positive issued amount, issuer must sign.
- Move: inputs == outputs (by amount), all input owners must sign.
- Exit: inputs == outputs + exited amount, exit keys (owners + issuer) sign.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.contracts.amount import Amount, Currency, sum_or_zero
from ..core.contracts.clauses import (AllOf, AnyOf, Clause, FirstOf,
                                      GroupClauseVerifier, verify_clause)
from ..core.contracts.exceptions import TransactionVerificationException
from ..core.contracts.structures import (Command, CommandData, Contract,
                                         FungibleAsset, Issued,
                                         PartyAndReference,
                                         TypeOnlyCommandData, TransactionState)
from ..core.crypto.keys import PublicKey
from ..core.crypto.secure_hash import SecureHash
from ..core.serialization import serializable
from ..node.schemas import MappedSchema

#: The reference's CashSchemaV1 (finance/schemas/CashSchemaV1.kt): the
#: exportable typed projection of cash states.
CASH_SCHEMA_V1 = MappedSchema("CashSchema", 1, (
    "owner_key", "pennies", "ccy_code", "issuer_party", "issuer_ref"))


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------

@serializable("Cash.Issue")
@dataclass(frozen=True)
class Issue(TypeOnlyCommandData):
    pass


@serializable("Cash.Move")
@dataclass(frozen=True)
class Move(TypeOnlyCommandData):
    pass


@serializable("Cash.Exit")
@dataclass(frozen=True)
class Exit(CommandData):
    amount: Amount  # Amount[Issued[Currency]]


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

@serializable("Cash.State")
@dataclass(frozen=True)
class CashState(FungibleAsset):
    """An amount of issued currency owned by a key (Cash.State)."""

    amount: Amount        # Amount[Issued[Currency]]
    owner: PublicKey

    @property
    def contract(self) -> "Cash":
        return CASH_PROGRAM

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
        return (Move(), CashState(self.amount, new_owner))

    # -- custom schema export (finance CashSchemaV1 analog) ------------------
    def supported_schemas(self) -> tuple:
        return (CASH_SCHEMA_V1,)

    def generate_mapped_object(self, schema) -> dict:
        if schema.table_name != CASH_SCHEMA_V1.table_name:
            raise ValueError(f"unsupported schema {schema.name}")
        return {
            "owner_key": self.owner.to_string_short(),
            "pennies": self.amount.quantity,
            "ccy_code": str(self.amount.token.product),
            "issuer_party": str(self.issuer.party.name),
            "issuer_ref": self.issuer.reference.hex(),
        }


# ---------------------------------------------------------------------------
# Clauses (Cash.Clauses structure)
# ---------------------------------------------------------------------------

def _group_token(states):
    return states[0].amount.token if states else None


class IssueClause(Clause):
    """Issuance rules, parametric over the asset's command types so other
    fungible assets (finance.commodity) reuse the clause WITHOUT sharing
    command classes — shared classes would let one contract's isinstance
    filter capture the other's commands in a mixed transaction."""

    issue_command = Issue
    required_commands = (Issue,)

    def verify(self, tx, inputs, outputs, commands, token) -> set:
        issue_cmds = [c for c in commands
                      if isinstance(c.value, self.issue_command)]
        if not issue_cmds:
            return set()
        out_sum = sum_or_zero((s.amount for s in outputs), token)
        in_sum = sum_or_zero((s.amount for s in inputs), token)
        if not outputs:
            raise TransactionVerificationException(
                tx.id, "Issue transaction must output cash")
        if out_sum.quantity <= in_sum.quantity:
            raise TransactionVerificationException(
                tx.id, "Issued amount must be positive")
        issuer_key = token.issuer.party.owning_key
        for cmd in issue_cmds:
            # fulfil against the signer SET (a composite issuer key needs its
            # threshold met across several leaf signatures)
            if not issuer_key.is_fulfilled_by(set(cmd.signers)):
                raise TransactionVerificationException(
                    tx.id, "Issue command must be signed by the issuer")
        return {c.value for c in issue_cmds}


class MoveClause(Clause):
    move_command = Move
    exit_command = Exit
    required_commands = (Move,)

    def verify(self, tx, inputs, outputs, commands, token) -> set:
        move_cmds = [c for c in commands
                     if isinstance(c.value, self.move_command)]
        if not move_cmds:
            return set()
        in_sum = sum_or_zero((s.amount for s in inputs), token)
        out_sum = sum_or_zero((s.amount for s in outputs), token)
        exit_amount = sum((c.value.amount.quantity for c in commands
                           if isinstance(c.value, self.exit_command)
                           and c.value.amount.token == token), 0)
        if in_sum.quantity != out_sum.quantity + exit_amount:
            raise TransactionVerificationException(
                tx.id, f"Cash not conserved for {token}: "
                       f"{in_sum.quantity} in vs {out_sum.quantity} out")
        owner_keys = {s.owner for s in inputs}
        signers = {k for c in move_cmds for k in c.signers}
        for key in owner_keys:
            if not key.is_fulfilled_by(signers):
                raise TransactionVerificationException(
                    tx.id, "Move command must be signed by every input owner")
        return {c.value for c in move_cmds}


class ExitClause(Clause):
    exit_command = Exit
    required_commands = (Exit,)

    def verify(self, tx, inputs, outputs, commands, token) -> set:
        exit_cmds = [c for c in commands
                     if isinstance(c.value, self.exit_command)
                     and c.value.amount.token == token]
        if not exit_cmds:
            return set()
        # Conservation must hold on the exit path too (the reference's
        # ConserveAmount applies to every non-issue group): an Exit-only
        # transaction may not create or destroy more value than it declares.
        in_sum = sum_or_zero((s.amount for s in inputs), token)
        out_sum = sum_or_zero((s.amount for s in outputs), token)
        exit_amount = sum(c.value.amount.quantity for c in exit_cmds)
        if in_sum.quantity != out_sum.quantity + exit_amount:
            raise TransactionVerificationException(
                tx.id, f"Cash not conserved on exit for {token}: {in_sum.quantity} "
                       f"in vs {out_sum.quantity} out + {exit_amount} exited")
        required = {k for s in inputs for k in s.exit_keys}
        signers = {k for c in exit_cmds for k in c.signers}
        for key in required:
            if not key.is_fulfilled_by(signers):
                raise TransactionVerificationException(
                    tx.id, "Exit command requires owner and issuer signatures")
        return {c.value for c in exit_cmds}


class CashGroupClause(GroupClauseVerifier):
    def __init__(self):
        super().__init__(AnyOf(IssueClause(), MoveClause(), ExitClause()))

    def group_states(self, tx):
        return tx.group_states(CashState, lambda s: s.amount.token)


class Cash(Contract):
    """The cash contract object (Cash.kt)."""

    legal_contract_reference = SecureHash.sha256(
        b"corda_tpu.finance.Cash: fungible currency claims")

    Issue = Issue
    Move = Move
    Exit = Exit
    State = CashState

    def verify(self, tx) -> None:
        cash_commands = [c for c in tx.commands
                         if isinstance(c.value, (Issue, Move, Exit))]
        verify_clause(tx, CashGroupClause(), cash_commands)

    # -- builder helpers (OnLedgerAsset.kt) ----------------------------------
    @staticmethod
    def generate_issue(builder, amount: Amount, issuer: PartyAndReference,
                       owner: PublicKey, notary) -> None:
        """amount: Amount[Currency]; wraps into Amount[Issued[Currency]]."""
        issued = Amount(amount.quantity, Issued(issuer, amount.token))
        builder.add_output_state(CashState(issued, owner), notary)
        builder.add_command(Issue(), issuer.party.owning_key)

    @staticmethod
    def generate_spend(builder, amount: Amount, to: PublicKey,
                       coins: list, change_owner: PublicKey) -> list[PublicKey]:
        """Add inputs/outputs moving `amount` (Amount[Currency]) from `coins`
        (StateAndRefs) to `to`, with change back to `change_owner`. Returns the
        keys that must sign.

        Coins must all be in `amount`'s currency (callers filter at selection)
        but may span issuers: conservation holds per (issuer, currency) token
        group, so the payment is emitted as one output per issuer token drawn
        on, with per-token change (OnLedgerAsset.kt's grouped spend)."""
        used, gathered = [], 0
        for sar in coins:
            if sar.state.data.amount.token.product != amount.token:
                raise ValueError(
                    f"Coin in {sar.state.data.amount.token.product}, "
                    f"spend is in {amount.token}")
            used.append(sar)
            gathered += sar.state.data.amount.quantity
            if gathered >= amount.quantity:
                break
        if gathered < amount.quantity:
            raise InsufficientBalanceException(amount.quantity - gathered)
        notary = used[0].state.notary
        by_token: dict = {}
        for sar in used:
            builder.add_input_state(sar)
            token = sar.state.data.amount.token
            by_token[token] = by_token.get(token, 0) + sar.state.data.amount.quantity
        need = amount.quantity
        for token, total in by_token.items():
            pay = min(need, total)
            need -= pay
            if pay:
                builder.add_output_state(CashState(Amount(pay, token), to),
                                         notary)
            if total > pay:
                builder.add_output_state(
                    CashState(Amount(total - pay, token), change_owner), notary)
        keys = sorted({sar.state.data.owner for sar in used})
        builder.add_command(Move(), *keys)
        return keys


class InsufficientBalanceException(Exception):
    def __init__(self, shortfall):
        super().__init__(f"Insufficient balance, short by {shortfall}")
        self.shortfall = shortfall


CASH_PROGRAM = Cash()

from ..core.serialization import register_type as _register_type  # noqa: E402

_register_type("Cash", Cash, to_fields=lambda c: [],
               from_fields=lambda f: CASH_PROGRAM)
