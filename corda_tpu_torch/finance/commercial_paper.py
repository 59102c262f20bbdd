"""CommercialPaper — the issue/move/redeem lifecycle contract.

Reference parity: finance/.../contracts/CommercialPaper.kt:1-236 (clause-based:
Issue checks maturity and issuer signature; Move preserves the paper and needs
the owner; Redeem needs maturity reached and the face value paid in cash to
the owner).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.contracts.amount import Amount
from ..core.contracts.clauses import (AnyOf, Clause, GroupClauseVerifier,
                                      verify_clause)
from ..core.contracts.exceptions import TransactionVerificationException
from ..core.contracts.structures import (CommandData, Contract, OwnableState,
                                         PartyAndReference, TypeOnlyCommandData)
from ..core.crypto.keys import PublicKey
from ..core.crypto.secure_hash import SecureHash
from ..core.serialization import register_type, serializable
from .cash import CashState


@serializable("CommercialPaper.Issue")
@dataclass(frozen=True)
class Issue(TypeOnlyCommandData):
    pass


@serializable("CommercialPaper.Move")
@dataclass(frozen=True)
class Move(TypeOnlyCommandData):
    pass


@serializable("CommercialPaper.Redeem")
@dataclass(frozen=True)
class Redeem(TypeOnlyCommandData):
    pass


@serializable("CommercialPaper.State")
@dataclass(frozen=True)
class CommercialPaperState(OwnableState):
    """A promise by `issuance.party` to pay `face_value` at `maturity_micros`
    (epoch microseconds — integer time, consensus-safe) to the current owner."""

    issuance: PartyAndReference
    owner: PublicKey
    face_value: Amount            # Amount[Issued[Currency]]
    maturity_micros: int

    @property
    def contract(self) -> "CommercialPaper":
        return CP_PROGRAM

    @property
    def participants(self):
        return [self.owner]

    def with_new_owner(self, new_owner: PublicKey):
        return (Move(), CommercialPaperState(
            self.issuance, new_owner, self.face_value, self.maturity_micros))

    def without_owner(self) -> "CommercialPaperState":
        """Owner-normalized copy for move-invariance comparison."""
        return CommercialPaperState(self.issuance, _NO_KEY, self.face_value,
                                    self.maturity_micros)


_NO_KEY = None  # sentinel inside without_owner comparisons


from ..core.contracts.structures import tx_time_micros as _tx_time_micros


class IssueClause(Clause):
    required_commands = (Issue,)

    def verify(self, tx, inputs, outputs, commands, key) -> set:
        cmds = [c for c in commands if isinstance(c.value, Issue)]
        if not cmds:
            return set()
        if inputs:
            raise TransactionVerificationException(
                tx.id, "An issuance must not consume existing paper")
        if len(outputs) != 1:
            raise TransactionVerificationException(
                tx.id, "An issuance must output exactly one paper state")
        paper = outputs[0]
        if paper.face_value.quantity <= 0:
            raise TransactionVerificationException(
                tx.id, "Paper face value must be positive")
        t = _tx_time_micros(tx)
        if t is None or paper.maturity_micros <= t:
            raise TransactionVerificationException(
                tx.id, "Paper must mature in the future of the issue time-window")
        issuer_key = paper.issuance.party.owning_key
        signers = {k for c in cmds for k in c.signers}
        if not issuer_key.is_fulfilled_by(signers):
            raise TransactionVerificationException(
                tx.id, "Issue command must be signed by the issuer")
        return {c.value for c in cmds}


class MoveClause(Clause):
    required_commands = (Move,)

    def verify(self, tx, inputs, outputs, commands, key) -> set:
        cmds = [c for c in commands if isinstance(c.value, Move)]
        if not cmds:
            return set()
        if len(inputs) != 1 or len(outputs) != 1:
            raise TransactionVerificationException(
                tx.id, "A paper move consumes one paper and outputs one paper")
        if inputs[0].without_owner() != outputs[0].without_owner():
            raise TransactionVerificationException(
                tx.id, "Paper terms must not change in a move")
        signers = {k for c in cmds for k in c.signers}
        if not inputs[0].owner.is_fulfilled_by(signers):
            raise TransactionVerificationException(
                tx.id, "Move command must be signed by the paper's owner")
        return {c.value for c in cmds}


class RedeemClause(Clause):
    required_commands = (Redeem,)

    def verify(self, tx, inputs, outputs, commands, key) -> set:
        cmds = [c for c in commands if isinstance(c.value, Redeem)]
        if not cmds:
            return set()
        if len(inputs) != 1 or outputs:
            raise TransactionVerificationException(
                tx.id, "A redemption consumes the paper and outputs no paper")
        paper = inputs[0]
        t = _tx_time_micros(tx)
        if t is None or t < paper.maturity_micros:
            raise TransactionVerificationException(
                tx.id, "Paper must have matured before redemption")
        paid = sum(o.amount.quantity for o in getattr(tx, "outputs", ())
                   if isinstance(o, CashState)
                   and o.owner == paper.owner
                   and o.amount.token == paper.face_value.token)
        if paid < paper.face_value.quantity:
            raise TransactionVerificationException(
                tx.id, "Redemption must pay the face value to the owner")
        signers = {k for c in cmds for k in c.signers}
        if not paper.owner.is_fulfilled_by(signers):
            raise TransactionVerificationException(
                tx.id, "Redeem command must be signed by the paper's owner")
        return {c.value for c in cmds}


class CPGroupClause(GroupClauseVerifier):
    def __init__(self):
        super().__init__(AnyOf(IssueClause(), MoveClause(), RedeemClause()))

    def group_states(self, tx):
        return tx.group_states(CommercialPaperState,
                               lambda s: (s.issuance, s.face_value.token,
                                          s.maturity_micros))


class CommercialPaper(Contract):
    legal_contract_reference = SecureHash.sha256(
        b"corda_tpu.finance.CommercialPaper: short-term debt instrument")

    Issue = Issue
    Move = Move
    Redeem = Redeem
    State = CommercialPaperState

    def verify(self, tx) -> None:
        cp_commands = [c for c in tx.commands
                       if isinstance(c.value, (Issue, Move, Redeem))]
        verify_clause(tx, CPGroupClause(), cp_commands)

    # -- builder helpers (CommercialPaper.kt generate* methods) --------------
    @staticmethod
    def generate_issue(builder, issuance: PartyAndReference, face_value: Amount,
                       maturity_micros: int, notary) -> None:
        builder.add_output_state(
            CommercialPaperState(issuance, issuance.party.owning_key,
                                 face_value, maturity_micros), notary)
        builder.add_command(Issue(), issuance.party.owning_key)

    @staticmethod
    def generate_move(builder, paper_ref, new_owner: PublicKey) -> None:
        builder.add_input_state(paper_ref)
        builder.add_output_state(
            paper_ref.state.data.with_new_owner(new_owner)[1],
            paper_ref.state.notary)
        builder.add_command(Move(), paper_ref.state.data.owner)


CP_PROGRAM = CommercialPaper()

register_type("CommercialPaper", CommercialPaper, to_fields=lambda c: [],
              from_fields=lambda f: CP_PROGRAM)
