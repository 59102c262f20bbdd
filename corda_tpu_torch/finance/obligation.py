"""Obligation — bilateral debt with settlement, netting and default.

Reference parity: finance/.../contracts/Obligation.kt:1-727, scoped to its
core semantics:

- `ObligationState(obligor, template, quantity, beneficiary)` — obligor owes
  beneficiary `quantity` of the template's product by the due time.
- Issue: creates debt, signed by the obligor (you can only bind yourself).
- Move: transfers the claim to a new beneficiary, signed by the current one;
  per-group conservation.
- Settle: extinguishes debt against cash actually paid to the beneficiary in
  the same transaction.
- Net: obligations in OPPOSITE directions on the same template cancel —
  the pairwise net position is preserved, everyone involved signs
  (the bilateral netting Obligation.kt:360+ implements).
- SetLifecycle: flips NORMAL <-> DEFAULTED after the due time, at the
  beneficiary's signature.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

from ..core.contracts.amount import Amount
from ..core.contracts.clauses import (AnyOf, Clause, GroupClauseVerifier,
                                      verify_clause)
from ..core.contracts.exceptions import TransactionVerificationException
from ..core.contracts.structures import (CommandData, Contract, Issued,
                                         TypeOnlyCommandData)
from ..core.crypto.keys import PublicKey
from ..core.crypto.secure_hash import SecureHash
from ..core.serialization import register_type, serializable
from .cash import CashState


@serializable("Obligation.Lifecycle")
class Lifecycle(enum.Enum):
    NORMAL = "NORMAL"
    DEFAULTED = "DEFAULTED"


@serializable("Obligation.Terms")
@dataclass(frozen=True)
class Terms:
    """What is owed and by when (Obligation.Terms): the acceptable settlement
    token and the due time (epoch micros)."""

    product: object          # Issued[Currency]
    due_before_micros: int


@serializable("Obligation.Issue")
@dataclass(frozen=True)
class Issue(TypeOnlyCommandData):
    pass


@serializable("Obligation.Move")
@dataclass(frozen=True)
class Move(TypeOnlyCommandData):
    pass


@serializable("Obligation.Settle")
@dataclass(frozen=True)
class Settle(CommandData):
    amount_quantity: int


@serializable("Obligation.Net")
@dataclass(frozen=True)
class Net(TypeOnlyCommandData):
    pass


@serializable("Obligation.SetLifecycle")
@dataclass(frozen=True)
class SetLifecycle(CommandData):
    lifecycle: Lifecycle


@serializable("Obligation.State")
@dataclass(frozen=True)
class ObligationState:
    obligor: PublicKey
    template: Terms
    quantity: int
    beneficiary: PublicKey
    lifecycle: Lifecycle = Lifecycle.NORMAL

    @property
    def contract(self) -> "Obligation":
        return OBLIGATION_PROGRAM

    @property
    def participants(self):
        return [self.obligor, self.beneficiary]

    @property
    def amount(self) -> Amount:
        return Amount(self.quantity, self.template.product)

    def with_new_beneficiary(self, new_beneficiary: PublicKey):
        return (Move(), ObligationState(self.obligor, self.template,
                                        self.quantity, new_beneficiary,
                                        self.lifecycle))


def _pair_positions(states) -> dict:
    """(obligor, beneficiary) → total quantity. The netting invariant works
    on the antisymmetric difference of these."""
    out: dict = {}
    for s in states:
        key = (s.obligor, s.beneficiary)
        out[key] = out.get(key, 0) + s.quantity
    return out


def _net_positions(states) -> dict:
    """Unordered-pair → signed net quantity (a<b ordering fixes the sign)."""
    out: dict = {}
    for (obligor, beneficiary), qty in _pair_positions(states).items():
        a, b = sorted((obligor, beneficiary))
        sign = 1 if obligor == a else -1
        key = (a, b)
        out[key] = out.get(key, 0) + sign * qty
    return {k: v for k, v in out.items() if v != 0}


def _lifecycle_pair_positions(states) -> dict:
    """(obligor, beneficiary, lifecycle) → total quantity: the full identity
    of a claim. Clauses account per ENTRY so no state's debtor, creditor or
    default status can silently change under an unrelated command."""
    out: dict = {}
    for s in states:
        key = (s.obligor, s.beneficiary, s.lifecycle)
        out[key] = out.get(key, 0) + s.quantity
    return out


class IssueClause(Clause):
    required_commands = (Issue,)

    def verify(self, tx, inputs, outputs, commands, key) -> set:
        cmds = [c for c in commands if isinstance(c.value, Issue)]
        if not cmds:
            return set()
        in_pos = _lifecycle_pair_positions(inputs)
        out_pos = _lifecycle_pair_positions(outputs)
        signers = {k for c in cmds for k in c.signers}
        increased = False
        # per-claim accounting: nothing may shrink (that would destroy someone
        # else's claim); growth needs that claim's obligor signature
        for entry in set(in_pos) | set(out_pos):
            delta = out_pos.get(entry, 0) - in_pos.get(entry, 0)
            if delta < 0:
                raise TransactionVerificationException(
                    tx.id, "An issuance may not reduce any existing claim")
            if delta > 0:
                increased = True
                obligor, _, lifecycle = entry
                if lifecycle != Lifecycle.NORMAL:
                    raise TransactionVerificationException(
                        tx.id, "New debt must be issued in the NORMAL lifecycle")
                if not obligor.is_fulfilled_by(signers):
                    raise TransactionVerificationException(
                        tx.id, "Issue must be signed by the obligor "
                               "(only you can bind yourself into debt)")
        if not increased:
            raise TransactionVerificationException(
                tx.id, "An obligation issuance must increase the amount owed")
        return {c.value for c in cmds}


class MoveClause(Clause):
    required_commands = (Move,)

    def verify(self, tx, inputs, outputs, commands, key) -> set:
        cmds = [c for c in commands if isinstance(c.value, Move)]
        if not cmds:
            return set()
        # per (obligor, lifecycle): only the beneficiary column may change —
        # a move can neither change who owes nor flip defaults
        def by_obligor_lifecycle(states):
            out: dict = {}
            for s in states:
                k = (s.obligor, s.lifecycle)
                out[k] = out.get(k, 0) + s.quantity
            return out

        if by_obligor_lifecycle(inputs) != by_obligor_lifecycle(outputs):
            raise TransactionVerificationException(
                tx.id, "A move may not change who owes the debt, its amount, "
                       "or its lifecycle")
        signers = {k for c in cmds for k in c.signers}
        for s in inputs:
            if not s.beneficiary.is_fulfilled_by(signers):
                raise TransactionVerificationException(
                    tx.id, "Move must be signed by the current beneficiary")
        return {c.value for c in cmds}


class SettleClause(Clause):
    required_commands = (Settle,)

    def verify(self, tx, inputs, outputs, commands, key) -> set:
        cmds = [c for c in commands if isinstance(c.value, Settle)]
        if not cmds:
            return set()
        settled = sum(c.value.amount_quantity for c in cmds)
        in_pos = _lifecycle_pair_positions(inputs)
        out_pos = _lifecycle_pair_positions(outputs)
        reductions: dict = {}
        for entry in set(in_pos) | set(out_pos):
            delta = in_pos.get(entry, 0) - out_pos.get(entry, 0)
            if delta < 0:
                raise TransactionVerificationException(
                    tx.id, "A settlement may not create new claims")
            if delta > 0:
                reductions[entry] = delta
        if sum(reductions.values()) != settled:
            raise TransactionVerificationException(
                tx.id, f"Settlement amounts must balance: reductions "
                       f"{sum(reductions.values())} vs {settled} declared")
        signers = {k for c in cmds for k in c.signers}
        for (obligor, _, _) in reductions:
            if not obligor.is_fulfilled_by(signers):
                raise TransactionVerificationException(
                    tx.id, "Settle must be signed by the obligor")
        # per-beneficiary cash adequacy is checked GLOBALLY across groups in
        # Obligation.verify (one cash output can't double-count, and
        # multi-beneficiary settlements are judged jointly)
        return {c.value for c in cmds}


class NetClause(Clause):
    required_commands = (Net,)

    def verify(self, tx, inputs, outputs, commands, key) -> set:
        cmds = [c for c in commands if isinstance(c.value, Net)]
        if not cmds:
            return set()
        if _net_positions(inputs) != _net_positions(outputs):
            raise TransactionVerificationException(
                tx.id, "Netting must preserve every pairwise net position")
        signers = {k for c in cmds for k in c.signers}
        # consent from everyone whose claims appear on EITHER side — a
        # zero-net pair of fabricated opposite obligations still binds its
        # parties (default exposure) and needs their signatures
        involved = {p for s in list(inputs) + list(outputs)
                    for p in (s.obligor, s.beneficiary)}
        for party_key in involved:
            if not party_key.is_fulfilled_by(signers):
                raise TransactionVerificationException(
                    tx.id, "Netting requires signatures from every party "
                           "whose obligations are netted")
        return {c.value for c in cmds}


class SetLifecycleClause(Clause):
    required_commands = (SetLifecycle,)

    def verify(self, tx, inputs, outputs, commands, key) -> set:
        cmds = [c for c in commands if isinstance(c.value, SetLifecycle)]
        if not cmds:
            return set()
        if len(inputs) != len(outputs):
            raise TransactionVerificationException(
                tx.id, "Lifecycle changes must keep every obligation")
        target = cmds[0].value.lifecycle
        from ..core.contracts.structures import tx_time_micros
        t = tx_time_micros(tx)
        for inp, out in zip(sorted(inputs, key=repr),
                            sorted(outputs, key=repr)):
            unchanged = ObligationState(inp.obligor, inp.template,
                                        inp.quantity, inp.beneficiary, target)
            if out != unchanged:
                raise TransactionVerificationException(
                    tx.id, "Lifecycle change must alter only the lifecycle")
            if target == Lifecycle.DEFAULTED:
                if t is None or t < inp.template.due_before_micros:
                    raise TransactionVerificationException(
                        tx.id, "Cannot default an obligation before it is due")
        signers = {k for c in cmds for k in c.signers}
        for s in inputs:
            if not s.beneficiary.is_fulfilled_by(signers):
                raise TransactionVerificationException(
                    tx.id, "Lifecycle change must be signed by the beneficiary")
        return {c.value for c in cmds}


class ObligationGroupClause(GroupClauseVerifier):
    def __init__(self):
        super().__init__(AnyOf(IssueClause(), MoveClause(), SettleClause(),
                               NetClause(), SetLifecycleClause()))

    def group_states(self, tx):
        return tx.group_states(ObligationState, lambda s: s.template)


class Obligation(Contract):
    legal_contract_reference = SecureHash.sha256(
        b"corda_tpu.finance.Obligation: bilateral nettable debt")

    Issue = Issue
    Move = Move
    Settle = Settle
    Net = Net
    SetLifecycle = SetLifecycle
    State = ObligationState
    Lifecycle = Lifecycle
    Terms = Terms

    def verify(self, tx) -> None:
        ob_commands = [c for c in tx.commands
                       if isinstance(c.value, (Issue, Move, Settle, Net,
                                               SetLifecycle))]
        if any(isinstance(c.value, Settle) for c in ob_commands):
            self._verify_settlement_cash(tx)
        verify_clause(tx, ObligationGroupClause(), ob_commands)

    @staticmethod
    def _verify_settlement_cash(tx) -> None:
        """Global cash adequacy: for every (beneficiary, product), the cash
        paid must cover the TOTAL debt reduction across all obligation groups
        — per-group checks would let one cash output double-count against
        obligations under different terms (same product, different due dates),
        and would wrongly reject multi-beneficiary settlements."""
        reduced: dict = {}
        for s in tx.inputs:
            if isinstance(s, ObligationState):
                k = (s.beneficiary, s.template.product)
                reduced[k] = reduced.get(k, 0) + s.quantity
        for s in tx.outputs:
            if isinstance(s, ObligationState):
                k = (s.beneficiary, s.template.product)
                reduced[k] = reduced.get(k, 0) - s.quantity
        for (beneficiary, product), owed_drop in reduced.items():
            if owed_drop <= 0:
                continue
            paid = sum(o.amount.quantity for o in tx.outputs
                       if isinstance(o, CashState)
                       and o.owner == beneficiary
                       and o.amount.token == product)
            if paid < owed_drop:
                raise TransactionVerificationException(
                    tx.id, f"Settlement must pay the beneficiary in the "
                           f"obligation's product ({paid} paid vs "
                           f"{owed_drop} extinguished)")


OBLIGATION_PROGRAM = Obligation()

register_type("Obligation", Obligation, to_fields=lambda c: [],
              from_fields=lambda f: OBLIGATION_PROGRAM)
