"""Universal contracts: a combinator DSL for generic financial agreements.

Reference parity: experimental (universal contracts) — UniversalContract.kt
(:1-327) and Perceivable.kt: instead of one bespoke contract class per
product, an *arrangement algebra* describes any cashflow agreement and ONE
contract verifies every transition of it:

- **Perceivables** — pure observations over a valuation context (time,
  oracle fixings): ``const``, arithmetic, comparisons, ``after(t)``,
  ``fixing(name)``. Deterministic: evaluation sees only the context.
- **Arrangements** — the agreement state machine: ``Zero`` (nothing owed),
  ``Transfer`` (an obligation to pay), ``All`` (conjunction), and
  ``Actions`` (named transitions, each with an authorized actor, a
  perceivable condition, and a continuation arrangement).
- **UniversalState/UniversalContract** — the single on-ledger state/contract
  pair: ``Issue`` requires every liable party's signature; ``Move(action)``
  requires the action's actor to sign, its condition to hold under the
  transaction's context (time-window midpoint + fixings carried by the
  command), and the outputs to equal the action's continuation.

The reference marks this experimental; the same caveat applies here.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass, field
from typing import Any

from ..core.contracts.exceptions import TransactionVerificationException
from ..core.contracts.structures import Contract, ContractState
from ..core.crypto.keys import PublicKey
from ..core.serialization import register_type, serializable


# ---------------------------------------------------------------------------
# Perceivables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ValuationContext:
    """What perceivables may see: the evaluation instant and oracle fixings
    (name → integer value; rates in basis points etc.)."""

    at: datetime.datetime
    fixings: dict = field(default_factory=dict)


class Perceivable:
    """A pure observation. Subclasses implement ``value(ctx)``."""

    def value(self, ctx: ValuationContext):
        raise NotImplementedError

    # arithmetic / comparison combinators
    def __add__(self, other):  return BinOp("+", self, lift(other))
    def __sub__(self, other):  return BinOp("-", self, lift(other))
    def __mul__(self, other):  return BinOp("*", self, lift(other))
    def gt(self, other):       return BinOp(">", self, lift(other))
    def ge(self, other):       return BinOp(">=", self, lift(other))
    def lt(self, other):       return BinOp("<", self, lift(other))
    def eq(self, other):       return BinOp("==", self, lift(other))
    def and_(self, other):     return BinOp("and", self, lift(other))
    def or_(self, other):      return BinOp("or", self, lift(other))


@serializable("universal.Const")
@dataclass(frozen=True)
class Const(Perceivable):
    v: Any

    def value(self, ctx):
        return self.v


@serializable("universal.BinOp")
@dataclass(frozen=True)
class BinOp(Perceivable):
    op: str
    left: Perceivable
    right: Perceivable

    def value(self, ctx):
        a, b = self.left.value(ctx), self.right.value(ctx)
        return {
            "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
            ">": lambda: a > b, ">=": lambda: a >= b, "<": lambda: a < b,
            "==": lambda: a == b, "and": lambda: bool(a) and bool(b),
            "or": lambda: bool(a) or bool(b),
        }[self.op]()


@serializable("universal.After")
@dataclass(frozen=True)
class After(Perceivable):
    """True once the valuation instant reaches ``instant`` (epoch micros)."""

    instant_micros: int

    def value(self, ctx):
        from ..core.serialization.codec import exact_epoch_micros
        return exact_epoch_micros(ctx.at) >= self.instant_micros


@serializable("universal.Fixing")
@dataclass(frozen=True)
class Fixing(Perceivable):
    """An oracle-observed value (rate fixing) by name; evaluation fails the
    transition when the context lacks it."""

    name: str

    def value(self, ctx):
        if self.name not in ctx.fixings:
            raise TransactionVerificationException(
                None, f"fixing {self.name!r} not provided")
        return ctx.fixings[self.name]


def lift(v) -> Perceivable:
    return v if isinstance(v, Perceivable) else Const(v)


def const(v) -> Perceivable:
    return Const(v)


def after(t: datetime.datetime) -> Perceivable:
    from ..core.serialization.codec import exact_epoch_micros
    return After(exact_epoch_micros(t))


def fixing(name: str) -> Perceivable:
    return Fixing(name)


# ---------------------------------------------------------------------------
# Arrangements
# ---------------------------------------------------------------------------

class Arrangement:
    def liable_parties(self) -> frozenset[PublicKey]:
        """Keys with obligations anywhere in the arrangement (must sign
        issuance)."""
        return frozenset()


@serializable("universal.Zero")
@dataclass(frozen=True)
class Zero(Arrangement):
    """Nothing owed — the terminal arrangement."""


@serializable("universal.Transfer")
@dataclass(frozen=True)
class Transfer(Arrangement):
    """An obligation: ``frm`` owes ``amount`` (a perceivable or int, in
    integer token units) of ``token`` to ``to``."""

    amount: Any           # Perceivable | int
    token: str
    frm: PublicKey
    to: PublicKey

    def liable_parties(self):
        return frozenset((self.frm,))


@serializable("universal.All")
@dataclass(frozen=True)
class All(Arrangement):
    parts: tuple

    def liable_parties(self):
        out = frozenset()
        for p in self.parts:
            out |= p.liable_parties()
        return out


@serializable("universal.Action")
@dataclass(frozen=True)
class Action:
    """A named transition: ``actor`` may move the agreement to ``next`` when
    ``condition`` holds."""

    actor: PublicKey
    condition: Perceivable
    next: Arrangement


@serializable("universal.Actions", to_fields=lambda a: [sorted(a.table.items())],
              from_fields=lambda f: Actions(dict(f[0])))
@dataclass(frozen=True)
class Actions(Arrangement):
    table: dict   # name -> Action

    def liable_parties(self):
        out = frozenset()
        for act in self.table.values():
            out |= act.next.liable_parties()
        return out

    def __hash__(self):
        return hash(tuple(sorted(self.table)))


# ---------------------------------------------------------------------------
# The single state/contract pair
# ---------------------------------------------------------------------------

@serializable("universal.UniversalState")
@dataclass(frozen=True)
class UniversalState(ContractState):
    arrangement: Arrangement
    parties: tuple    # PublicKey... (everyone party to the agreement)

    @property
    def contract(self):
        return UniversalContract()

    @property
    def participants(self):
        return list(self.parties)

    def __hash__(self):
        return hash((type(self), self.parties))


@serializable("universal.Issue")
@dataclass(frozen=True)
class Issue:
    pass


@serializable("universal.Move",
              to_fields=lambda m: [m.action, sorted(m.fixings.items())],
              from_fields=lambda f: Move(f[0], dict(f[1])))
@dataclass(frozen=True)
class Move:
    """Exercise the named action; ``fixings`` carries the oracle context the
    condition may observe (attested upstream by the oracle flow)."""

    action: str
    fixings: dict = field(default_factory=dict)

    def __hash__(self):
        return hash((self.action, tuple(sorted(self.fixings.items()))))


class UniversalContract(Contract):
    """One verify() for every product expressible in the algebra
    (UniversalContract.kt verify semantics)."""

    def verify(self, tx) -> None:
        commands = [c for c in tx.commands
                    if isinstance(c.value, (Issue, Move))]
        if len(commands) != 1:
            raise TransactionVerificationException(
                tx.id, "exactly one universal-contract command required")
        cmd = commands[0]
        ins = [s for s in tx.inputs if isinstance(s, UniversalState)]
        outs = [s for s in tx.outputs if isinstance(s, UniversalState)]

        if isinstance(cmd.value, Issue):
            if ins or len(outs) != 1:
                raise TransactionVerificationException(
                    tx.id, "issuance: no universal inputs, one output")
            missing = outs[0].arrangement.liable_parties() - set(cmd.signers)
            if missing:
                raise TransactionVerificationException(
                    tx.id, "issuance must be signed by every liable party")
            return

        # Move
        if len(ins) != 1:
            raise TransactionVerificationException(
                tx.id, "move: exactly one universal input")
        arrangement = ins[0].arrangement
        if not isinstance(arrangement, Actions):
            raise TransactionVerificationException(
                tx.id, "input arrangement offers no actions")
        action = arrangement.table.get(cmd.value.action)
        if action is None:
            raise TransactionVerificationException(
                tx.id, f"no action {cmd.value.action!r} in the arrangement")
        if action.actor not in set(cmd.signers):
            raise TransactionVerificationException(
                tx.id, f"action {cmd.value.action!r} must be signed by its actor")
        if tx.time_window is None or tx.time_window.midpoint is None:
            raise TransactionVerificationException(
                tx.id, "move requires a time-window (the valuation instant)")
        ctx = ValuationContext(tx.time_window.midpoint,
                               dict(cmd.value.fixings))
        if not action.condition.value(ctx):
            raise TransactionVerificationException(
                tx.id, f"condition for {cmd.value.action!r} does not hold")
        expected = action.next
        if isinstance(expected, Zero):
            if outs:
                raise TransactionVerificationException(
                    tx.id, "continuation is Zero: no universal output allowed")
        else:
            if len(outs) != 1 or outs[0].arrangement != expected:
                raise TransactionVerificationException(
                    tx.id, "output must equal the action's continuation")
            if outs[0].parties != ins[0].parties:
                raise TransactionVerificationException(
                    tx.id, "parties to the agreement cannot change on a move")


register_type("universal.UniversalContract", UniversalContract,
              to_fields=lambda c: [], from_fields=lambda f: UniversalContract())
