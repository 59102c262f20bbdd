"""Clause framework: composable contract-verification combinators.

Reference parity: core/contracts/clauses/ (11 files) — `Clause` with
required-command matching, `AllOf`/`AnyOf`/`FirstOf` composition, and
`GroupClauseVerifier` applying clauses per in/out state group (the structure
the asset contracts — Cash, CommercialPaper, Obligation — are written in).
"""
from __future__ import annotations

from typing import Any

from .exceptions import TransactionVerificationException


class Clause:
    """One verification rule. Subclasses set `required_commands` (types) and
    implement `verify`, returning the set of command data they consumed."""

    required_commands: tuple[type, ...] = ()

    def matches(self, commands) -> bool:
        if not self.required_commands:
            return True
        present = {type(c.value) for c in commands}
        return all(any(issubclass(p, rc) for p in present)
                   for rc in self.required_commands)

    def get_execution_path(self, commands) -> list["Clause"]:
        return [self]

    def verify(self, tx, inputs, outputs, commands, grouping_key) -> set:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class CompositeClause(Clause):
    def __init__(self, *clauses: Clause):
        self.clauses = clauses

    def get_execution_path(self, commands) -> list[Clause]:
        out = []
        for c in self.clauses:
            out.extend(c.get_execution_path(commands))
        return out

    def __repr__(self):
        inner = ", ".join(repr(c) for c in self.clauses)
        return f"{type(self).__name__}({inner})"


class AllOf(CompositeClause):
    """Every member clause must match and verify (AllOf.kt)."""

    def matches(self, commands) -> bool:
        return all(c.matches(commands) for c in self.clauses)

    def verify(self, tx, inputs, outputs, commands, grouping_key) -> set:
        if not self.matches(commands):
            raise TransactionVerificationException(
                getattr(tx, "id", None), f"Required commands not present for {self}")
        matched = set()
        for clause in self.clauses:
            matched |= clause.verify(tx, inputs, outputs, commands, grouping_key)
        return matched


class AnyOf(CompositeClause):
    """One or more matching members run (AnyOf.kt)."""

    def matches(self, commands) -> bool:
        return any(c.matches(commands) for c in self.clauses)

    def verify(self, tx, inputs, outputs, commands, grouping_key) -> set:
        matched = set()
        ran = 0
        for clause in self.clauses:
            if clause.matches(commands):
                matched |= clause.verify(tx, inputs, outputs, commands, grouping_key)
                ran += 1
        if ran == 0:
            raise TransactionVerificationException(
                getattr(tx, "id", None), f"No matching clause in {self}")
        return matched


class FirstOf(CompositeClause):
    """The first matching member runs (FirstOf.kt / FirstComposition)."""

    def verify(self, tx, inputs, outputs, commands, grouping_key) -> set:
        for clause in self.clauses:
            if clause.matches(commands):
                return clause.verify(tx, inputs, outputs, commands, grouping_key)
        raise TransactionVerificationException(
            getattr(tx, "id", None), f"No matching clause in {self}")


class GroupClauseVerifier(Clause):
    """Applies an inner clause to each state group (GroupClauseVerifier.kt).
    Subclasses implement `group_states(tx)` returning InOutGroups."""

    def __init__(self, clause: Clause):
        self.clause = clause

    def group_states(self, tx):
        raise NotImplementedError

    def verify(self, tx, inputs, outputs, commands, grouping_key) -> set:
        matched = set()
        for group in self.group_states(tx):
            matched |= self.clause.verify(tx, group.inputs, group.outputs,
                                          commands, group.grouping_key)
        return matched


def verify_clause(tx, main_clause: Clause, commands) -> None:
    """Top-level driver (ClauseVerifier.kt verifyClause): run the clause tree
    over this contract's commands (the caller pre-filters to its own command
    types, as the reference's extractCommands does), then require every one of
    them to have been matched by some clause."""
    matched = main_clause.verify(tx, getattr(tx, "inputs", ()),
                                 getattr(tx, "outputs", ()), commands, None)
    unmatched = [c for c in commands if c.value not in matched]
    if unmatched:
        raise TransactionVerificationException(
            getattr(tx, "id", None),
            f"Commands not matched by any clause: {unmatched}")
