"""Ledger DSL — the declarative contract-unit-test language.

Reference parity: test-utils {LedgerDSLInterpreter, TransactionDSLInterpreter,
TestDSL}.kt — `ledger { transaction { input(...) output(...) command(...)
verifies() / fails_with("...") } }`, with labelled outputs resolvable as
later inputs and all built transactions resolved against the same in-memory
ledger. Pythonic form:

    with ledger(notary=NOTARY) as l:
        with l.transaction() as tx:
            tx.output("cash", CashState(...))
            tx.command(Cash.Issue(), issuer_key)
            tx.verifies()
        with l.transaction() as tx:
            tx.input("cash")
            tx.output("moved", CashState(...))
            tx.command(Cash.Move(), owner_key)
            tx.fails_with("owner")
"""
from __future__ import annotations

from ..core.contracts.exceptions import TransactionVerificationException
from ..core.contracts.structures import (Command, StateAndRef, StateRef,
                                         TransactionState)
from ..core.identity import Party
from ..core.transactions.wire import WireTransaction
from .services import MockServices


class DSLFailure(AssertionError):
    pass


class TransactionDSL:
    def __init__(self, ledger: "LedgerDSL"):
        self.ledger = ledger
        self._inputs: list[StateRef] = []
        self._outputs: list[tuple[str | None, TransactionState]] = []
        self._commands: list[Command] = []
        self._time_window = None
        self._attachments: list = []
        self._checked = False

    # -- components ----------------------------------------------------------
    def input(self, label_or_sar) -> "TransactionDSL":
        if isinstance(label_or_sar, str):
            sar = self.ledger.labelled(label_or_sar)
        else:
            sar = label_or_sar
        self._inputs.append(sar.ref)
        return self

    def output(self, label, state, notary: Party | None = None,
               encumbrance: int | None = None) -> "TransactionDSL":
        if not isinstance(state, TransactionState):
            state = TransactionState(state, notary or self.ledger.notary,
                                     encumbrance)
        self._outputs.append((label, state))
        return self

    def command(self, data, *keys) -> "TransactionDSL":
        self._commands.append(Command(data, tuple(keys)))
        return self

    def time_window(self, tw) -> "TransactionDSL":
        self._time_window = tw
        return self

    def attachment(self, att_id) -> "TransactionDSL":
        self._attachments.append(att_id)
        return self

    # -- building / checking -------------------------------------------------
    def _build(self) -> WireTransaction:
        signers = sorted({k for c in self._commands for k in c.signers}
                         | ({self.ledger.notary.owning_key}
                            if self._inputs else set()))
        return WireTransaction(
            inputs=tuple(self._inputs),
            attachments=tuple(self._attachments),
            outputs=tuple(s for _, s in self._outputs),
            commands=tuple(self._commands),
            notary=self.ledger.notary,
            must_sign=tuple(signers),
            time_window=self._time_window)

    def verifies(self) -> WireTransaction:
        """Assert the transaction passes platform + contract verification and
        record it on the ledger (its outputs become spendable)."""
        wtx = self._build()
        ltx = wtx.to_ledger_transaction(self.ledger.services)
        ltx.verify()
        self._checked = True
        self.ledger._record(wtx, [lbl for lbl, _ in self._outputs])
        return wtx

    def fails_with(self, message_fragment: str) -> None:
        """Assert verification fails with the fragment in the error
        (TestDSL `fails with`). Only VERIFICATION failures count — a crash of
        any other type (AttributeError in a broken clause, say) propagates,
        so a broken contract can't masquerade as a correctly-rejecting one."""
        wtx = self._build()
        self._checked = True
        try:
            wtx.to_ledger_transaction(self.ledger.services).verify()
        except TransactionVerificationException as e:
            if message_fragment.lower() not in str(e).lower():
                raise DSLFailure(
                    f"Expected failure containing {message_fragment!r}, got: "
                    f"{type(e).__name__}: {e}") from e
            return
        raise DSLFailure(
            f"Expected verification to fail with {message_fragment!r}, "
            f"but it passed")

    def fails(self) -> None:
        wtx = self._build()
        self._checked = True
        try:
            wtx.to_ledger_transaction(self.ledger.services).verify()
        except TransactionVerificationException:
            return
        raise DSLFailure("Expected verification to fail, but it passed")

    # -- context manager -----------------------------------------------------
    def __enter__(self) -> "TransactionDSL":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None and not self._checked:
            self.verifies()  # un-asserted transactions must at least verify
        return False


class LedgerDSL:
    def __init__(self, notary: Party, services: MockServices | None = None):
        self.notary = notary
        self.services = services if services is not None else MockServices()
        self._labels: dict[str, StateAndRef] = {}
        self.transactions: list[WireTransaction] = []

    def transaction(self) -> TransactionDSL:
        return TransactionDSL(self)

    def labelled(self, label: str) -> StateAndRef:
        if label not in self._labels:
            raise KeyError(f"No output labelled {label!r} on this ledger")
        return self._labels[label]

    def _record(self, wtx: WireTransaction, labels) -> None:
        self.transactions.append(wtx)
        for i, out in enumerate(wtx.outputs):
            ref = StateRef(wtx.id, i)
            self.services.add_state(ref, out)
            if labels[i] is not None:
                self._labels[labels[i]] = StateAndRef(out, ref)

    def __enter__(self) -> "LedgerDSL":
        return self

    def __exit__(self, *exc) -> bool:
        return False


def ledger(notary: Party, services: MockServices | None = None) -> LedgerDSL:
    return LedgerDSL(notary, services)
