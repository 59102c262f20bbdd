"""TransactionBuilder — mutable collector producing WireTransactions.

Reference parity: TransactionBuilder.kt:1-207 (+ the type-specific builders in
TransactionTypes.kt): add states/commands/attachments, auto-collect required
signer keys, sign, and freeze to wire form.
"""
from __future__ import annotations

from ..contracts.structures import (Attachment, Command, CommandData, StateAndRef,
                                    StateRef, TimeWindow, TransactionState)
from ..contracts.transaction_types import TransactionType
from ..crypto.keys import KeyPair, PublicKey
from ..crypto.secure_hash import SecureHash
from ..crypto.signatures import Crypto, DigitalSignatureWithKey
from ..identity import Party
from .signed import SignedTransaction
from .wire import WireTransaction


class TransactionBuilder:
    def __init__(self, type: TransactionType | None = None,
                 notary: Party | None = None):
        self.type = type if type is not None else TransactionType.General
        self.notary = notary
        self.inputs: list[StateRef] = []
        self.attachments: list[SecureHash] = []
        self.outputs: list[TransactionState] = []
        self.commands: list[Command] = []
        self.signers: set[PublicKey] = set()
        self.time_window: TimeWindow | None = None
        self._current_sigs: list[DigitalSignatureWithKey] = []

    # -- adding components ---------------------------------------------------
    def with_items(self, *items) -> "TransactionBuilder":
        for item in items:
            if isinstance(item, StateAndRef):
                self.add_input_state(item)
            elif isinstance(item, TransactionState):
                self.add_output_state(item)
            elif isinstance(item, SecureHash):
                self.add_attachment(item)
            elif isinstance(item, Command):
                self.add_command(item)
            elif isinstance(item, TimeWindow):
                self.set_time_window(item)
            else:
                raise ValueError(f"Wrong argument type: {type(item)!r}")
        return self

    def add_input_state(self, state_and_ref: StateAndRef) -> "TransactionBuilder":
        self._check_not_signed()
        notary = state_and_ref.state.notary
        if self.notary is None:
            # Adopt the first input's notary (reference TransactionBuilder behavior)
            # so mismatches surface here, not later at ledger verification.
            self.notary = notary
        elif notary != self.notary:
            raise ValueError(
                f"Input state requires notary {notary} which differs from the "
                f"transaction's notary {self.notary}")
        if self.type == TransactionType.NotaryChange:
            # NotaryChange builders auto-add all participants as signers
            # (TransactionTypes.kt NotaryChange.Builder).
            for p in state_and_ref.state.data.participants:
                self.signers.add(getattr(p, "owning_key", p))
        self.signers.add(notary.owning_key)
        self.inputs.append(state_and_ref.ref)
        return self

    def add_output_state(self, state, notary: Party | None = None,
                         encumbrance: int | None = None) -> "TransactionBuilder":
        self._check_not_signed()
        if isinstance(state, TransactionState):
            self.outputs.append(state)
        else:
            notary = notary or self.notary
            if notary is None:
                raise ValueError("Need a notary to add a raw output state")
            self.outputs.append(TransactionState(state, notary, encumbrance))
        return self

    def add_command(self, command_or_data, *keys: PublicKey) -> "TransactionBuilder":
        self._check_not_signed()
        if isinstance(command_or_data, Command):
            cmd = command_or_data
        else:
            cmd = Command(command_or_data, tuple(keys))
        self.signers.update(cmd.signers)
        self.commands.append(cmd)
        return self

    def add_attachment(self, attachment_id: SecureHash) -> "TransactionBuilder":
        self._check_not_signed()
        self.attachments.append(attachment_id)
        return self

    def set_time_window(self, time_window: TimeWindow) -> "TransactionBuilder":
        self._check_not_signed()
        if self.notary is None:
            raise ValueError("Only notarised transactions can have a time-window")
        self.time_window = time_window
        return self

    # -- signing / freezing --------------------------------------------------
    def to_wire_transaction(self) -> WireTransaction:
        return WireTransaction(
            inputs=tuple(self.inputs), attachments=tuple(self.attachments),
            outputs=tuple(self.outputs), commands=tuple(self.commands),
            notary=self.notary, must_sign=tuple(sorted(self.signers)),
            type=self.type, time_window=self.time_window)

    def sign_with(self, key_pair: KeyPair) -> "TransactionBuilder":
        wtx = self.to_wire_transaction()
        self._current_sigs.append(Crypto.sign_with_key(key_pair, wtx.id.bytes))
        return self

    def to_signed_transaction(self, check_sufficient_signatures: bool = True) -> SignedTransaction:
        if not self._current_sigs:
            raise ValueError("No signatures collected; call sign_with first")
        stx = SignedTransaction.of(self.to_wire_transaction(), tuple(self._current_sigs))
        if check_sufficient_signatures:
            stx.verify_signatures()
        return stx

    def _check_not_signed(self):
        if self._current_sigs:
            raise ValueError(
                "Adding components to a transaction after it's been signed "
                "would invalidate the signatures")
