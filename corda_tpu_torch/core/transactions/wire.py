"""WireTransaction — the serialized transaction format whose id is a Merkle root.

Reference parity: WireTransaction.kt:27-120 and MerkleTransaction.kt:16-60:
- ``available_components``: flattened inputs + attachments + outputs + commands,
  then notary (if present), each required signer, the type, the time-window.
- component leaf hash = SHA-256 of the component's canonical serialized bytes
  (``serialized_hash`` — the codec/Merkle coupling).
- ``id`` = root of the Merkle tree over those leaf hashes.

The bulk path (``batch_merkle.batch_roots``) computes the same trees on the
card (``corda_tpu_torch.ops.sha256.merkle_root``, kernel B6) — bit-exact
against this module.
"""
from __future__ import annotations

from functools import cached_property

from ..contracts.structures import Command, StateRef, TimeWindow, TransactionState
from ..contracts.transaction_types import TransactionType
from ..crypto.keys import PublicKey
from ..crypto.merkle import MerkleTree
from ..crypto.secure_hash import SecureHash
from ..identity import Party
from ..serialization import register_type, serialized_hash, serialize


class TraversableTransaction:
    """Iteration over the flattened components of a (possibly torn) transaction."""

    inputs: tuple[StateRef, ...]
    attachments: tuple[SecureHash, ...]
    outputs: tuple[TransactionState, ...]
    commands: tuple[Command, ...]
    notary: Party | None
    must_sign: tuple[PublicKey, ...]
    type: TransactionType | None
    time_window: TimeWindow | None

    @property
    def available_components(self) -> list:
        out: list = [*self.inputs, *self.attachments, *self.outputs, *self.commands]
        if self.notary is not None:
            out.append(self.notary)
        out.extend(self.must_sign)
        if self.type is not None:
            out.append(self.type)
        if self.time_window is not None:
            out.append(self.time_window)
        return out

    @property
    def available_component_hashes(self) -> list[SecureHash]:
        return [serialized_hash(c) for c in self.available_components]


class WireTransaction(TraversableTransaction):
    """Immutable wire form. All collections are tuples; order is significant and
    consensus-critical (it determines the id)."""

    def __init__(self, inputs=(), attachments=(), outputs=(), commands=(),
                 notary: Party | None = None, must_sign=(),
                 type: TransactionType | None = None,
                 time_window: TimeWindow | None = None):
        self.inputs = tuple(inputs)
        self.attachments = tuple(attachments)
        self.outputs = tuple(outputs)
        self.commands = tuple(commands)
        self.notary = notary
        self.must_sign = tuple(must_sign)
        self.type = type if type is not None else TransactionType.General
        self.time_window = time_window

    @cached_property
    def merkle_tree(self) -> MerkleTree:
        return MerkleTree.get_merkle_tree(self.available_component_hashes)

    @cached_property
    def id(self) -> SecureHash:
        return self.merkle_tree.hash

    @cached_property
    def serialized(self) -> bytes:
        return serialize(self)

    # -- resolution ---------------------------------------------------------
    def to_ledger_transaction(self, services) -> "LedgerTransaction":
        """Resolve StateRefs, attachment hashes and signer identities via the
        ServiceHub into a verifiable LedgerTransaction (WireTransaction.kt:76-108)."""
        from ..contracts.exceptions import (AttachmentResolutionException,
                                            TransactionResolutionException)
        from ..contracts.structures import AuthenticatedObject, StateAndRef
        from .ledger import LedgerTransaction

        resolved_inputs = []
        for ref in self.inputs:
            state = services.load_state(ref)
            if state is None:
                raise TransactionResolutionException(ref.txhash)
            resolved_inputs.append(StateAndRef(state, ref))
        resolved_attachments = []
        for att_id in self.attachments:
            att = services.attachments.open_attachment(att_id)
            if att is None:
                raise AttachmentResolutionException(att_id)
            resolved_attachments.append(att)
        auth_commands = []
        for cmd in self.commands:
            parties = services.identity_service.parties_from_keys(cmd.signers) \
                if hasattr(services, "identity_service") else ()
            auth_commands.append(AuthenticatedObject(
                signers=tuple(cmd.signers), signing_parties=tuple(parties),
                value=cmd.value))
        return LedgerTransaction(
            inputs=tuple(resolved_inputs), outputs=self.outputs,
            commands=tuple(auth_commands), attachments=tuple(resolved_attachments),
            id=self.id, notary=self.notary, must_sign=self.must_sign,
            type=self.type, time_window=self.time_window)

    # -- tear-offs ----------------------------------------------------------
    def build_filtered_transaction(self, predicate) -> "FilteredTransaction":
        from .filtered import FilteredTransaction
        return FilteredTransaction.build_filtered_transaction(self, predicate)

    # -- equality -----------------------------------------------------------
    def __eq__(self, other):
        return isinstance(other, WireTransaction) and self.id == other.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return (f"WireTransaction(id={self.id.prefix_chars()}, "
                f"{len(self.inputs)} in, {len(self.outputs)} out, "
                f"{len(self.commands)} cmd)")


register_type(
    "WireTransaction", WireTransaction,
    to_fields=lambda tx: [list(tx.inputs), list(tx.attachments), list(tx.outputs),
                          list(tx.commands), tx.notary, list(tx.must_sign), tx.type,
                          tx.time_window],
    from_fields=lambda f: WireTransaction(*f))
