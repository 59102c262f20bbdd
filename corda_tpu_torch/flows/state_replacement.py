"""State-replacement flows: notary change (and the acceptor protocol shape
contract upgrades share).

Reference parity: AbstractStateReplacementFlow + NotaryChangeFlow
(core/flows/AbstractStateReplacementFlow.kt, NotaryChangeFlow.kt): the
instigator builds a NotaryChange transaction (same state, new notary),
part-signs and sends the proposal to every other participant; each acceptor
verifies the proposal really is a pure notary change for a state it knows,
countersigns; the instigator notarises with the OLD notary (which releases
the states from its commit log domain) and finalises to everyone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core.contracts.structures import StateAndRef, StateRef, TransactionState
from ..core.contracts.transaction_types import TransactionType
from ..core.crypto.signatures import DigitalSignatureWithKey
from ..core.serialization import register_type
from ..core.transactions.signed import SignedTransaction
from ..core.transactions.wire import WireTransaction
from .api import (FlowException, FlowLogic, Receive, Send, SendAndReceive,
                  initiating_flow)
from .library import FinalityFlow, NotaryFlow, _party_by_key


@dataclass(frozen=True)
class ReplacementProposal:
    """stx: the part-signed replacement; ref: which state is being replaced."""

    stx: Any
    ref: Any        # StateRef


register_type("flows.ReplacementProposal", ReplacementProposal)


class StateReplacementException(FlowException):
    pass


@initiating_flow
class NotaryChangeFlow(FlowLogic):
    """Instigator side (NotaryChangeFlow.Instigator)."""

    def __init__(self, state_and_ref: StateAndRef, new_notary):
        self.state_and_ref = state_and_ref
        self.new_notary = new_notary

    def call(self):
        hub = self.service_hub
        me = hub.my_info.legal_identity
        old_state = self.state_and_ref.state
        if old_state.notary == self.new_notary:
            raise StateReplacementException(
                "The new notary is the same as the current one")
        wtx = WireTransaction(
            inputs=(self.state_and_ref.ref,),
            outputs=(TransactionState(old_state.data, self.new_notary,
                                      old_state.encumbrance),),
            commands=(),
            notary=old_state.notary,
            must_sign=tuple(sorted(
                {getattr(p, "owning_key", p)
                 for p in old_state.data.participants}
                | {old_state.notary.owning_key})),
            type=TransactionType.NotaryChange)
        stx = hub.sign_initial_transaction(wtx)

        # collect acceptances from every OTHER participant
        our_keys = hub.key_management.keys
        for key in {getattr(p, "owning_key", p)
                    for p in old_state.data.participants}:
            if any(leaf in our_keys for leaf in key.keys):
                continue
            party = _party_by_key(hub, key)
            if party is None:
                raise StateReplacementException(
                    f"No well-known party for participant "
                    f"{key.to_string_short()}")
            resp = yield SendAndReceive(
                party, ReplacementProposal(stx, self.state_and_ref.ref),
                DigitalSignatureWithKey)

            def validate(sig, _key=key):
                sig.verify(stx.id.bytes)
                if not _key.is_fulfilled_by({sig.by}):
                    raise StateReplacementException(
                        "Acceptance signed by an unexpected key")
                return sig

            stx = stx.plus(resp.unwrap(validate))

        # FinalityFlow notarises with the OLD notary, records and broadcasts
        # (one consensus round — the reference Instigator does the same)
        participants = [
            p for p in (_party_by_key(hub, getattr(q, "owning_key", q))
                        for q in old_state.data.participants) if p is not None]
        final = yield from self.sub_flow(FinalityFlow(stx, participants))
        return StateAndRef(final.tx.outputs[0], StateRef(final.id, 0))


class NotaryChangeAcceptor(FlowLogic):
    """Acceptor side (AbstractStateReplacementFlow.Acceptor): verify the
    proposal is a pure notary change of a state we recognise, then sign."""

    def __init__(self, peer):
        self.peer = peer

    def call(self):
        req = yield Receive(self.peer, ReplacementProposal)
        proposal = req.unwrap(
            lambda r: r if isinstance(r, ReplacementProposal) else _refuse())
        stx: SignedTransaction = proposal.stx
        wtx = stx.tx
        if wtx.type != TransactionType.NotaryChange:
            raise StateReplacementException(
                "Proposal is not a notary-change transaction")
        if len(wtx.inputs) != 1 or len(wtx.outputs) != 1:
            raise StateReplacementException(
                "Notary change must replace exactly one state")
        if wtx.inputs[0] != proposal.ref:
            raise StateReplacementException("Proposal input mismatch")
        # the state's DATA must be untouched; only the notary moves
        hub = self.service_hub
        known = hub.load_state(proposal.ref)
        if known is None:
            raise StateReplacementException(
                "We do not know the state being replaced")
        if wtx.outputs[0].data != known.data:
            raise StateReplacementException(
                "Proposal alters the state, not just the notary")
        if wtx.outputs[0].notary == known.notary:
            raise StateReplacementException("Notary did not change")
        stx.check_signatures_are_valid()
        our_key = next(
            (leaf for k in wtx.must_sign for leaf in k.keys
             if leaf in hub.key_management.keys), None)
        if our_key is None:
            raise StateReplacementException(
                "Proposal does not require our signature")
        sig = hub.key_management.sign(stx.id.bytes, our_key)
        yield Send(self.peer, sig)
        return None


def _refuse():
    raise StateReplacementException("Malformed replacement proposal")


def install_notary_change_acceptor(smm) -> None:
    """Register the acceptor (nodes opt in, as with other core handlers)."""
    from .api import flow_name
    smm.register_flow_factory(flow_name(NotaryChangeFlow),
                              NotaryChangeAcceptor)
