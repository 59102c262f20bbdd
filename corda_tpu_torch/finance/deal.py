"""TwoPartyDealFlow — the generic two-party deal-entry protocol.

Reference parity: finance TwoPartyDealFlow.kt — Primary (the instigator)
sends a Handshake carrying the deal payload and answers the signature
request; Secondary validates the handshake, assembles the shared
transaction, signs, collects the primary's signature and finalises, then
reports the final id back. Subclass both sides and override the hooks
(``validate_handshake`` / ``assemble_shared_tx``) per deal type — the
reference's abstract Primary/Secondary split.

In this framework the primary's sign-responder half is the node-registered
SignTransactionFlow factory (sessions key by initiating flow name), so
``Primary.call`` is: send the handshake, then wait for the finalised
transaction to hit our ledger (the reference ends the same way: the
secondary sends the final tx hash back).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core.serialization import register_type
from ..flows.api import (FlowException, FlowLogic, Receive, Send,
                         WaitForLedgerCommit, initiating_flow)
from ..flows.library import CollectSignaturesFlow, FinalityFlow


@dataclass(frozen=True)
class Handshake:
    """The opening message (TwoPartyDealFlow.Handshake): the deal payload
    plus the primary's identity."""

    payload: Any
    primary_identity: Any     # Party


@dataclass(frozen=True)
class DealDone:
    tx_id: Any                # SecureHash of the finalised transaction


register_type("deal.Handshake", Handshake)
register_type("deal.DealDone", DealDone)


class TwoPartyDealFlow:
    """Namespace matching the reference object."""

    @initiating_flow
    class Primary(FlowLogic):
        """The deal instigator (TwoPartyDealFlow.Primary): sends the
        handshake, lets the node's SignTransactionFlow responder answer the
        secondary's signature collection, and waits for the finalised
        transaction to land on our ledger."""

        def __init__(self, other_party, payload):
            self.other_party = other_party
            self.payload = payload

        def call(self):
            me = self.service_hub.my_info.legal_identity
            yield Send(self.other_party, Handshake(self.payload, me))
            done = yield Receive(self.other_party, DealDone)
            tx_id = done.unwrap(lambda d: d.tx_id)
            stx = yield WaitForLedgerCommit(tx_id)
            self.validate_final(stx)
            return stx

        def validate_final(self, stx) -> None:
            """Override for deal-specific checks on the finalised tx."""

    class Secondary(FlowLogic):
        """The deal acceptor (TwoPartyDealFlow.Secondary): validate the
        handshake, assemble + sign the shared transaction, collect the
        primary's signature, finalise, and report the id back. Registered
        as the responder factory for the concrete Primary subclass."""

        def __init__(self, peer):
            self.peer = peer

        def call(self):
            msg = yield Receive(self.peer, Handshake)
            handshake = msg.unwrap(self._checked)
            ptx = self.assemble_shared_tx(handshake)
            stx = yield from self.sub_flow(CollectSignaturesFlow(ptx))
            final = yield from self.sub_flow(
                FinalityFlow(stx, [handshake.primary_identity]))
            yield Send(self.peer, DealDone(final.id))
            return final

        def _checked(self, handshake: Handshake) -> Handshake:
            if str(handshake.primary_identity.name) != \
                    str(getattr(self.peer, "name", self.peer)):
                raise FlowException(
                    "Handshake identity does not match the session peer")
            self.validate_handshake(handshake)
            return handshake

        # -- hooks (abstract in the reference) ------------------------------
        def validate_handshake(self, handshake: Handshake) -> None:
            """Override: reject unacceptable proposals (raise FlowException)."""

        def assemble_shared_tx(self, handshake: Handshake):
            """Override: build + self-sign the deal transaction; return the
            partially-signed SignedTransaction."""
            raise NotImplementedError
