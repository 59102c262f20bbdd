"""Confidential identities: the transaction-key exchange flow.

Reference parity: TransactionKeyFlow (core flows, SURVEY.md §2.1 flow list)
— before building a transaction, counterparties swap FRESH one-time keys so
on-ledger states reference anonymous identities rather than well-known
ones. Each side proves ownership of its fresh key by signing it (plus its
X.500 name) with its well-known identity key; the peer validates the
attestation and records the mapping in its identity service
(registerAnonymousIdentity). Returns the {party: AnonymousParty} map both
sides agree on.
"""
from __future__ import annotations

from ..core.identity import AnonymousParty, Party
from .api import (FlowException, FlowLogic, Receive, Send, initiated_by,
                  initiating_flow)


def _exchange_payload(hub, anon_key):
    sig = hub.sign(
        hub.identity_service.ownership_content(
            anon_key, hub.my_info.legal_identity.name))
    return [anon_key, sig.bytes]


def _accept_payload(hub, peer: Party, payload) -> AnonymousParty:
    key, sig_bytes = payload
    anon = AnonymousParty(key)
    try:
        hub.identity_service.verify_and_register_anonymous(anon, peer,
                                                           sig_bytes)
    except Exception as e:
        raise FlowException(
            f"Invalid anonymous-identity attestation from {peer.name}: {e}")
    return anon


@initiating_flow
class TransactionKeyFlow(FlowLogic):
    """Initiator: send our fresh anonymous identity, receive the peer's."""

    def __init__(self, other_side: Party):
        self.other_side = other_side

    def call(self):
        hub = self.service_hub
        anon_key = yield from self.record(
            lambda: hub.key_management.fresh_key().public)
        yield Send(self.other_side, _exchange_payload(hub, anon_key))
        resp = yield Receive(self.other_side, list)
        theirs = _accept_payload(hub, self.other_side,
                                 resp.unwrap(lambda d: d))
        return {hub.my_info.legal_identity: AnonymousParty(anon_key),
                self.other_side: theirs}


@initiated_by(TransactionKeyFlow)
class TransactionKeyHandler(FlowLogic):
    """Responder: receive the initiator's identity, reply with ours."""

    def __init__(self, peer: Party):
        self.peer = peer

    def call(self):
        hub = self.service_hub
        req = yield Receive(self.peer, list)
        theirs = _accept_payload(hub, self.peer, req.unwrap(lambda d: d))
        anon_key = yield from self.record(
            lambda: hub.key_management.fresh_key().public)
        yield Send(self.peer, _exchange_payload(hub, anon_key))
        return {hub.my_info.legal_identity: AnonymousParty(anon_key),
                self.peer: theirs}
