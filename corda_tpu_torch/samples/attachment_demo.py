"""Attachment demo: upload a blob, reference it in a transaction, have the
counterparty fetch and verify it by hash.

Reference parity: samples/attachment-demo (AttachmentDemo.kt +
FetchAttachmentsFlow usage).

A copy of the reference's module; ``run_demo(device=...)`` (default "cuda",
raising without CUDA) hands its device to ``MockNetwork(device=)``.
"""
from __future__ import annotations

from ..core.transactions.builder import TransactionBuilder
from ..device import DEFAULT_DEVICE
from ..flows.api import FlowLogic, initiating_flow
from ..flows.library import FetchAttachmentsFlow, FinalityFlow
from ..testing import DummyContract, DummyState, MockNetwork


@initiating_flow
class SendAttachmentTx(FlowLogic):
    """Sender: finalise a transaction referencing the attachment, then tell
    the peer its id (the demo's prime-number document role)."""

    def __init__(self, peer, att_id, notary):
        self.peer = peer
        self.att_id = att_id
        self.notary = notary

    def call(self):
        hub = self.service_hub
        builder = TransactionBuilder(notary=self.notary)
        builder.add_output_state(DummyState(
            7, (hub.my_info.legal_identity.owning_key,
                self.peer.owning_key)))
        builder.add_command(DummyContract.Create(),
                           hub.my_info.legal_identity.owning_key)
        builder.add_attachment(self.att_id)
        stx = hub.sign_initial_transaction(builder.to_wire_transaction())
        final = yield from self.sub_flow(FinalityFlow(stx, [self.peer]))
        return final


@initiating_flow
class FetchAttachmentFromPeer(FlowLogic):
    def __init__(self, peer, att_id):
        self.peer = peer
        self.att_id = att_id

    def call(self):
        atts = yield from self.sub_flow(
            FetchAttachmentsFlow(self.peer, [self.att_id]))
        return atts[0]


def run_demo(document: bytes = b"the biggest prime under 100 is 97\n" * 100,
             device=DEFAULT_DEVICE):
    network = MockNetwork(device=device)
    notary = network.create_notary_node()
    sender = network.create_node("O=Sender, L=London, C=GB")
    receiver = network.create_node("O=Receiver, L=Paris, C=FR")
    network.start_nodes()

    att_id = sender.services.attachments.import_attachment(document)
    fsm = sender.start_flow(SendAttachmentTx(receiver.party, att_id,
                                             notary.party))
    network.run_network()
    final = fsm.result_future.result(timeout=5)
    assert att_id in final.tx.attachments

    # the receiver pulls the attachment content from the sender by hash
    fsm = receiver.start_flow(FetchAttachmentFromPeer(sender.party, att_id))
    network.run_network()
    att = fsm.result_future.result(timeout=5)
    return {"network": network, "att_id": att_id, "attachment": att,
            "document": document, "receiver": receiver, "final": final}


def main() -> None:
    out = run_demo()
    ok = out["attachment"].data == out["document"]
    print(f"attachment {out['att_id'].prefix_chars()} transferred and "
          f"hash-verified: {ok}")


if __name__ == "__main__":
    main()
