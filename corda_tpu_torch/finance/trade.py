"""TwoPartyTradeFlow — atomic delivery-versus-payment.

Reference parity: finance/.../flows/TwoPartyTradeFlow.kt:1-206 — Seller offers
an asset for a cash price; Buyer resolves and inspects the asset, assembles
the swap transaction (asset→buyer leg + cash→seller leg), part-signs it and
returns it; Seller checks and signs, then notarises and broadcasts through
FinalityFlow. Either side walks away before signatures are exchanged and
nothing moves — the atomicity the reference's test suite drills (including
mid-flow node restarts, TwoPartyTradeFlowTests.kt:715).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core.contracts.amount import Amount
from ..core.serialization import register_type
from ..core.transactions.builder import TransactionBuilder
from ..core.transactions.signed import SignedTransaction
from ..flows.api import (FlowException, FlowLogic, Receive, Send,
                         SendAndReceive, initiated_by, initiating_flow)
from ..flows.library import FinalityFlow, ResolveTransactionsFlow
from .cash import Cash, CashState


@dataclass(frozen=True)
class SellerTradeInfo:
    """The seller's opening offer (TwoPartyTradeFlow.SellerTradeInfo)."""

    asset_for_sale: Any     # StateAndRef
    price: Amount           # Amount[Currency]
    seller_owner_key: Any   # PublicKey the cash leg must pay


register_type("trade.SellerTradeInfo", SellerTradeInfo)


@initiating_flow
class SellerFlow(FlowLogic):
    def __init__(self, buyer, asset_ref, price: Amount):
        self.buyer = buyer
        self.asset_ref = asset_ref
        self.price = price

    def call(self):
        hub = self.service_hub
        me = hub.my_info.legal_identity
        offer = SellerTradeInfo(self.asset_ref, self.price, me.owning_key)
        resp = yield SendAndReceive(self.buyer, offer, SignedTransaction)

        def validate(ptx):
            if not isinstance(ptx, SignedTransaction):
                raise FlowException("Expected the buyer's partial transaction")
            wtx = ptx.tx
            # our asset must be an input, and the cash leg must pay us in full
            if self.asset_ref.ref not in wtx.inputs:
                raise FlowException("Proposed transaction does not consume the asset")
            paid = sum(o.data.amount.quantity for o in wtx.outputs
                       if isinstance(o.data, CashState)
                       and o.data.owner == me.owning_key
                       and o.data.amount.token.product == self.price.token)
            if paid < self.price.quantity:
                raise FlowException(
                    f"Proposed transaction pays {paid}, price is "
                    f"{self.price.quantity}")
            # buyer must have signed already (their cash inputs demand it)
            ptx.check_signatures_are_valid()
            return ptx

        ptx = resp.unwrap(validate)
        # resolve the buyer's cash chain from the buyer before signing —
        # the seller finalises, so a validating notary resolves the swap's
        # FULL dependency graph from the seller (TwoPartyTradeFlow.kt's
        # SignTransactionFlow performs exactly this resolution)
        yield from self.sub_flow(ResolveTransactionsFlow(
            self.buyer, stx=ptx))
        stx = ptx.plus(hub.sign(ptx.id.bytes, me.owning_key))
        final = yield from self.sub_flow(FinalityFlow(stx, [self.buyer]))
        return final


@initiated_by(SellerFlow)
class BuyerFlow(FlowLogic):
    """Assembles the swap: asset to us, price in cash to the seller. Business
    acceptance policy lives in `check_offer` (override to be pickier)."""

    def __init__(self, seller):
        self.seller = seller

    def check_offer(self, info: SellerTradeInfo) -> None:
        """Override for price/asset acceptance checks; raise to refuse."""

    def call(self):
        hub = self.service_hub
        me = hub.my_info.legal_identity
        req = yield Receive(self.seller, SellerTradeInfo)
        info = req.unwrap(lambda r: r if isinstance(r, SellerTradeInfo)
                          else _refuse())
        self.check_offer(info)
        # resolve the asset's history from the seller before trusting it
        yield from self.sub_flow(ResolveTransactionsFlow(
            self.seller, tx_ids=[info.asset_for_sale.ref.txhash]))
        recorded = hub.storage.get_transaction(info.asset_for_sale.ref.txhash)
        if recorded is None:
            raise FlowException("Could not resolve the offered asset")
        asset_state = recorded.tx.outputs[info.asset_for_sale.ref.index]
        if asset_state != info.asset_for_sale.state:
            raise FlowException("Offered asset does not match the chain")

        stx = yield from self.record(lambda: self._assemble(info))
        yield Send(self.seller, stx)
        # seller finalises; wait for the notarised transaction to land
        final = yield from self.wait_for_ledger_commit(stx.id)
        return final

    def _assemble(self, info: SellerTradeInfo) -> SignedTransaction:
        hub = self.service_hub
        me = hub.my_info.legal_identity
        lock_id = self.run_id or "trade"
        coins = hub.vault.try_lock_states_for_spending(
            lock_id, info.price.quantity, CashState,
            quantity_of=lambda s: s.amount.quantity,
            state_filter=lambda s: s.amount.token.product == info.price.token)
        if not coins:
            raise FlowException(f"Insufficient cash to pay {info.price}")
        # (on any failure from here the state machine releases this flow's
        # soft locks at flow end — VaultSoftLockManager semantics)
        builder = TransactionBuilder()
        # asset leg
        builder.add_input_state(info.asset_for_sale)
        move_cmd, new_asset = info.asset_for_sale.state.data.with_new_owner(
            me.owning_key)
        builder.add_output_state(new_asset, info.asset_for_sale.state.notary)
        builder.add_command(move_cmd, info.asset_for_sale.state.data.owner)
        # cash leg
        Cash.generate_spend(builder, info.price, info.seller_owner_key, coins,
                            change_owner=me.owning_key)
        builder.sign_with(hub.key_management.key_pair(me.owning_key))
        return builder.to_signed_transaction(check_sufficient_signatures=False)


def _refuse():
    raise FlowException("Malformed trade offer")
