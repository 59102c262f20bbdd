"""Trader demo: bank funds a buyer; a seller issues commercial paper; the two
trade it for cash via the atomic DvP flow.

Reference parity: samples/trader-demo (TraderDemo.kt:15-52,
TraderDemoClientApi.kt:28-64 — the BASELINE config-1 scenario). Runs fully
in-process over MockNetwork; `python -m corda_tpu_torch.samples.trader_demo`
prints the resulting ledgers.

A copy of the reference's module; ``run_demo(device=...)`` (default "cuda",
raising without CUDA) hands its device to ``MockNetwork(device=)``.
"""
from __future__ import annotations

import datetime

from ..core.contracts.amount import Amount, USD
from ..core.contracts.structures import (PartyAndReference, StateAndRef,
                                         StateRef, TimeWindow)
from ..core.serialization.codec import exact_epoch_micros
from ..core.transactions.builder import TransactionBuilder
from ..device import DEFAULT_DEVICE
from ..finance import CashIssueFlow, CashState
from ..finance.commercial_paper import CommercialPaper, CommercialPaperState
from ..finance.trade import SellerFlow
from ..flows.library import FinalityFlow
from ..testing import MockNetwork


def dollars(n: int) -> Amount:
    return Amount(n * 100, USD)


def issue_paper(network, seller, notary, face_value, maturity_days=30):
    """Seller self-issues commercial paper (TraderDemoClientApi.runSeller)."""
    from ..core.contracts.structures import Issued
    me = seller.party
    now = datetime.datetime.now(datetime.timezone.utc)
    maturity = exact_epoch_micros(now + datetime.timedelta(days=maturity_days))
    builder = TransactionBuilder(notary=notary.party)
    issued = Amount(face_value.quantity,
                    Issued(PartyAndReference(me, b"\x01"), face_value.token))
    CommercialPaper.generate_issue(
        builder, PartyAndReference(me, b"\x01"), issued, maturity, notary.party)
    builder.set_time_window(TimeWindow.with_tolerance(
        now, datetime.timedelta(seconds=30)))
    builder.sign_with(seller.services.key_management.key_pair(me.owning_key))
    stx = builder.to_signed_transaction(check_sufficient_signatures=False)
    fsm = seller.start_flow(FinalityFlow(stx))
    network.run_network()
    final = fsm.result_future.result(timeout=5)
    return StateAndRef(final.tx.outputs[0], StateRef(final.id, 0))


def run_demo(price_dollars: int = 1000, face_dollars: int = 1100,
             device=DEFAULT_DEVICE):
    network = MockNetwork(device=device)
    notary = network.create_notary_node()
    bank = network.create_node("O=BankOfCorda, L=London, C=GB")
    buyer = network.create_node("O=Bank A, L=London, C=GB")
    seller = network.create_node("O=Bank B, L=New York, C=US")
    network.start_nodes()

    # 1. bank issues cash to the buyer
    fsm = bank.start_flow(CashIssueFlow(dollars(price_dollars + 200), b"\x01",
                                        buyer.party, notary.party))
    network.run_network()
    fsm.result_future.result(timeout=5)

    # 2. seller issues $face commercial paper to itself
    paper_ref = issue_paper(network, seller, notary, dollars(face_dollars))

    # 3. the trade: seller offers the paper to the buyer for $price
    fsm = seller.start_flow(SellerFlow(buyer.party, paper_ref,
                                       dollars(price_dollars)))
    network.run_network()
    final = fsm.result_future.result(timeout=5)

    return {
        "network": network,
        "final": final,
        "buyer_paper": buyer.services.vault.unconsumed_states(CommercialPaperState),
        "seller_cash": seller.services.vault.unconsumed_states(CashState),
        "buyer_cash": buyer.services.vault.unconsumed_states(CashState),
        "buyer": buyer, "seller": seller, "bank": bank, "notary": notary,
    }


def main() -> None:
    out = run_demo()
    final = out["final"]
    print(f"Trade settled in {final.id.prefix_chars()} with "
          f"{len(final.sigs)} signatures (buyer, seller, notary)")
    paper = out["buyer_paper"][0].state.data
    print(f"Buyer now holds paper with face value {paper.face_value}")
    cash = sum(s.state.data.amount.quantity for s in out["seller_cash"])
    print(f"Seller now holds {cash // 100} dollars of cash")


if __name__ == "__main__":
    main()
