"""Bank of Corda: an issuer node serving cash-issue requests.

Reference parity: samples/bank-of-corda-demo (BankOfCordaDriver.kt + the
IssuerFlow pair in finance): a requester asks the bank to issue an amount to
them; the bank applies an acceptance policy, issues, and pays the requester
in one atomic transaction chain.

A copy of the reference's module; ``run_demo(device=...)`` (default "cuda",
raising without CUDA) hands its device to ``MockNetwork(device=)``.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.contracts.amount import Amount, USD
from ..core.serialization import register_type
from ..device import DEFAULT_DEVICE
from ..finance import CashIssueFlow
from ..flows.api import (FlowException, FlowLogic, Receive, Send,
                         SendAndReceive, initiating_flow)
from ..testing import MockNetwork


@dataclass(frozen=True)
class IssuanceRequest:
    amount: Amount
    reference: bytes


register_type("bank.IssuanceRequest", IssuanceRequest)


@initiating_flow
class IssuanceRequester(FlowLogic):
    """Requester side (IssuerFlow.IssuanceRequester): ask `bank` to issue
    `amount` to us; the result is the bank's finalised issue transaction id."""

    def __init__(self, bank, amount: Amount, reference: bytes = b"\x01"):
        self.bank = bank
        self.amount = amount
        self.reference = reference

    def call(self):
        resp = yield SendAndReceive(
            self.bank, IssuanceRequest(self.amount, self.reference), object)
        tx_id = resp.unwrap(lambda r: r)
        stx = yield from self.wait_for_ledger_commit(tx_id)
        return stx


class Issuer(FlowLogic):
    """Bank side (IssuerFlow.Issuer). The default policy caps single
    issuances; override `check_request` for real policies."""

    MAX_SINGLE_ISSUE = 1_000_000_00  # $1M in cents

    def __init__(self, peer):
        self.peer = peer

    def check_request(self, request: IssuanceRequest) -> None:
        if request.amount.quantity > self.MAX_SINGLE_ISSUE:
            raise FlowException("Issuance request exceeds the single-issue cap")

    def call(self):
        req = yield Receive(self.peer, IssuanceRequest)
        request = req.unwrap(
            lambda r: r if isinstance(r, IssuanceRequest) else _bad())
        self.check_request(request)
        hub = self.service_hub
        notaries = hub.network_map_cache.notary_nodes()
        if not notaries:
            raise FlowException("No notary on the network")
        stx = yield from self.sub_flow(CashIssueFlow(
            request.amount, request.reference, self.peer,
            notaries[0].notary_identity))
        yield Send(self.peer, stx.id)
        return stx.id


def _bad():
    raise FlowException("Malformed issuance request")


def install_issuer(smm) -> None:
    from ..flows.api import flow_name
    smm.register_flow_factory(flow_name(IssuanceRequester), Issuer)


def run_demo(amount_dollars: int = 1000, device=DEFAULT_DEVICE):
    """BankOfCordaDriver analog over MockNetwork."""
    network = MockNetwork(device=device)
    notary = network.create_notary_node()
    bank = network.create_node("O=BankOfCorda, L=London, C=GB")
    requester = network.create_node("O=BigCorporation, L=New York, C=US")
    network.start_nodes()
    install_issuer(bank.smm)
    fsm = requester.start_flow(IssuanceRequester(
        bank.party, Amount(amount_dollars * 100, USD)))
    network.run_network()
    stx = fsm.result_future.result(timeout=5)
    return {"network": network, "bank": bank, "requester": requester,
            "stx": stx}


def main() -> None:
    from ..finance import CashState
    out = run_demo()
    holdings = out["requester"].services.vault.unconsumed_states(CashState)
    total = sum(s.state.data.amount.quantity for s in holdings)
    print(f"Bank issued; requester holds {total // 100} dollars "
          f"(tx {out['stx'].id.prefix_chars()})")


if __name__ == "__main__":
    main()
