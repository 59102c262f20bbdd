"""A delivery-versus-payment trade through both packages, the port's
nodes verifying through its batcher on the CPU: the small twin of
chip_smoke.py's phase 7e.

Three banks (Ed25519, secp256k1 and secp256r1 identities) each issue
COINS USD coins to a secp256k1 buyer through CashIssueFlow; a secp256r1
seller issues itself a CommercialPaper through FinalityFlow and sells it
to the buyer through SellerFlow / BuyerFlow for all the coins, a
validating notary signing. The seller resolves the buyer's cash history
and the notary the whole graph, each in one VerifyMany wave. Then the
buyer spends a coin the trade consumed (a double spend) and the seller
moves more cash than it holds (a contract failure); both fail at the
yield of their FinalityFlow with a NotaryException.

Every port node's verifier service is the port's
TpuTransactionVerifierService on a SignatureBatcher(device="cpu",
host_crossover=0): the plain kernels, at buckets of 8 or less. The
reference's nodes verify in-flow on the host. Keys and amounts are the
same seeded ones, coins are issued one at a time (so every vault records
them in the same order), and the notary's clock is fixed, so the trade's
id, both vaults, every node's recorded transactions and both refusals'
exception types and messages must equal the reference's."""
import datetime
import hashlib
import random

import pytest

from test_torch_finance import PKGS, mod
from test_torch_flow_framework import mock_network, outcome

COINS = 2
NOW = datetime.datetime(2026, 7, 1, 12, tzinfo=datetime.timezone.utc)
SCHEMES = ("EDDSA_ED25519_SHA512", "ECDSA_SECP256K1_SHA256",
           "ECDSA_SECP256R1_SHA256")


def coin_cents(coins: int) -> list:
    """About 100.00 each and distinct (identical issuances would be one
    transaction): 100.00 + d cents, d in -coins/2..coins/2 without 0, so
    that the coins sum to coins x 100.00."""
    half = coins // 2
    return [10_000 + d for d in range(-half, half + 1) if d]


def _digest(pkg, obj):
    return hashlib.sha256(
        mod(pkg, "core.serialization").serialize(obj)).hexdigest()


def trade(pkg: str, seed: int = 5) -> dict:
    crypto = mod(pkg, "core.crypto")
    schemes = mod(pkg, "core.crypto.schemes")
    amount = mod(pkg, "core.contracts.amount")
    structures = mod(pkg, "core.contracts.structures")
    codec = mod(pkg, "core.serialization.codec")
    builder_mod = mod(pkg, "core.transactions.builder")
    finance = mod(pkg, "finance")
    cash = mod(pkg, "finance.cash")
    cp = mod(pkg, "finance.commercial_paper")
    library = mod(pkg, "flows.library")
    rng = random.Random(seed)

    def key(scheme):
        return crypto.generate_keypair(getattr(schemes, scheme),
                                       entropy=rng.randbytes(32))

    network = mock_network(pkg)
    notary = network.create_notary_node(validating=True)
    notary.notary_service.time_window_checker.clock = lambda: NOW
    banks = [network.create_node(f"O=Bank {i}, L=London, C=GB",
                                 key_pair=key(s))
             for i, s in enumerate(SCHEMES)]
    buyer = network.create_node("O=Buyer, L=New York, C=US",
                                key_pair=key(SCHEMES[1]))
    seller = network.create_node("O=Seller, L=Tokyo, C=JP",
                                 key_pair=key(SCHEMES[2]))
    network.start_nodes()
    if pkg == "corda_tpu_torch":
        from corda_tpu_torch.verifier import (SignatureBatcher,
                                              TpuTransactionVerifierService)
        for node in network.nodes:
            node.services.verifier_service = TpuTransactionVerifierService(
                batcher=SignatureBatcher(device="cpu", host_crossover=0,
                                         interactive_latency_s=0.05))
    rec = {}
    issued = []
    for cents in coin_cents(COINS):
        for bank in banks:
            fsm = bank.start_flow(finance.CashIssueFlow(
                amount.Amount(cents, amount.USD), b"\x01", buyer.party,
                notary.party))
            network.run_network()
            issued.append(fsm.result_future.result(timeout=0).id)
    price = amount.Amount(COINS * len(banks) * 10_000, amount.USD)

    b = builder_mod.TransactionBuilder(notary=notary.party)
    cp.CommercialPaper.generate_issue(
        b, structures.PartyAndReference(seller.party, b"\x07"),
        amount.Amount(price.quantity, structures.Issued(
            structures.PartyAndReference(seller.party, b"\x07"),
            amount.USD)),
        codec.exact_epoch_micros(NOW + datetime.timedelta(days=90)),
        notary.party)
    b.set_time_window(structures.TimeWindow.with_tolerance(
        NOW, datetime.timedelta(seconds=30)))
    paper_stx = seller.services.sign_initial_transaction(
        b.to_wire_transaction())
    fsm = seller.start_flow(library.FinalityFlow(paper_stx))
    network.run_network()
    paper_tx = fsm.result_future.result(timeout=0)
    paper = structures.StateAndRef(paper_tx.tx.outputs[0],
                                   structures.StateRef(paper_tx.id, 0))

    buys = []
    buyer.smm.changes.append(
        lambda ev, fsm: buys.append(fsm) if ev == "add" and isinstance(
            fsm.flow, finance.BuyerFlow) else None)
    sell = seller.start_flow(finance.SellerFlow(buyer.party, paper, price))
    network.run_network()
    final = sell.result_future.result(timeout=0)
    rec["trade"] = (final.id.bytes.hex(), len(final.tx.inputs),
                    len(final.tx.outputs), _digest(pkg, final))
    rec["issued"] = [i.bytes.hex() for i in issued]
    rec["paper"] = paper_tx.id.bytes.hex()

    # the double spend: a coin the trade consumed, moved again by the buyer
    spent = next(sar for sar in buyer.services.vault.query(
        cash.CashState, status="consumed") if sar.ref.txhash == issued[0])
    b = builder_mod.TransactionBuilder()
    b.add_input_state(spent)
    b.add_output_state(cash.CashState(spent.state.data.amount,
                                      seller.party.owning_key))
    b.add_command(cash.Move(), buyer.party.owning_key)
    double = buyer.services.sign_initial_transaction(b.to_wire_transaction())
    fsm = buyer.start_flow(library.FinalityFlow(double))
    network.run_network()
    rec["double_spend"] = outcome(fsm.result_future, 0)

    # the contract failure: the seller moves one cent more than its coin
    coin = seller.services.vault.unconsumed_states(cash.CashState)[0]
    more = amount.Amount(coin.state.data.amount.quantity + 1,
                         coin.state.data.amount.token)
    b = builder_mod.TransactionBuilder()
    b.add_input_state(coin)
    b.add_output_state(cash.CashState(more, buyer.party.owning_key))
    b.add_command(cash.Move(), seller.party.owning_key)
    bad = seller.services.sign_initial_transaction(b.to_wire_transaction())
    fsm = seller.start_flow(library.FinalityFlow(bad))
    network.run_network()
    rec["contract_failure"] = outcome(fsm.result_future, 0)

    def vault(node, status):
        return sorted((sar.ref.txhash.bytes.hex(), sar.ref.index,
                       _digest(pkg, sar.state))
                      for sar in node.services.vault.query(status=status))

    rec["nodes"] = {str(n.party.name): {
        "transactions": sorted(stx.id.bytes.hex()
                               for stx in n.services.storage.transactions),
        "unconsumed": vault(n, "unconsumed"),
        "consumed": vault(n, "consumed")} for n in network.nodes}
    rec["_handles"] = (network, notary, banks, buyer, seller, final,
                       double, bad, buys)
    return rec


@pytest.fixture(scope="module")
def trades():
    recs = {pkg: trade(pkg) for pkg in PKGS}
    yield recs
    for node in recs["corda_tpu_torch"]["_handles"][0].nodes:
        node.services.verifier_service.shutdown()


def _cmp(trades, key):
    port, ref = trades["corda_tpu_torch"][key], trades["corda_tpu"][key]
    assert port == ref
    return port


def test_the_trade_equals_the_references(trades):
    _cmp(trades, "issued")
    _cmp(trades, "paper")
    tx_id, n_in, n_out, _ = _cmp(trades, "trade")
    # every coin and the paper in; the paper and one cash output an issuer
    assert (n_in, n_out) == (3 * COINS + 1, 4)


def test_both_sides_return_the_notarised_trade(trades):
    _, notary, _, buyer, seller, final, _, _, buys = \
        trades["corda_tpu_torch"]["_handles"]
    assert len(buys) == 1
    assert buys[0].result_future.result(timeout=0).id == final.id
    assert notary.party.owning_key in {s.by for s in final.sigs}


def test_vaults_and_storage_equal_the_references(trades):
    nodes = _cmp(trades, "nodes")
    rec = trades["corda_tpu_torch"]
    _, _, _, buyer, seller, final, _, _, _ = rec["_handles"]
    issued = set(rec["issued"])
    buyer_rec = nodes[str(buyer.party.name)]
    seller_rec = nodes[str(seller.party.name)]
    # the buyer holds the paper and no cash; every coin is consumed
    assert [u[0] for u in buyer_rec["unconsumed"]] == [final.id.bytes.hex()]
    assert {c[0] for c in buyer_rec["consumed"]} >= issued
    # the seller holds the three cash outputs
    assert len(seller_rec["unconsumed"]) == 3
    # the seller and the notary recorded every issuance while resolving
    notary_name = "O=Notary Service, L=Zurich, C=CH"
    assert issued <= set(seller_rec["transactions"])
    assert issued <= set(nodes[notary_name]["transactions"])


def test_seller_cash_sums_to_the_price(trades):
    _, _, _, _, seller, _, _, _, _ = trades["corda_tpu_torch"]["_handles"]
    cash = mod("corda_tpu_torch", "finance.cash")
    held = seller.services.vault.unconsumed_states(cash.CashState)
    assert sum(s.state.data.amount.quantity for s in held) == \
        sum(coin_cents(COINS)) * 3
    assert len({s.state.data.amount.token for s in held}) == 3


def test_refusals_equal_the_references(trades):
    double = _cmp(trades, "double_spend")
    failed = _cmp(trades, "contract_failure")
    # both surface through NotaryFlow, which rethrows every FlowException
    # of the notary's (a ContractRejection too) as a NotaryException
    assert double[0] == "NotaryException"
    assert double[1].startswith("Input states already consumed: ")
    assert failed[0] == "NotaryException"
    assert failed[1].startswith("Contract verification failed: Cash not "
                                "conserved")
    _, notary, _, buyer, seller, _, dbl, bad, _ = \
        trades["corda_tpu_torch"]["_handles"]
    for node in (buyer, seller, notary):
        assert node.services.storage.get_transaction(dbl.id) is None
        assert node.services.storage.get_transaction(bad.id) is None


def test_the_port_verified_through_its_batcher(trades):
    network = trades["corda_tpu_torch"]["_handles"][0]
    checked = {}
    for node in network.nodes:
        snap = node.services.verifier_service.batcher.metrics.snapshot()
        checked[str(node.party.name)] = (
            snap.get("SigBatcher.DeviceChecked", {}).get("count", 0),
            snap.get("SigBatcher.HostRouted", {}).get("count", 0))
    # seller and notary resolved the cash history on the plain kernels
    assert checked["O=Seller, L=Tokyo, C=JP"][0] >= 3 * COINS
    assert checked["O=Notary Service, L=Zurich, C=CH"][0] >= 3 * COINS + 1
    assert all(host == 0 for _, host in checked.values())
