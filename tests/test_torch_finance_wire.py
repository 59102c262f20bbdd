"""Finance transactions cross between the packages on the wire: Cash,
CommercialPaper, Commodity, Obligation and Universal transactions built
from a seed by each package serialise to the same bytes, each package
reads the other's bytes back with the same id, and ledger verification
(``to_ledger_transaction(...).verify()`` over a MockServices that holds
the inputs' transactions) ends the same way in both: the same exception
type and message, or none, on valid transactions and on broken ones —
conservation broken, issuer signature missing, owner signature missing,
wrong token group, maturity not reached."""
import datetime
import random

import pytest

from test_torch_finance import PKGS, mod

NOW = datetime.datetime(2026, 7, 1, tzinfo=datetime.timezone.utc)
DAY = datetime.timedelta(days=1)


def scenario(pkg: str, seed: int) -> list:
    """(label, input transactions, transaction) of every case, built by
    ``pkg`` from ``seed``: Ed25519 keys from seeded entropy, seeded
    amounts."""
    c = mod(pkg, "core.contracts.structures")
    amount = mod(pkg, "core.contracts.amount")
    keys = mod(pkg, "core.crypto")
    identity = mod(pkg, "core.identity")
    codec = mod(pkg, "core.serialization.codec")
    builder_mod = mod(pkg, "core.transactions.builder")
    cash = mod(pkg, "finance.cash")
    cp = mod(pkg, "finance.commercial_paper")
    commodity = mod(pkg, "finance.commodity")
    ob = mod(pkg, "finance.obligation")
    uni = mod(pkg, "experimental.universal")
    rng = random.Random(seed)

    def kp():
        return keys.generate_keypair(entropy=rng.randbytes(32))

    notary_kp, bank_kp, alice_kp, bob_kp = kp(), kp(), kp(), kp()
    notary = identity.Party("O=Notary, L=Zurich, C=CH", notary_kp.public)
    bank = identity.Party("O=Bank, L=London, C=GB", bank_kp.public)
    other = identity.Party("O=Other Bank, L=Paris, C=FR", bob_kp.public)
    by_key = {k.public: k for k in (notary_kp, bank_kp, alice_kp, bob_kp)}
    usd = c.Issued(c.PartyAndReference(bank, b"\x01"), amount.USD)
    usd_other = c.Issued(c.PartyAndReference(other, b"\x02"), amount.USD)
    qty = rng.randrange(1_000, 1_000_000)

    def tx(inputs=(), outputs=(), commands=(), window=None):
        b = builder_mod.TransactionBuilder(notary=notary)
        for sar in inputs:
            b.add_input_state(sar)
        for state in outputs:
            b.add_output_state(state, notary)
        for data, *signers in commands:
            b.add_command(data, *(s.public for s in signers))
        if window is not None:
            b.set_time_window(c.TimeWindow.with_tolerance(
                window, datetime.timedelta(seconds=30)))
        wtx = b.to_wire_transaction()
        sigs = [mod(pkg, "core.crypto.signatures").Crypto.sign_with_key(
            by_key[k], wtx.id.bytes) for k in wtx.must_sign if k in by_key]
        return mod(pkg, "core.transactions.signed").SignedTransaction.of(
            wtx, sigs)

    def ref(stx, i=0):
        return c.StateAndRef(stx.tx.outputs[i], c.StateRef(stx.id, i))

    cases = []
    # -- Cash
    issue = tx(outputs=[cash.CashState(amount.Amount(qty, usd),
                                       alice_kp.public)],
               commands=[(cash.Issue(), bank_kp)])
    cases.append(("cash issue", [], issue))
    cases.append(("cash issue, issuer signature missing", [],
                  tx(outputs=[cash.CashState(amount.Amount(qty, usd),
                                             alice_kp.public)],
                     commands=[(cash.Issue(), alice_kp)])))
    coin = ref(issue)
    cases.append(("cash move", [issue],
                  tx([coin], [cash.CashState(amount.Amount(qty, usd),
                                             bob_kp.public)],
                     [(cash.Move(), alice_kp)])))
    cases.append(("cash move, conservation broken", [issue],
                  tx([coin], [cash.CashState(amount.Amount(qty + 1, usd),
                                             bob_kp.public)],
                     [(cash.Move(), alice_kp)])))
    cases.append(("cash move, owner signature missing", [issue],
                  tx([coin], [cash.CashState(amount.Amount(qty, usd),
                                             bob_kp.public)],
                     [(cash.Move(), bob_kp)])))
    cases.append(("cash move, wrong token group", [issue],
                  tx([coin], [cash.CashState(amount.Amount(qty, usd_other),
                                             bob_kp.public)],
                     [(cash.Move(), alice_kp)])))
    # -- CommercialPaper
    maturity = codec.exact_epoch_micros(NOW + rng.randrange(10, 40) * DAY)
    face = amount.Amount(qty * 10, usd)
    paper = cp.CommercialPaperState(c.PartyAndReference(bank, b"\x01"),
                                    bank_kp.public, face, maturity)
    cp_issue = tx(outputs=[paper], commands=[(cp.Issue(), bank_kp)],
                  window=NOW)
    cases.append(("paper issue", [], cp_issue))
    cases.append(("paper issue, issuer signature missing", [],
                  tx(outputs=[paper], commands=[(cp.Issue(), alice_kp)],
                     window=NOW)))
    cp_move = tx([ref(cp_issue)], [paper.with_new_owner(alice_kp.public)[1]],
                 [(cp.Move(), bank_kp)])
    cases.append(("paper move", [cp_issue], cp_move))
    cases.append(("paper move, owner signature missing", [cp_issue],
                  tx([ref(cp_issue)],
                     [paper.with_new_owner(alice_kp.public)[1]],
                     [(cp.Move(), alice_kp)])))
    # the issuer pays the face value out of its own cash
    funds = tx(outputs=[cash.CashState(face, bank_kp.public)],
               commands=[(cash.Issue(), bank_kp)])
    pay = cash.CashState(face, alice_kp.public)
    for label, at in (("paper redeem, maturity not reached", NOW),
                      ("paper redeem", NOW + 60 * DAY)):
        cases.append((label, [cp_move, funds],
                      tx([ref(cp_move), ref(funds)], [pay],
                         [(cp.Redeem(), alice_kp), (cash.Move(), bank_kp)],
                         window=at)))
    # -- Commodity
    fcoj = c.Issued(c.PartyAndReference(bank, b"\x03"),
                    commodity.Commodity("FCOJ", "Orange juice"))
    com_issue = tx(outputs=[commodity.CommodityState(
        amount.Amount(qty, fcoj), alice_kp.public)],
        commands=[(commodity.Issue(), bank_kp)])
    cases.append(("commodity issue", [], com_issue))
    cases.append(("commodity move, conservation broken", [com_issue],
                  tx([ref(com_issue)], [commodity.CommodityState(
                      amount.Amount(qty * 2, fcoj), bob_kp.public)],
                     [(commodity.Move(), alice_kp)])))
    # -- Obligation
    terms = ob.Terms(usd, codec.exact_epoch_micros(NOW + 10 * DAY))
    owed = ob.ObligationState(alice_kp.public, terms, qty, bob_kp.public,
                              ob.Lifecycle.NORMAL)
    ob_issue = tx(outputs=[owed], commands=[(ob.Issue(), alice_kp)],
                  window=NOW)
    cases.append(("obligation issue", [], ob_issue))
    cases.append(("obligation issue, issuer signature missing", [],
                  tx(outputs=[owed], commands=[(ob.Issue(), bob_kp)],
                     window=NOW)))
    cases.append(("obligation move, owner signature missing", [ob_issue],
                  tx([ref(ob_issue)],
                     [owed.with_new_beneficiary(bank_kp.public)[1]],
                     [(ob.Move(), alice_kp)], window=NOW)))
    # -- Universal
    bond = uni.Actions({"redeem": uni.Action(
        alice_kp.public, uni.after(NOW + 30 * DAY),
        uni.All((uni.Transfer(uni.const(qty), "USD", bank_kp.public,
                              alice_kp.public),)))})
    u_state = uni.UniversalState(bond, (bank_kp.public, alice_kp.public))
    u_issue = tx(outputs=[u_state], commands=[(uni.Issue(), bank_kp)])
    cases.append(("universal issue", [], u_issue))
    cases.append(("universal issue, issuer signature missing", [],
                  tx(outputs=[u_state], commands=[(uni.Issue(), alice_kp)])))
    paid = uni.UniversalState(uni.All((uni.Transfer(
        uni.const(qty), "USD", bank_kp.public, alice_kp.public),)),
        u_state.parties)
    cases.append(("universal redeem, maturity not reached", [u_issue],
                  tx([ref(u_issue)], [paid], [(uni.Move("redeem"), alice_kp)],
                     window=NOW)))
    cases.append(("universal redeem", [u_issue],
                  tx([ref(u_issue)], [paid], [(uni.Move("redeem"), alice_kp)],
                     window=NOW + 31 * DAY)))
    return cases


def verify_outcome(pkg: str, inputs: list, stx) -> tuple:
    services = mod(pkg, "testing").MockServices()
    services.record_transactions(*inputs)
    try:
        stx.verify(services, check_sufficient_signatures=True)
        return ("ok",)
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))


SEEDS = (11, 12)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_bytes_from_the_same_seed(seed):
    built = {pkg: scenario(pkg, seed) for pkg in PKGS}
    ser = {pkg: mod(pkg, "core.serialization") for pkg in PKGS}
    for ref, port in zip(*built.values()):
        assert ref[0] == port[0]
        assert ser["corda_tpu_torch"].serialize(port[2]) == \
            ser["corda_tpu"].serialize(ref[2]), ref[0]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("builder", PKGS)
def test_read_back_and_verified_alike(builder, seed):
    cases = scenario(builder, seed)
    ser_b = mod(builder, "core.serialization")
    outcomes = {}
    for label, inputs, stx in cases:
        blob = ser_b.serialize(stx)
        in_blobs = [ser_b.serialize(i) for i in inputs]
        got = {}
        for pkg in PKGS:
            des = mod(pkg, "core.serialization").deserialize
            read = des(blob)
            assert read.id.bytes == stx.id.bytes, (label, pkg)
            got[pkg] = verify_outcome(pkg, [des(b) for b in in_blobs], read)
        assert got["corda_tpu_torch"] == got["corda_tpu"], label
        outcomes[label] = got["corda_tpu"][0]
    # the valid cases verify and every broken one is refused
    for label, outcome in outcomes.items():
        assert (outcome == "ok") == ("," not in label), (label, outcome)
