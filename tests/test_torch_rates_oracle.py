"""The port's rates oracle (service, flows, bulk ``sign_batch``) against the
JAX package's (tests/test_batch_merkle.py::test_oracle_sign_batch, and the
oracle's query and sign flows over each package's MockNetwork).

The oracle's key comes from the same entropy in both packages, so its
signatures (Ed25519, deterministic) are the same bytes. Tear-offs are made
with the JAX package and cross to the port as ``serialize`` bytes; the
port's oracle node is on the CPU, and one case forces its bulk proof check
through the plain B6 kernel."""
import pytest

from corda_tpu.core.contracts import Command
from corda_tpu.core.crypto.secure_hash import SecureHash
from corda_tpu.core.serialization import serialize as j_serialize
from corda_tpu.core.transactions.filtered import FilteredTransaction
from corda_tpu_torch.core.serialization import deserialize as t_deserialize
from corda_tpu_torch.core.transactions import batch_merkle as tbm

from test_batch_merkle import _wtxs
from test_torch_flow_framework import PKGS, mock_network, mod, outcome


def fixture(pkg):
    ro = mod(pkg, "samples.rates_oracle")
    fix_of = ro.FixOf("ICE LIBOR", "2016-03-16", "3M")
    network = mock_network(pkg)
    notary = network.create_notary_node()
    oracle_node = network.create_node("O=Rates Oracle, L=London, C=GB")
    alice = network.create_node("O=Alice, L=Madrid, C=ES")
    network.start_nodes()
    oracle = ro.RatesOracle(oracle_node.services, {fix_of: 525})
    oracle.install(oracle_node.smm)
    return network, notary, oracle_node, alice, oracle, ro, fix_of


def reference_ftxs():
    """test_oracle_sign_batch's tear-offs, made with the JAX package: four
    agreeable ones, a bad root and an over-revealed one."""
    network, notary, oracle_node, alice, _, ro, fix_of = fixture("corda_tpu")
    wtxs = _wtxs(4, alice, oracle_node, notary, ro.Fix, fix_of)
    ftxs = [w.build_filtered_transaction(
        lambda c: isinstance(c, Command) and isinstance(c.value, ro.Fix))
        for w in wtxs]
    ftxs.append(FilteredTransaction(SecureHash.sha256(b"no"),
                                    ftxs[0].filtered_leaves,
                                    ftxs[0].partial_merkle_tree))
    ftxs.append(wtxs[0].build_filtered_transaction(lambda c: True))
    return ftxs


def _record(results):
    return [(type(r).__name__, r.bytes.hex() if hasattr(r, "bytes")
             else str(r)) for r in results]


def _sign_batch(pkg, ftxs):
    *_, oracle, _, _ = fixture(pkg)
    if pkg != "corda_tpu":
        ftxs = [t_deserialize(j_serialize(f)) for f in ftxs]
    out = oracle.sign_batch(ftxs)
    single = oracle.sign(ftxs[0])
    return _record(out), _record([single])


def test_oracle_sign_batch():
    ftxs = reference_ftxs()
    got = {pkg: _sign_batch(pkg, ftxs) for pkg in PKGS}
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    batch, single = got["corda_tpu_torch"]
    assert [k for k, _ in batch[:4]] == ["DigitalSignatureWithKey"] * 4
    assert batch[4][0] == "FlowException" and "Merkle" in batch[4][1]
    assert batch[5][0] == "FlowException" and "refuses" in batch[5][1]
    assert single == batch[:1]


def test_sign_batch_checks_proofs_on_the_oracle_nodes_device(monkeypatch):
    """sign_batch hands the oracle node's device to verify_filtered_batch;
    with the crossover at one pair every round runs the plain B6 kernel on
    that device, and the outcomes are the reference's."""
    ftxs = reference_ftxs()
    want = _sign_batch("corda_tpu", ftxs)[0]
    calls = []
    real = tbm.verify_filtered_batch

    def through_b6(ftxs, device_crossover=tbm.DEVICE_CROSSOVER,
                   use_device=True, device="cuda"):
        calls.append(str(device))
        return real(ftxs, device_crossover=1, use_device=use_device,
                    device=device)

    monkeypatch.setattr(tbm, "verify_filtered_batch", through_b6)
    assert _sign_batch("corda_tpu_torch", ftxs)[0] == want
    assert calls == ["cpu"]


def _flows(pkg):
    network, notary, oracle_node, alice, oracle, ro, fix_of = fixture(pkg)
    contracts = mod(pkg, "core.contracts")
    transactions = mod(pkg, "core.transactions")
    testing = mod(pkg, "testing")
    rec = {}
    q = alice.start_flow(ro.RatesFixQueryFlow(oracle_node.party, fix_of))
    unknown = alice.start_flow(ro.RatesFixQueryFlow(
        oracle_node.party, ro.FixOf("ICE LIBOR", "2016-03-17", "3M")))
    network.run_network()
    fix = q.result_future.result(timeout=5)
    rec["fix"] = (fix.of.name, fix.of.for_day, fix.of.tenor, fix.value_bp)
    rec["unknown"] = outcome(unknown.result_future)
    me, rates = alice.party.owning_key, oracle_node.party.owning_key
    wtx = transactions.WireTransaction(
        outputs=(contracts.TransactionState(
            testing.DummyState(1, (me,)), notary.party),),
        commands=(contracts.Command(testing.DummyContract.Create(), (me,)),
                  contracts.Command(fix, (rates,))),
        notary=notary.party, must_sign=(me, rates))
    only_fix = wtx.build_filtered_transaction(
        lambda c: isinstance(c, contracts.Command)
        and isinstance(c.value, ro.Fix))
    everything = wtx.build_filtered_transaction(lambda c: True)
    signs = [alice.start_flow(ro.RatesFixSignFlow(oracle_node.party, f))
             for f in (only_fix, everything)]
    network.run_network()
    got = [outcome(s.result_future) for s in signs]
    rec["signed"] = [(k, v.bytes.hex() if k == "ok" else v) for k, v in got]
    rec["wtx_id"] = wtx.id.bytes.hex()
    rec["signer_is_oracle"] = got[0][1].by == rates
    return rec


def test_rates_fix_flows_match_reference():
    got = {pkg: _flows(pkg) for pkg in PKGS}
    port = got["corda_tpu_torch"]
    assert port == got["corda_tpu"]
    assert port["fix"] == ("ICE LIBOR", "2016-03-16", "3M", 525)
    assert port["unknown"][0] == "FlowException"
    assert port["signed"][0][0] == "ok" and port["signer_is_oracle"]
    assert port["signed"][1][0] == "FlowException"
    assert "refuses" in port["signed"][1][1]


@pytest.mark.parametrize("name", ["FixOf", "Fix", "QueryRequest",
                                  "SignRequest"])
def test_wire_types_keep_the_reference_names(name):
    from corda_tpu.core.serialization.codec import registered_name as jname
    from corda_tpu_torch.core.serialization.codec import \
        registered_name as tname
    j = getattr(mod("corda_tpu", "samples.rates_oracle"), name)
    t = getattr(mod("corda_tpu_torch", "samples.rates_oracle"), name)
    assert tname(t) == jname(j) == f"oracle.{name}"
