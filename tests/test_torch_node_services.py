"""The port's node services, notary and ledger flows against the JAX
package's: one seeded DummyState ledger (three issuances finalised without
a notary, a notarised move, a double spend the notary refuses, a
two-signer transaction through CollectSignaturesFlow) runs on each
package's MockNetwork, and the transaction ids, notary results and
conflicts, storage and vault contents, vault queries, schema rows, audit
events and vault-update expectations are compared
(tests/test_notary_flows.py, and the DummyState cases of
tests/test_{vault_query,schemas,audit,expect}.py; their Cash cases wait for
the finance slice).

Nodes take their keys from the same entropy in both packages, so the
transactions, and their ids, are the same. Flows verify in-flow on the
host (no verifier service), so no kernel runs; the port's MockNetwork is
on the CPU. Flow names differ by the package prefix, which the audit
comparison maps."""
import datetime
import re
from dataclasses import dataclass

import pytest

from test_torch_flow_framework import PKGS, mock_network, mod, outcome


def _node_view(node):
    """What a node holds: its transactions by id, its vault's unconsumed and
    consumed states (by magic number and ref), its schema tables."""
    vault = node.services.vault
    q = mod(type(node).__module__.split(".")[0], "node.query")

    def states(status):
        page = vault.query_by(q.VaultQueryCriteria(status=status),
                              sorting=q.Sort((("state_ref", "ASC"),)))
        return [(s.state.data.magic_number, s.ref.txhash.bytes.hex(),
                 s.ref.index) for s in page.states]

    return {"txs": sorted(stx.id.bytes.hex()
                          for stx in node.services.storage.transactions),
            "unconsumed": states("unconsumed"),
            "consumed": states("consumed")}


def ledger(pkg):
    """The scenario on ``pkg``: a record of everything compared."""
    contracts = mod(pkg, "core.contracts")
    transactions = mod(pkg, "core.transactions")
    library = mod(pkg, "flows.library")
    api = mod(pkg, "flows.api")
    testing = mod(pkg, "testing")
    audit_mod = mod(pkg, "node.audit")
    vault_mod = mod(pkg, "node.vault")
    network = mock_network(pkg)
    notary = network.create_notary_node()
    alice = network.create_node("O=Alice, L=London, C=GB")
    bob = network.create_node("O=Bob, L=Paris, C=FR")
    network.start_nodes()
    updates = []
    alice.services.vault.add_update_observer(updates.append)
    rec = {}

    issued = []
    for magic in (1, 2, 3):
        builder = transactions.TransactionBuilder(notary=notary.party)
        builder.add_output_state(testing.DummyState(
            magic, (alice.party.owning_key,)))
        builder.add_command(testing.DummyContract.Create(),
                            alice.party.owning_key)
        stx = alice.services.sign_initial_transaction(
            builder.to_wire_transaction())
        fsm = alice.start_flow(library.FinalityFlow(stx))
        network.run_network()
        final = fsm.result_future.result(timeout=5)
        issued.append(contracts.StateAndRef(final.tx.outputs[0],
                                            contracts.StateRef(final.id, 0)))
        rec.setdefault("issue_sig_counts", []).append(len(final.sigs))

    def move(sref, new_owner_key):
        builder = transactions.TransactionBuilder()
        builder.add_input_state(sref)
        builder.add_output_state(testing.DummyState(
            sref.state.data.magic_number, (new_owner_key,)))
        builder.add_command(testing.DummyContract.Move(),
                            alice.party.owning_key)
        return alice.services.sign_initial_transaction(
            builder.to_wire_transaction())

    stx1 = move(issued[0], bob.party.owning_key)
    fsm = alice.start_flow(library.FinalityFlow(stx1))
    network.run_network()
    final = fsm.result_future.result(timeout=5)
    final.verify_signatures()
    rec["move_id"] = final.id.bytes.hex()
    rec["move_signers"] = sorted(
        "notary" if s.by == notary.party.owning_key else
        "alice" if s.by == alice.party.owning_key else "other"
        for s in final.sigs)
    rec["bob_has_move_and_dependency"] = (
        bob.services.storage.get_transaction(final.id) is not None,
        bob.services.storage.get_transaction(issued[0].ref.txhash)
        is not None)

    stx2 = move(issued[0], alice.party.owning_key)
    fsm = alice.start_flow(library.NotaryFlow(stx2))
    network.run_network()
    rec["double_spend"] = outcome(fsm.result_future)

    # two signers through CollectSignaturesFlow
    builder = transactions.TransactionBuilder(notary=notary.party)
    builder.add_output_state(testing.DummyState(
        5, (alice.party.owning_key, bob.party.owning_key)))
    builder.add_command(testing.DummyContract.Create(),
                        alice.party.owning_key, bob.party.owning_key)
    stx = alice.services.sign_initial_transaction(
        builder.to_wire_transaction())
    bob.smm.register_flow_factory(api.flow_name(library.CollectSignaturesFlow),
                                  library.SignTransactionFlow)
    fsm = alice.start_flow(library.CollectSignaturesFlow(stx))
    network.run_network()
    full = fsm.result_future.result(timeout=5)
    full.verify_signatures()
    rec["collected"] = (full.id.bytes.hex(), sorted(
        s.by.encoded.hex() for s in full.sigs),
        {s.by for s in full.sigs} == {alice.party.owning_key,
                                      bob.party.owning_key})

    rec["nodes"] = {name: _node_view(n) for name, n in
                    (("notary", notary), ("alice", alice), ("bob", bob))}
    rec["vault_updates"] = [
        (sorted(s.state.data.magic_number for s in u.consumed),
         sorted(s.state.data.magic_number for s in u.produced))
        for u in updates]
    rec["_updates"] = updates
    prefix = f"{pkg}."
    rec["audit"] = [
        (type(e).__name__, e.flow_type.replace(prefix, "PKG."),
         getattr(e, "error", None))
        for e in alice.services.audit.events()
        if isinstance(e, audit_mod.FlowAuditEvent)]
    rec["_handles"] = (network, notary, alice, bob)
    return rec


@pytest.fixture(scope="module")
def ledgers():
    return {pkg: ledger(pkg) for pkg in PKGS}


def _cmp(ledgers, key):
    ref, port = ledgers["corda_tpu"][key], ledgers["corda_tpu_torch"][key]
    assert port == ref
    return port


# -- tests/test_notary_flows.py ----------------------------------------------

def test_issue_and_notarised_move(ledgers):
    assert _cmp(ledgers, "issue_sig_counts") == [1, 1, 1]
    _cmp(ledgers, "move_id")
    assert _cmp(ledgers, "move_signers") == ["alice", "notary"]
    assert _cmp(ledgers, "bob_has_move_and_dependency") == (True, True)


def test_double_spend_rejected(ledgers):
    kind, msg = _cmp(ledgers, "double_spend")
    assert kind == "NotaryException" and "already consumed" in msg


def test_collect_signatures(ledgers):
    assert _cmp(ledgers, "collected")[2] is True


def test_storage_and_vaults_match_reference(ledgers):
    nodes = _cmp(ledgers, "nodes")
    assert len(nodes["alice"]["txs"]) == 4
    assert sorted(m for m, *_ in nodes["alice"]["unconsumed"]) == [2, 3]
    assert [m for m, *_ in nodes["alice"]["consumed"]] == [1]
    assert [m for m, *_ in nodes["bob"]["unconsumed"]] == [1]


# -- DummyState cases of tests/test_vault_query.py ---------------------------

def _queries(pkg, ledgers):
    _, notary, alice, _ = ledgers[pkg]["_handles"]
    q = mod(pkg, "node.query")
    testing = mod(pkg, "testing")
    vault = alice.services.vault
    now = datetime.datetime.now(datetime.timezone.utc)
    minute = datetime.timedelta(minutes=1)
    out = {
        "by_type": vault.query_by(q.VaultQueryCriteria(
            contract_state_types=(testing.DummyState,))
        ).total_states_available,
        "consumed": vault.query_by(q.VaultQueryCriteria(
            status="consumed")).total_states_available,
        "all": vault.query_by(q.VaultQueryCriteria(
            status="all")).total_states_available,
        "custom": vault.query_by(q.CustomQueryCriteria(
            attribute="magic_number", predicate=q.greater_than(2))
        ).total_states_available,
        "composed": vault.query_by(
            q.CustomQueryCriteria(attribute="magic_number",
                                  predicate=q.equal(2))
            | q.CustomQueryCriteria(attribute="magic_number",
                                    predicate=q.between(4, 9))
        ).total_states_available,
        "past": vault.query_by(q.VaultQueryCriteria(
            time_condition=q.TimeCondition(
                "recorded", q.less_than(now + minute)))
        ).total_states_available,
        "future": vault.query_by(q.VaultQueryCriteria(
            time_condition=q.TimeCondition(
                "recorded", q.greater_than(now + minute)))
        ).total_states_available,
    }
    desc = vault.query_by(q.VaultQueryCriteria(),
                          sorting=q.Sort((("magic_number", "DESC"),)))
    out["sorted_desc"] = [s.state.data.magic_number for s in desc.states]
    pages = [vault.query_by(q.VaultQueryCriteria(),
                            paging=q.PageSpecification(n, 1),
                            sorting=q.Sort((("magic_number", "ASC"),)))
             for n in (1, 2)]
    out["pages"] = [([s.state.data.magic_number for s in p.states],
                     p.total_states_available) for p in pages]
    try:
        q.PageSpecification(0, 10)
        out["page_zero"] = None
    except q.VaultQueryError as exc:
        out["page_zero"] = str(exc)
    sar = sorted(vault.unconsumed_states(testing.DummyState),
                 key=lambda s: s.state.data.magic_number)[0]
    vault.soft_lock_reserve("flow-1", [sar.ref])
    out["locked"] = vault.query_by(q.VaultQueryCriteria(
        soft_locking="locked_only")).total_states_available
    out["unlocked"] = vault.query_by(q.VaultQueryCriteria(
        soft_locking="unlocked_only")).total_states_available
    vault.soft_lock_release("flow-1")
    return out


def test_vault_query_axes_match_reference(ledgers):
    got = {pkg: _queries(pkg, ledgers) for pkg in PKGS}
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    port = got["corda_tpu_torch"]
    assert port["sorted_desc"] == [3, 2]
    assert port["pages"] == [([2], 2), ([3], 2)]
    assert (port["by_type"], port["consumed"], port["all"]) == (2, 1, 3)
    assert (port["custom"], port["composed"]) == (1, 1)
    assert (port["past"], port["future"]) == (2, 0)
    assert (port["locked"], port["unlocked"]) == (1, 1)
    assert port["page_zero"] is not None


# -- tests/test_schemas.py::test_sample_state_defines_its_own_schema ---------

def _schema(pkg, ledgers):
    _, notary, bank, _ = ledgers[pkg]["_handles"]
    structures = mod(pkg, "core.contracts.structures")
    SecureHash = mod(pkg, "core.crypto.secure_hash").SecureHash
    schemas = mod(pkg, "node.schemas")
    VaultUpdate = mod(pkg, "node.vault").VaultUpdate
    TRADE_SCHEMA = schemas.MappedSchema("TradeSchema", 1, ("ticker", "qty"))

    @dataclass(frozen=True)
    class TradeState:
        ticker: str
        qty: int
        owner_keys: tuple

        @property
        def participants(self):
            return list(self.owner_keys)

        def supported_schemas(self):
            return (TRADE_SCHEMA,)

        def generate_mapped_object(self, schema):
            return {"ticker": self.ticker, "qty": self.qty}

    svc = bank.services.schema_service
    ref = structures.StateRef(SecureHash.sha256(b"trade-tx"), 0)
    state = TradeState("TPU", 64, (bank.party.owning_key,))
    svc._on_vault_update(VaultUpdate((), (structures.StateAndRef(
        structures.TransactionState(state, notary.party), ref),)))
    rows = svc.rows(TRADE_SCHEMA)
    q = mod(pkg, "node.query")
    page = bank.services.vault.query_by(schemas.SchemaColumnCriteria(
        schema=TRADE_SCHEMA, column="qty", predicate=q.greater_than(10)))
    return {"registered": TRADE_SCHEMA.name in {s.name for s in svc.schemas},
            "rows": [(r.ref.txhash.bytes.hex(), r.ref.index, r.values)
                     for r in rows],
            "row_is_persistent": rows == [schemas.PersistentRow(
                ref, ("TPU", 64))],
            "header": svc.export_table(TRADE_SCHEMA),
            "vault_hits": page.total_states_available}


def test_sample_state_defines_its_own_schema(ledgers):
    got = {pkg: _schema(pkg, ledgers) for pkg in PKGS}
    port = got["corda_tpu_torch"]
    assert port["registered"] and port["row_is_persistent"]
    port["header"] = (port["header"][0], len(port["header"][1]))
    ref = got["corda_tpu"]
    ref["header"] = (ref["header"][0], len(ref["header"][1]))
    assert port == ref


# -- DummyState cases of tests/test_audit.py ---------------------------------

def test_flow_lifecycle_and_error_events(ledgers):
    events = _cmp(ledgers, "audit")
    starts = [t for kind, t, _ in events if kind == "FlowStartEvent"]
    assert "PKG.flows.library.FinalityFlow" in starts
    errors = [(t, e) for kind, t, e in events if kind == "FlowErrorAuditEvent"]
    assert len(errors) == 1
    assert errors[0][0] == "PKG.flows.library.NotaryFlow"
    assert "already consumed" in errors[0][1]


def _capacity(pkg):
    audit = mod(pkg, "node.audit")
    svc = audit.InMemoryAuditService(capacity=5)
    seen = []
    svc.add_observer(seen.append)
    for i in range(12):
        svc.record_audit_event(audit.SystemAuditEvent(description=f"e{i}"))
    return [e.description for e in svc.events()], len(seen)


def test_capacity_bound():
    got = {pkg: _capacity(pkg) for pkg in PKGS}
    assert got["corda_tpu_torch"] == got["corda_tpu"] == (
        ["e7", "e8", "e9", "e10", "e11"], 12)


# -- tests/test_expect.py ----------------------------------------------------

def _dsl(pkg):
    ex = mod(pkg, "testing.expect")
    expect, parallel, repeat, sequence = (ex.expect, ex.parallel, ex.repeat,
                                          ex.sequence)
    run = ex.run_expectations
    events = ["start", 1, 2, "mid", 3, "end"]
    cases = [
        lambda: run(events, sequence(
            expect(str, lambda s: s == "start"),
            parallel(expect(int, lambda i: i == 2),
                     expect(int, lambda i: i == 1)),
            expect(str, lambda s: s == "end")), strict=False),
        lambda: run(events, sequence(
            expect(str, lambda s: s == "end"),
            expect(str, lambda s: s == "start")), strict=False),
        lambda: run([7, 7, 7], repeat(3, expect(int, lambda i: i == 7))),
        lambda: run([7, 7], repeat(3, expect(int, lambda i: i == 7))),
        lambda: run(["extra", 7], sequence(expect(int))),
        lambda: run([1, 2], parallel(expect(int),
                                     expect(int, lambda i: i == 1))),
        lambda: run([], repeat(0, expect(int))),
        lambda: run([], sequence()),
    ]
    out = []
    for case in cases:
        try:
            case()
            out.append("ok")
        except ex.ExpectationFailed as exc:
            # the message shows the remaining leaves' predicates by address
            out.append(("ExpectationFailed",
                        re.sub(r" at 0x[0-9a-f]+", "", str(exc))))
    return out


def test_sequence_and_parallel_matching():
    got = {pkg: _dsl(pkg) for pkg in PKGS}
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert [o if o == "ok" else o[0] for o in got["corda_tpu_torch"]] == [
        "ok", "ExpectationFailed", "ok", "ExpectationFailed",
        "ExpectationFailed", "ok", "ok", "ok"]


def test_expect_over_vault_updates(ledgers):
    """The vault-update stream of the issuing node, and the port's expect
    DSL over the port's stream."""
    assert _cmp(ledgers, "vault_updates") == [
        ([], [1]), ([], [2]), ([], [3]), ([1], [])]
    ex = mod("corda_tpu_torch", "testing.expect")
    VaultUpdate = mod("corda_tpu_torch", "node.vault").VaultUpdate
    ex.run_expectations(ledgers["corda_tpu_torch"]["_updates"], ex.sequence(
        ex.repeat(3, ex.expect(VaultUpdate, lambda u: len(u.produced) == 1
                               and not u.consumed)),
        ex.expect(VaultUpdate, lambda u: len(u.consumed) == 1
                  and not u.produced)))
