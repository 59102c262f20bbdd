"""A validating notary on a replicated commit log, through both packages:
the small twin of chip_smoke.py's phase 7f.

Two banks (an Ed25519 and a secp256k1 identity) each issue COINS USD coins,
one at a time and round-robin, to two Ed25519 payers; the payers make four
two-coin payments of 150.00 USD to a payee at once, a validating notary
resolving each payment's history and committing its inputs through a
RaftUniquenessProvider over three Python replicas. The replicas are bus
endpoints of their own, ticked and drained from a background thread (the
group committer blocks on futures), as the reference's ledger harness
does; ``MockNetwork.run_network(exclude=...)`` leaves them to it. Then a
payer moves a coin a payment consumed: the notary refuses it.

The port's notary verifies through its TpuTransactionVerifierService on a
SignatureBatcher(device="cpu", host_crossover=0): the plain kernels, at
buckets of 8 or less; every other node, and the reference's, verifies in
the flow on the host. Keys, amounts and the issuance order are seeded, so
the issuances' and payments' ids, the double spend's exception type and
message, every replica's applied map and every node's vault and storage
must equal the reference's.

The replay cases hold each backend's refusal — the Raft provider on the
native core, the sharded provider and the BFT provider — on the
reference first, then the port to the same exception, message and
conflicts."""
import hashlib
import random
import threading
import time

import pytest
import torch

from test_torch_raft import PKGS, mod

COINS = 4
PAY_CENTS = 15_000
SCHEMES = ("EDDSA_ED25519_SHA512", "ECDSA_SECP256K1_SHA256")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def coin_cents(coins: int) -> list:
    """100.00 + d cents, d in -coins/2..coins/2 without 0: identical
    issuances would be one transaction."""
    half = coins // 2
    return [10_000 + d for d in range(-half, half + 1) if d]


def _digest(pkg, obj) -> str:
    return hashlib.sha256(
        mod(pkg, "core.serialization").serialize(obj)).hexdigest()


class Pump:
    """Ticks ``rafts`` and drains ``names``' queues on a thread of its own
    until closed."""

    def __init__(self, bus, rafts, names, bft=()):
        self.bus, self.rafts, self.names, self.bft = bus, rafts, names, bft
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            for r in list(self.rafts) + list(self.bft):
                r.tick()
            for name in self.names:
                while self.bus.pump_receive(name) is not None:
                    pass
            time.sleep(0.002)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


def leader_provider(pkg, providers, timeout=15.0):
    leader = mod(pkg, "consensus.raft").LEADER
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        found = [p for p in providers if p.raft.role == leader]
        if len(found) == 1:
            return found[0]
        time.sleep(0.01)
    raise AssertionError("no raft leader elected")


def notarised_run(pkg: str, seed: int = 15) -> dict:
    crypto = mod(pkg, "core.crypto")
    schemes = mod(pkg, "core.crypto.schemes")
    amount = mod(pkg, "core.contracts.amount")
    finance = mod(pkg, "finance")
    cash = mod(pkg, "finance.cash")
    builder_mod = mod(pkg, "core.transactions.builder")
    library = mod(pkg, "flows.library")
    notary_mod = mod(pkg, "node.notary")
    services = mod(pkg, "node.services")
    uniq = mod(pkg, "consensus.raft_uniqueness")
    testing = mod(pkg, "testing")
    rng = random.Random(seed)

    def key(scheme="EDDSA_ED25519_SHA512"):
        return crypto.generate_keypair(getattr(schemes, scheme),
                                       entropy=rng.randbytes(32))

    network = (testing.MockNetwork() if pkg == "corda_tpu"
               else testing.MockNetwork(device="cpu"))
    notary = network.create_node(
        "O=Raft Notary, L=Zurich, C=CH", key_pair=key(),
        advertised_services=(services.ServiceInfo(
            notary_mod.ValidatingNotaryService.type_id),))
    banks = [network.create_node(f"O=Bank {i}, L=London, C=GB",
                                 key_pair=key(s))
             for i, s in enumerate(SCHEMES)]
    payers = [network.create_node(f"O=Payer {i}, L=Oslo, C=NO",
                                  key_pair=key()) for i in range(2)]
    payee = network.create_node("O=Payee, L=Paris, C=FR", key_pair=key())
    network.start_nodes()

    names = [f"raft{i}" for i in range(3)]
    maps = [uniq.DistributedImmutableMap() for _ in names]
    providers = [uniq.RaftUniquenessProvider.build(
        n, names, network.bus.create_node(n), state_machine=maps[i],
        seed=seed + i, native=False) for i, n in enumerate(names)]
    pump = Pump(network.bus, [p.raft for p in providers], names)
    entry = None
    rec = {}
    try:
        entry = leader_provider(pkg, providers)
        notary.install_notary(notary_mod.ValidatingNotaryService,
                              uniqueness=entry)
        if pkg == "corda_tpu_torch":
            from corda_tpu_torch.verifier import (
                SignatureBatcher, TpuTransactionVerifierService)
            notary.services.verifier_service = \
                TpuTransactionVerifierService(batcher=SignatureBatcher(
                    device="cpu", host_crossover=0,
                    interactive_latency_s=0.05))

        def run():
            network.run_network(exclude=names)

        issued = []
        for j, cents in enumerate(coin_cents(COINS)):
            for b, bank in enumerate(banks):
                fsm = bank.start_flow(finance.CashIssueFlow(
                    amount.Amount(cents, amount.USD), b"\x03",
                    payers[(j + b) % len(payers)].party, notary.party))
                run()
                issued.append(fsm.result_future.result(timeout=0).id)
        rec["issued"] = [i.bytes.hex() for i in issued]

        fsms = [p.start_flow(finance.CashPaymentFlow(
            amount.Amount(PAY_CENTS, amount.USD), payee.party))
            for p in payers for _ in range(COINS * len(banks)
                                           // len(payers) // 2)]
        run()
        paid = [f.result_future.result(timeout=0) for f in fsms]
        rec["payments"] = [
            (stx.id.bytes.hex(), len(stx.tx.inputs),
             notary.party.owning_key in {s.by for s in stx.sigs})
            for stx in paid]

        # the double spend: a coin the first payment consumed, moved again
        payer = payers[0]
        spent = next(s for s in payer.services.vault.query(
            cash.CashState, status="consumed")
            if s.ref == paid[0].tx.inputs[0])
        b = builder_mod.TransactionBuilder()
        b.add_input_state(spent)
        b.add_output_state(cash.CashState(spent.state.data.amount,
                                          payee.party.owning_key))
        b.add_command(cash.Move(), payer.party.owning_key)
        double = payer.services.sign_initial_transaction(
            b.to_wire_transaction())
        fsm = payer.start_flow(library.FinalityFlow(double))
        run()
        exc = fsm.result_future.exception(timeout=0)
        rec["double_spend"] = (type(exc).__name__, str(exc))
        rec["double_recorded"] = any(
            n.services.storage.get_transaction(double.id)
            for n in network.nodes)

        # the replicas converge: every one holds each input's payment
        deadline = time.monotonic() + 10
        while not all(m._map == maps[0]._map for m in maps):
            assert time.monotonic() < deadline, "replicas did not converge"
            time.sleep(0.01)
        rec["maps"] = [sorted((_digest(pkg, r), _digest(pkg, d))
                              for r, d in m._map.items()) for m in maps]
        rec["owners"] = sorted((r.txhash.bytes.hex(), r.index,
                                d.consuming_tx.bytes.hex())
                               for r, d in maps[0]._map.items())

        def vault(node, status):
            return sorted((s.ref.txhash.bytes.hex(), s.ref.index,
                           _digest(pkg, s.state))
                          for s in node.services.vault.query(status=status))
        rec["nodes"] = {str(n.party.name): {
            "transactions": sorted(stx.id.bytes.hex() for stx in
                                   n.services.storage.transactions),
            "unconsumed": vault(n, "unconsumed"),
            "consumed": vault(n, "consumed")} for n in network.nodes}
        rec["held"] = sum(
            s.state.data.amount.quantity for n in payers + [payee]
            for s in n.services.vault.unconsumed_states(cash.CashState))
        if pkg == "corda_tpu_torch":
            snap = notary.services.verifier_service.batcher.metrics.snapshot()
            rec["_notary_device_checked"] = snap.get(
                "SigBatcher.DeviceChecked", {}).get("count", 0)
            rec["_notary_host_routed"] = snap.get(
                "SigBatcher.HostRouted", {}).get("count", 0)
    finally:
        pump.close()
        if entry is not None:
            entry.close()
        if pkg == "corda_tpu_torch":
            svc = notary.services.verifier_service
            if svc is not None:
                svc.shutdown()
    return rec


@pytest.fixture(scope="module")
def runs():
    return {pkg: notarised_run(pkg) for pkg in PKGS}


def _cmp(runs, key):
    port, ref = runs["corda_tpu_torch"][key], runs["corda_tpu"][key]
    assert port == ref
    return port


def test_issuances_and_payments_equal_the_references(runs):
    assert len(_cmp(runs, "issued")) == 2 * COINS
    payments = _cmp(runs, "payments")
    assert len(payments) == COINS
    # every payment notarised, each spending two coins
    assert all(n_in == 2 and signed for _, n_in, signed in payments)


def test_the_double_spend_is_refused_as_the_reference_refuses_it(runs):
    kind, message = _cmp(runs, "double_spend")
    assert kind == "NotaryException"
    assert message.startswith("Input states already consumed: ")
    assert _cmp(runs, "double_recorded") is False


def test_replicas_vaults_and_storage_equal_the_references(runs):
    maps = _cmp(runs, "maps")
    assert all(m == maps[0] for m in maps) and len(maps[0]) == 2 * COINS
    owners = _cmp(runs, "owners")
    payments = {tx for tx, _, _ in runs["corda_tpu"]["payments"]}
    assert {tx for _, _, tx in owners} == payments
    _cmp(runs, "nodes")
    assert _cmp(runs, "held") == sum(coin_cents(COINS)) * 2
    port = runs["corda_tpu_torch"]
    # the port's notary verified on the batcher's device route
    assert port["_notary_device_checked"] > 0
    assert port["_notary_host_routed"] == 0


# -- each backend's refusal ---------------------------------------------------

def _refs(pkg, tag: str, n: int):
    structures = mod(pkg, "core.contracts.structures")
    sh = mod(pkg, "core.crypto.secure_hash").SecureHash
    return [structures.StateRef(sh.sha256(f"{tag}:{i}".encode()), i)
            for i in range(n)]


def replay(pkg: str, backend: str) -> list:
    """Commit four refs under one transaction, then replay them under a
    fresh id: the replay's outcome (exception type and message) and its
    conflicts' consuming transactions."""
    inmemory = mod(pkg, "network.inmemory")
    uniq = mod(pkg, "consensus.raft_uniqueness")
    sh = mod(pkg, "core.crypto.secure_hash").SecureHash
    bus = inmemory.InMemoryMessagingNetwork()
    closers, rafts, bft_replicas, names = [], [], [], []

    def raft_group(prefix, seed, native):
        group = [f"{prefix}{i}" for i in range(3)]
        providers = [uniq.RaftUniquenessProvider.build(
            n, group, bus.create_node(n),
            state_machine=uniq.DistributedImmutableMap(), seed=seed + i,
            native=native) for i, n in enumerate(group)]
        rafts.extend(p.raft for p in providers)
        names.extend(group)
        return providers

    if backend == "raft":
        group = raft_group("raft", 5, None)
        assert all(type(p.raft).__name__ == "NativeRaftNode" for p in group)
    elif backend == "sharded":
        groups = [raft_group(f"s{s}r", 5 + 31 * s, False) for s in range(2)]
    else:
        bft = mod(pkg, "consensus.bft")
        bft_names = [f"bft{i}" for i in range(4)]
        for n in bft_names:
            sm = uniq.DistributedImmutableMap()
            bft_replicas.append(bft.BFTReplica(n, bft_names,
                                               bus.create_node(n), sm.apply))
        client = bft.BFTClient("client", bft_names, bus.create_node("client"))
        names.extend(bft_names + ["client"])
        provider = bft.BFTUniquenessProvider(client)
    pump = Pump(bus, rafts, names, bft_replicas)
    try:
        if backend == "raft":
            provider = leader_provider(pkg, group)
            closers.append(provider)
        elif backend == "sharded":
            sharded = mod(pkg, "consensus.sharded_uniqueness")
            provider = sharded.ShardedUniquenessProvider(
                [leader_provider(pkg, g) for g in groups])
            closers.append(provider)
        refs = _refs(pkg, backend, 4)
        original = sh.sha256(b"original")
        provider.commit(refs, original, "O=Payer, L=Oslo, C=NO")
        try:
            provider.commit(refs, sh.sha256(b"replay"),
                            "O=Replay, L=Oslo, C=NO")
            return [("committed",)]
        except Exception as exc:   # the outcome under comparison
            conflicts = getattr(exc, "conflicts", {})
            return [(type(exc).__name__, str(exc)),
                    sorted((r.index, d.consuming_tx == original)
                           for r, d in conflicts.items())]
    finally:
        pump.close()
        for c in closers:
            c.close()


@pytest.mark.parametrize("backend", ("raft", "sharded", "bft"))
def test_a_replay_is_refused_as_the_reference_refuses_it(backend):
    ref = replay("corda_tpu", backend)
    assert ref[0][0] == "UniquenessException"
    assert ref[1] and all(same for _, same in ref[1])
    assert replay("corda_tpu_torch", backend) == ref
