"""Notary demo: issue-and-move chains against each notary backend.

Reference parity: samples/notary-demo (SingleNotaryCordform /
RaftNotaryCordform + DummyIssueAndMove): run N issue+move rounds against a
simple, a validating, and a Raft-replicated notary, reporting signatures
obtained and double-spends rejected.

A copy of the reference's module; ``run_demo``, ``run_raft_demo`` and
``run_bft_demo`` take ``device=`` (default "cuda", raising without CUDA)
and hand it to ``MockNetwork(device=)``.
"""
from __future__ import annotations

from ..core.contracts.structures import StateAndRef, StateRef
from ..core.transactions.builder import TransactionBuilder
from ..device import DEFAULT_DEVICE
from ..flows.library import FinalityFlow, NotaryException, NotaryFlow
from ..testing import DummyContract, DummyState, MockNetwork


def dummy_issue_and_move(network, node, notary_party, magic: int):
    """The DummyIssueAndMove flow pair as plain builder steps."""
    builder = TransactionBuilder(notary=notary_party)
    builder.add_output_state(DummyState(magic, (node.party.owning_key,)))
    builder.add_command(DummyContract.Create(), node.party.owning_key)
    stx = node.services.sign_initial_transaction(builder.to_wire_transaction())
    fsm = node.start_flow(FinalityFlow(stx))
    network.run_network()
    issued = fsm.result_future.result(timeout=5)
    sref = StateAndRef(issued.tx.outputs[0], StateRef(issued.id, 0))

    builder = TransactionBuilder()
    builder.add_input_state(sref)
    builder.add_output_state(DummyState(magic + 1, (node.party.owning_key,)))
    builder.add_command(DummyContract.Move(), node.party.owning_key)
    move = node.services.sign_initial_transaction(builder.to_wire_transaction())
    fsm = node.start_flow(FinalityFlow(move))
    network.run_network()
    return fsm.result_future.result(timeout=5), sref, move


def run_demo(rounds: int = 3, validating: bool = False,
             device=DEFAULT_DEVICE):
    network = MockNetwork(device=device)
    notary = network.create_notary_node(validating=validating)
    party = network.create_node("O=Counterparty, L=Oslo, C=NO")
    network.start_nodes()

    notarised, conflicts = 0, 0
    for i in range(rounds):
        final, sref, _ = dummy_issue_and_move(network, party,
                                              notary.party, magic=i * 10)
        notarised += 1
        # attempt a double spend of the same issued state: must conflict
        builder = TransactionBuilder()
        builder.add_input_state(sref)
        builder.add_output_state(DummyState(999, (party.party.owning_key,)))
        builder.add_command(DummyContract.Move(), party.party.owning_key)
        dbl = party.services.sign_initial_transaction(
            builder.to_wire_transaction())
        fsm = party.start_flow(NotaryFlow(dbl))
        network.run_network()
        try:
            fsm.result_future.result(timeout=5)
        except NotaryException:
            conflicts += 1
    return {"network": network, "notary": notary, "notarised": notarised,
            "conflicts": conflicts}


def run_raft_demo(rounds: int = 2, device=DEFAULT_DEVICE):
    """The Raft cluster variant: the notary's commit log is a 3-replica
    DistributedImmutableMap. The notary flow's `commit` BLOCKS on consensus,
    so a background thread pumps raft ticks + the raft endpoints' bus queues
    (only those — the SMM endpoints stay single-threaded) while the main
    thread runs the network (RaftNotaryCordform's timer role)."""
    import threading
    import time as _time

    from ..consensus.raft import LEADER
    from ..consensus.raft_uniqueness import (DistributedImmutableMap,
                                             RaftUniquenessProvider)
    from ..node.notary import SimpleNotaryService
    from ..node.services import ServiceInfo

    network = MockNetwork(device=device)
    notary = network.create_node(
        "O=Raft Notary, L=Zurich, C=CH",
        advertised_services=(ServiceInfo("corda.notary.simple"),))
    party = network.create_node("O=Counterparty, L=Oslo, C=NO")
    network.start_nodes()

    # the raft cluster rides the same in-memory bus as extra endpoints
    names = ["raft0", "raft1", "raft2"]
    machines = [DistributedImmutableMap() for _ in names]
    providers = [RaftUniquenessProvider.build(
        n, names, network.bus.create_node(n), state_machine=machines[i],
        seed=i) for i, n in enumerate(names)]
    raft_nodes = [p.raft for p in providers]
    raft_names = set(names)
    stop = threading.Event()

    def raft_pump():
        while not stop.is_set():
            for rn in raft_nodes:
                rn.tick()
            for name in names:
                while network.bus.pump_receive(name) is not None:
                    pass
            _time.sleep(0.002)

    pump_thread = threading.Thread(target=raft_pump, daemon=True)
    pump_thread.start()
    deadline = _time.monotonic() + 10
    while not any(rn.role == LEADER for rn in raft_nodes):
        if _time.monotonic() > deadline:
            raise TimeoutError("no raft leader elected")
        _time.sleep(0.01)
    leader = next(rn for rn in raft_nodes if rn.role == LEADER)
    provider = providers[raft_nodes.index(leader)]

    svc = SimpleNotaryService(notary.services, uniqueness=provider)
    svc.install(notary.smm)

    notarised = 0
    try:
        for i in range(rounds):
            builder = TransactionBuilder(notary=notary.party)
            builder.add_output_state(DummyState(i, (party.party.owning_key,)))
            builder.add_command(DummyContract.Create(), party.party.owning_key)
            stx = party.services.sign_initial_transaction(
                builder.to_wire_transaction())
            fsm = party.start_flow(FinalityFlow(stx))
            network.run_network(exclude=raft_names)
            issued = fsm.result_future.result(timeout=5)
            sref = StateAndRef(issued.tx.outputs[0], StateRef(issued.id, 0))

            builder = TransactionBuilder()
            builder.add_input_state(sref)
            builder.add_output_state(DummyState(i + 1,
                                                (party.party.owning_key,)))
            builder.add_command(DummyContract.Move(), party.party.owning_key)
            move = party.services.sign_initial_transaction(
                builder.to_wire_transaction())
            fsm = party.start_flow(NotaryFlow(move))
            # run_network drives the notary flow, whose commit blocks until
            # the background raft pump reaches consensus
            deadline = _time.monotonic() + 30
            while not fsm.result_future.done():
                network.run_network(exclude=raft_names)
                if _time.monotonic() > deadline:
                    raise TimeoutError("raft notarisation stalled")
                _time.sleep(0.01)
            fsm.result_future.result(timeout=1)
            notarised += 1
    finally:
        stop.set()
        pump_thread.join(timeout=5)
    replicas_agree = all(len(m) == len(machines[0]) for m in machines)
    return {"notarised": notarised, "replicas_agree": replicas_agree,
            "commit_log_size": len(machines[0])}


def run_bft_demo(rounds: int = 2, device=DEFAULT_DEVICE):
    """The BFT cluster variant (the reference's BFTNotaryCordform analog):
    a 4-replica (f = 1) PBFT cluster totally orders the notary commit log;
    the uniqueness provider submits through the BFT client and accepts on an
    f+1 matching-reply quorum. Pump threading mirrors run_raft_demo — the
    BFT endpoints drain on a background thread while the main thread runs
    the node network."""
    import threading
    import time as _time

    from ..consensus.bft import BFTClient, BFTReplica, BFTUniquenessProvider
    from ..consensus.raft_uniqueness import DistributedImmutableMap
    from ..node.notary import SimpleNotaryService
    from ..node.services import ServiceInfo

    network = MockNetwork(device=device)
    notary = network.create_node(
        "O=BFT Notary, L=Zurich, C=CH",
        advertised_services=(ServiceInfo("corda.notary.simple"),))
    party = network.create_node("O=Counterparty, L=Oslo, C=NO")
    network.start_nodes()

    names = [f"bft{i}" for i in range(4)]
    machines = [DistributedImmutableMap() for _ in names]
    replicas = [BFTReplica(n, names, network.bus.create_node(n),
                           machines[i].apply,
                           snapshot_fn=machines[i].snapshot,
                           restore_fn=machines[i].restore)
                for i, n in enumerate(names)]
    client = BFTClient("bft-client", names,
                       network.bus.create_node("bft-client"))
    provider = BFTUniquenessProvider(client)
    bft_names = set(names) | {"bft-client"}
    stop = threading.Event()

    def bft_pump():
        while not stop.is_set():
            for r in replicas:
                r.tick()
            for name in bft_names:
                while network.bus.pump_receive(name) is not None:
                    pass
            _time.sleep(0.002)

    pump_thread = threading.Thread(target=bft_pump, daemon=True)
    pump_thread.start()

    svc = SimpleNotaryService(notary.services, uniqueness=provider)
    svc.install(notary.smm)

    notarised = 0
    try:
        for i in range(rounds):
            builder = TransactionBuilder(notary=notary.party)
            builder.add_output_state(DummyState(i, (party.party.owning_key,)))
            builder.add_command(DummyContract.Create(), party.party.owning_key)
            stx = party.services.sign_initial_transaction(
                builder.to_wire_transaction())
            fsm = party.start_flow(FinalityFlow(stx))
            network.run_network(exclude=bft_names)
            issued = fsm.result_future.result(timeout=5)
            sref = StateAndRef(issued.tx.outputs[0], StateRef(issued.id, 0))

            builder = TransactionBuilder()
            builder.add_input_state(sref)
            builder.add_output_state(DummyState(i + 1,
                                                (party.party.owning_key,)))
            builder.add_command(DummyContract.Move(), party.party.owning_key)
            move = party.services.sign_initial_transaction(
                builder.to_wire_transaction())
            fsm = party.start_flow(NotaryFlow(move))
            deadline = _time.monotonic() + 30
            while not fsm.result_future.done():
                network.run_network(exclude=bft_names)
                if _time.monotonic() > deadline:
                    raise TimeoutError("bft notarisation stalled")
                _time.sleep(0.01)
            fsm.result_future.result(timeout=1)
            notarised += 1
    finally:
        stop.set()
        pump_thread.join(timeout=5)
    replicas_agree = all(len(m) == len(machines[0]) for m in machines)
    return {"notarised": notarised, "replicas_agree": replicas_agree,
            "commit_log_size": len(machines[0]),
            "executed_through": [r.executed_through for r in replicas]}


def main() -> None:
    out = run_demo(rounds=3)
    print(f"simple notary: {out['notarised']} notarised, "
          f"{out['conflicts']}/{out['notarised']} double-spends rejected")
    out = run_demo(rounds=2, validating=True)
    print(f"validating notary: {out['notarised']} notarised, "
          f"{out['conflicts']} double-spends rejected")
    out = run_raft_demo(rounds=2)
    print(f"raft notary: {out['notarised']} notarised over a 3-replica "
          f"commit log (replicas agree: {out['replicas_agree']})")
    out = run_bft_demo(rounds=2)
    print(f"bft notary: {out['notarised']} notarised over a 4-replica "
          f"(f=1) PBFT cluster (replicas agree: {out['replicas_agree']})")


if __name__ == "__main__":
    main()
