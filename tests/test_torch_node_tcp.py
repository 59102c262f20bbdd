"""The port's node runtime over TCP against the JAX package's: the TCP plane,
mutual TLS, the network map, the doorman's enrolment, the RPC surface, the
Node built from configuration and the verifier worker process.

Every case of tests/test_{tcp_limits,tls,trace_propagation,chaos_faults,
rpc_netmap,chaos_breaker}.py runs on the port's twin (its source with every
``corda_tpu.`` module naming ``corda_tpu_torch.``, batchers and
MockNetworks on the CPU), with its own fixtures and this run's
``tmp_path`` / ``monkeypatch``; so do the ``node/rpc.py`` case of
tests/test_audit.py and the four registration cases of
tests/test_finance_tail.py (on both packages, ledgers compared, as
tests/test_torch_finance.py runs those files' other cases) and the
``node.node`` case of tests/test_verify_suspension.py.

Then the same inputs through both packages: TCP frames are byte-identical on
the wire for the same messages; signed network-map registrations are
byte-identical for the same key seed, and each package's map service takes
the other's; ``health()`` has the same keys; and a worker process,
``python -m corda_tpu_torch.verifier --device cpu``, verifies transactions
for a port Node with the verdicts of the reference's host route. Three port
Nodes over loopback TCP pay as the reference's flows do on its MockNetwork:
the reference's own Nodes cannot finish those payments over TCP (ROADMAP.md
section C: its validating notary cannot checkpoint, and a flow whose host
verification resolved before it parked never resumes). Every comparison is
exact."""
import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from corda_tpu.core.serialization import serialize as j_serialize
from corda_tpu_torch.core.serialization import deserialize as t_deserialize

from test_torch_finance import reference_cases, run_case, run_on_both
from test_torch_flow_framework import PKGS, mock_network, mod
from test_torch_raft import twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Each reference file's lines that build a batcher or a MockNetwork, the
#: port's on the CPU.
SUBS = {
    "test_chaos_breaker": (
        ("SignatureBatcher(host_crossover=1,",
         'SignatureBatcher(device="cpu", host_crossover=1,'),
        ("SignatureBatcher(use_device=False)",
         'SignatureBatcher(use_device=False, device="cpu")'),
        ("MockNetwork()", 'MockNetwork(device="cpu")')),
    "test_rpc_netmap": (("MockNetwork()", 'MockNetwork(device="cpu")'),),
}
TWIN_FILES = ("test_tcp_limits", "test_tls", "test_trace_propagation",
              "test_chaos_faults", "test_rpc_netmap", "test_chaos_breaker")
TWIN_CASES = [c for name in TWIN_FILES for c in reference_cases(name)]
REGISTRATION = ("test_registration_auto_approval",
                "test_registration_manual_approval_and_rejections",
                "test_registration_survives_doorman_restart_and_crash_windows",
                "test_registration_timeout_when_never_approved")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_the_cases_cover_the_reference_files():
    by_file = {}
    for case in TWIN_CASES:
        by_file[case.values[0]] = by_file.get(case.values[0], 0) + 1
    assert by_file == {"test_tcp_limits": 3, "test_tls": 5,
                       "test_trace_propagation": 4, "test_chaos_faults": 22,
                       "test_rpc_netmap": 2, "test_chaos_breaker": 8}


@pytest.mark.parametrize("name,attr,params", TWIN_CASES)
def test_reference_case_on_the_port(name, attr, params, monkeypatch):
    module = twin(name, SUBS.get(name, ()))
    record = run_case("corda_tpu_torch", module, attr,
                      {**params, "monkeypatch": monkeypatch}, monkeypatch)
    assert record["outcome"] == ("ok",)


def test_audit_rpc_case(monkeypatch):
    run_on_both("test_audit", "test_flow_lifecycle_and_permission_events",
                {}, monkeypatch)


@pytest.mark.parametrize("attr", REGISTRATION)
def test_registration_case(attr, monkeypatch):
    run_on_both("test_finance_tail", attr, {}, monkeypatch)


def test_node_configuration_case(monkeypatch):
    module = twin("test_verify_suspension")
    record = run_case("corda_tpu_torch", module,
                      "test_mesh_devices_requires_tpu_verifier", {},
                      monkeypatch)
    assert record["outcome"] == ("ok",)


def test_tls_fails_as_the_reference_without_cryptography(tmp_path,
                                                         monkeypatch):
    """Where ``cryptography`` is missing (the card's machine), the port's
    TLS and enrolment raise ImportError exactly where the reference's do:
    at the first certificate, not at import."""
    for name in [n for n in sys.modules if n.startswith("cryptography")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "cryptography", None)
    outcomes = {}
    for pkg in PKGS:
        tls = mod(pkg, "network.tls")
        registration = mod(pkg, "network.registration")
        got = []
        for fn in (lambda: tls.ensure_dev_ca(str(tmp_path / pkg)),
                   lambda: registration.build_csr("O=Bank, L=London, C=GB",
                                                  None)):
            try:
                fn()
                got.append("ok")
            except Exception as exc:   # the outcome under comparison
                got.append(type(exc).__name__)
        outcomes[pkg] = got
    assert outcomes["corda_tpu_torch"] == outcomes["corda_tpu"] \
        == ["ModuleNotFoundError", "ModuleNotFoundError"]


# -- the same inputs through both packages ------------------------------------

MESSAGES = (("platform.session", 0, b"init", None),
            ("platform.session", 7, bytes(range(256)) * 9,
             ("deadbeef01020304", "cafe050607080900")),
            ("rpc.requests", 1, b"", None),
            ("verifier.requests", 2 ** 40, b"\x00" * 70_000,
             ("0" * 32, "1" * 16)))


def _frames(pkg: str) -> list:
    """The frames ``pkg``'s TCP plane writes to a raw socket for MESSAGES,
    split by their length headers."""
    tcp = mod(pkg, "network.tcp")
    messaging = mod(pkg, "network.messaging")
    sink = socket.socket()
    sink.bind(("127.0.0.1", 0))
    sink.listen(1)
    port = sink.getsockname()[1]
    svc = tcp.TcpMessagingService(
        "alice", "127.0.0.1", 0,
        lambda name: ("127.0.0.1", port) if name == "sink" else None)
    try:
        for topic, session, payload, trace in MESSAGES:
            svc.send(messaging.TopicSession(topic, session), payload, "sink",
                     trace=trace)
        conn, _ = sink.accept()
        conn.settimeout(10)
        data, frames = b"", []
        while len(frames) < len(MESSAGES):
            data += conn.recv(1 << 20)
            while len(data) >= 4:
                n = int.from_bytes(data[:4], "big")
                if len(data) < 4 + n:
                    break
                frames.append(data[:4 + n])
                data = data[4 + n:]
        conn.close()
        return frames
    finally:
        svc.stop()
        sink.close()


def test_tcp_frames_are_byte_identical():
    ref, port = (_frames(pkg) for pkg in PKGS)
    assert port == ref
    assert len(ref) == len(MESSAGES)
    assert ref[1][4:] != ref[0][4:]


def _registration(pkg: str):
    network = mock_network(pkg)
    alpha = network.create_node("O=Alpha, L=Oslo, C=NO")
    network.start_nodes()
    netmap = mod(pkg, "network.netmap")
    ser = mod(pkg, "core.serialization").serialize
    regs = [ser(netmap.make_registration(alpha.services, alpha.info, serial,
                                         kind))
            for serial, kind in ((1_700_000_000_001, netmap.ADD),
                                 (1_700_000_000_002, netmap.REMOVE))]
    return regs, ser(alpha.info)


def _map_service(pkg: str):
    """A map service of ``pkg`` on a bus of its own, and its node cache."""
    network = mock_network(pkg)
    mapnode = network.create_node("O=Map Service, L=London, C=GB")
    network.start_nodes()
    svc = mod(pkg, "network.netmap").NetworkMapService(
        mapnode.messaging, local_cache=mapnode.services.network_map_cache)
    return svc, mapnode.services.network_map_cache


def test_netmap_registrations_are_byte_identical():
    ref, port = (_registration(pkg) for pkg in PKGS)
    assert port == ref
    # each package's map service takes the other's signed registration
    j_deser = mod("corda_tpu", "core.serialization").deserialize
    for pkg, regs, deser in (("corda_tpu", port[0], j_deser),
                             ("corda_tpu_torch", ref[0], t_deserialize)):
        svc, cache = _map_service(pkg)
        svc.apply_registration(deser(regs[0]))
        assert cache.party_from_name("O=Alpha, L=Oslo, C=NO") is not None
        svc.apply_registration(deser(regs[1]))
        assert cache.party_from_name("O=Alpha, L=Oslo, C=NO") is None


def _shape(value):
    """The keys of nested dicts, values dropped."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    return None


def _health(pkg: str) -> dict:
    """health() of a plain node, of a node with a device-batched service on
    the host route and on the device route, of a node with an out-of-process
    queue (no worker) and of a notary node."""
    network = mock_network(pkg)
    notary = network.create_notary_node()
    alice = network.create_node("O=Alice, L=Madrid, C=ES")
    network.start_nodes()
    rpc = mod(pkg, "node.rpc")
    svc_mod = mod(pkg, "verifier.service")
    batcher_cls = mod(pkg, "verifier.batcher").SignatureBatcher
    oop = mod(pkg, "verifier.out_of_process")
    kw = {} if pkg == "corda_tpu" else {"device": "cpu"}
    out = {"plain": rpc.CordaRPCOps(alice.services, alice.smm).health(),
           "notary": rpc.CordaRPCOps(notary.services, notary.smm).health()}
    for label, use_device in (("host", False), ("device", True)):
        svc = svc_mod.TpuTransactionVerifierService(
            workers=1, batcher=batcher_cls(use_device=use_device, **kw))
        alice.services.verifier_service = svc
        try:
            out[label] = rpc.CordaRPCOps(alice.services, alice.smm).health()
        finally:
            alice.services.verifier_service = None
            svc.shutdown()
    svc = oop.OutOfProcessTransactionVerifierService(alice.messaging,
                                                     expected_workers=2)
    alice.services.verifier_service = svc
    try:
        out["oop"] = rpc.CordaRPCOps(alice.services, alice.smm).health()
    finally:
        alice.services.verifier_service = None
        svc.shutdown()
    return out


def test_health_keys_agree():
    ref, port = (_health(pkg) for pkg in PKGS)
    assert _shape(port) == _shape(ref)
    assert "device_tables_warm" in ref["device"]["checks"]
    assert ref["oop"]["checks"]["fleet_workers_attached"] is False
    for label in ("plain", "notary", "host", "oop"):
        assert port[label] == ref[label], label


# -- Nodes over loopback TCP ----------------------------------------------------

def _wait(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def _config(pkg: str, tmp, name: str, seed: int, **kw):
    node_mod = mod(pkg, "node.node")
    if pkg == "corda_tpu_torch":
        kw["device"] = "cpu"
    return node_mod.NodeConfiguration(
        my_legal_name=name, base_directory=str(tmp / pkg / str(seed)),
        key_seed_hex=bytes([seed]).hex() * 32,
        cordapps=[f"{pkg}.finance", f"{pkg}.testing.dummy"], **kw)


def _payments(pkg: str, run, bank, buyer, notary_party,
              payments: int) -> None:
    """The bank issues 1,000.00 USD to itself, pays the buyer ``payments``
    times, and the buyer pays 5.00 back."""
    amount = mod(pkg, "core.contracts.amount")
    usd = amount.USD
    run(bank, "CashIssueFlow", amount.Amount(100_000, usd), b"\x01",
        bank.party, notary_party)
    for i in range(payments):
        run(bank, "CashPaymentFlow", amount.Amount(1_000 + i, usd),
            buyer.party)
    run(buyer, "CashPaymentFlow", amount.Amount(500, usd), bank.party)


def _cash(pkg: str, node) -> list:
    return sorted(s.state.data.amount.quantity
                  for s in node.services.vault.unconsumed_states(
                      mod(pkg, "finance").CashState))


def _tcp_network(tmp, payments: int) -> dict:
    """The port's Nodes over loopback TCP: a map node that is also a
    validating notary, a bank and a buyer, flows started through their RPC
    ops on their node threads."""
    pkg = "corda_tpu_torch"
    node_mod = mod(pkg, "node.node")
    mapnode = node_mod.Node(_config(
        pkg, tmp, "O=Map Notary, L=Zurich, C=CH", 1,
        notary="validating")).start()
    addr = f"127.0.0.1:{mapnode.messaging.port}"
    peers = [node_mod.Node(_config(
        pkg, tmp, name, seed, network_map_name=str(mapnode.party.name),
        network_map_address=addr)).start()
        for name, seed in (("O=Bank, L=London, C=GB", 2),
                           ("O=Buyer, L=Paris, C=FR", 3))]
    nodes = [mapnode, *peers]
    bank, buyer = peers
    try:
        for node in nodes:
            _wait(lambda node=node: len(
                node.services.network_map_cache.all_nodes()) >= 3,
                30, "the network map did not spread")

        def run(node, flow, *args):
            fsm = node.executor.fetch_from(
                lambda: node.rpc_ops.start_flow_dynamic(flow, *args)
            ).result(timeout=30)
            return fsm.result_future.result(timeout=60)

        _payments(pkg, run, bank, buyer, mapnode.party, payments)
        return {"bank": _cash(pkg, bank), "buyer": _cash(pkg, buyer),
                "committed": len(mapnode.notary_service.uniqueness),
                "ready": [node.rpc_ops.health()["ready"] for node in nodes]}
    finally:
        for node in reversed(nodes):
            node.stop()


def _mock_network(pkg: str, payments: int) -> dict:
    """The same flows on ``pkg``'s MockNetwork with a validating notary."""
    network = mock_network(pkg)
    notary = network.create_notary_node(validating=True)
    bank = network.create_node("O=Bank, L=London, C=GB")
    buyer = network.create_node("O=Buyer, L=Paris, C=FR")
    network.start_nodes()

    def run(node, flow, *args):
        fsm = node.start_flow(getattr(mod(pkg, "finance"), flow)(*args))
        network.run_network()
        return fsm.result_future.result(timeout=30)

    _payments(pkg, run, bank, buyer, notary.party, payments)
    return {"bank": _cash(pkg, bank), "buyer": _cash(pkg, buyer),
            "committed": len(notary.notary_service.uniqueness),
            "ready": [True] * 3}


def test_nodes_over_tcp_pay_as_the_reference(tmp_path):
    """Three port Nodes over loopback TCP end where the reference's flows
    end on its MockNetwork, and so do the port's."""
    ref = _mock_network("corda_tpu", 3)
    assert _mock_network("corda_tpu_torch", 3) == ref
    assert _tcp_network(tmp_path, 3) == ref
    assert sum(ref["bank"]) + sum(ref["buyer"]) == 100_000
    assert sum(ref["buyer"]) == 1_000 + 1_001 + 1_002 - 500


def test_a_completion_posted_on_the_node_thread_runs_after_the_step():
    """A Node's async completions re-enter its flows through
    ``SerialExecutor.post``: queued even when posted from the node thread,
    so a verify that resolved before its flow parked resumes the flow
    after it parked (``execute`` there runs inline)."""
    affinity = mod("corda_tpu_torch", "utils.affinity")
    ex = affinity.SerialExecutor("node-thread(test)")
    order = []
    try:
        def step():
            ex.post(lambda: order.append("completion"))
            ex.execute(lambda: order.append("inline"))
            order.append("parked")
        ex.fetch_from(step).result(timeout=5)
        ex.fetch_from(lambda: None).result(timeout=5)
    finally:
        ex.shutdown()
    assert order == ["inline", "parked", "completion"]


# -- the worker as its own process ---------------------------------------------

@pytest.mark.medium
def test_worker_process_verifies_for_a_port_node(tmp_path):
    """``python -m corda_tpu_torch.verifier --device cpu`` attaches to a port
    Node's out-of-process queue over loopback TCP and verifies valid and
    tampered transactions with the reference host route's verdicts; on
    SIGTERM it exits 0 and its stats file shows the plain kernels' work."""
    from test_verify_suspension import make_issue_stx, seed_services
    from corda_tpu.network.inmemory import InMemoryMessagingNetwork
    from corda_tpu.verifier.batcher import SignatureBatcher as JBatcher
    from corda_tpu.verifier.out_of_process import (
        OutOfProcessTransactionVerifierService, VerifierWorker)

    svcs = seed_services(None)
    stxs = [make_issue_stx(svcs, i) for i in range(3)]
    sig = stxs[1].sigs[0]
    stxs[1] = stxs[1].__class__(stxs[1].tx_bits, (sig.__class__(
        sig.bytes[:-1] + bytes([sig.bytes[-1] ^ 1]), sig.by),))

    def verdicts(futures, pump=None):
        deadline = time.monotonic() + 120
        while pump is not None and not all(f.done() for f in futures):
            assert time.monotonic() < deadline, "no verdicts"
            pump()
            time.sleep(0.005)
        out = []
        for f in futures:
            try:
                f.result(timeout=120)
                out.append("ok")
            except Exception as exc:   # the verdict under comparison
                out.append((type(exc).__name__, str(exc)))
        return out

    # the reference: its out-of-process service and a host-route worker
    bus = InMemoryMessagingNetwork()
    ref_svc = OutOfProcessTransactionVerifierService(bus.create_node("node"))
    ref_worker = VerifierWorker(bus.create_node("w1"), "node",
                                batcher=JBatcher(use_device=False))
    try:
        bus.run_network()
        want = verdicts([ref_svc.verify_signed(stx, svcs) for stx in stxs],
                        pump=bus.run_network)
    finally:
        ref_worker.stop()
        ref_svc.shutdown()

    node_mod = mod("corda_tpu_torch", "node.node")
    node = node_mod.Node(_config(
        "corda_tpu_torch", tmp_path, "O=Bank, L=London, C=GB", 4,
        verifier_type="OutOfProcess", verifier_workers=1)).start()
    t_svcs = mod("corda_tpu_torch", "testing").MockServices(
        key_pairs=[], parties=[])
    stats = tmp_path / "worker-stats.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "corda_tpu_torch.verifier",
         "--queue-address", f"127.0.0.1:{node.messaging.port}",
         "--device", "cpu", "--host-crossover", "0",
         "--stats-file", str(stats)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("VERIFIER READY"), (line, proc.stderr.read()
                                                   if proc.poll() else "")
        svc = node.services.verifier_service
        _wait(lambda: svc.queue.worker_count >= 1, 60,
              "the worker did not attach")
        assert node.rpc_ops.health()["checks"]["fleet_workers_attached"]
        got = verdicts([svc.verify_signed(
            t_deserialize(j_serialize(stx)), t_svcs) for stx in stxs])
        proc.terminate()
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        node.stop()
    assert got == want
    assert [v if v == "ok" else v[0] for v in want] == [
        "ok", "TransactionVerificationException", "ok"]
    report = json.loads(stats.read_text())
    assert report["processed_sig_count"] >= 3
    assert report["metrics"]["SigBatcher.DeviceChecked"]["count"] >= 3
    assert set(report["launches"]) == {"ed25519_split_verify",
                                       "secp256k1_hybrid_verify",
                                       "secp256r1_split_verify"}
