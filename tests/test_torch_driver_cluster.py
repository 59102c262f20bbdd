"""The node CLI's device, the driver's hand-over of it, a restart from
checkpoints, the load test over a driver cluster and DemoBench's
configurations, against the JAX package's where both run: real node
processes (``python -m corda_tpu_torch.node``) on the CPU.

The node CLI boots on ``--device cpu`` and, without ``--device`` on a
machine without CUDA, exits non-zero with ``resolve_device``'s message (no
fallback to the CPU); ``DriverDSL(device=...)`` hands its device to every
node and worker command it spawns (``--no-device`` workers keep the host
route); a node restarted with a checkpointed flow that ends a session at
once boots (it restores after the network map answered); both packages'
``run_driver_cluster_load`` on one CPU cluster of port nodes, each over its
own two parties with a kill and restart, report the same keys and kinds of
values and conserve value; and both packages' DemoBench write the same
node configurations but for ``device`` and the cordapp's module name."""
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

import corda_tpu.finance  # noqa: F401 — wire types of the reference's flows
import corda_tpu_torch.finance  # noqa: F401 — the port's client-side types
from test_torch_flow_framework import PKGS, mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the node CLI's device ----------------------------------------------------

def _node(tmp_path, *flags, timeout=120):
    return subprocess.Popen(
        [sys.executable, "-m", "corda_tpu_torch.node", "--name",
         "O=Solo, L=London, C=GB", "--base-dir", str(tmp_path), "--quiet",
         *flags], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_node_cli_boots_on_the_device_it_is_given(tmp_path):
    driver = mod("corda_tpu_torch", "testing.driver")
    proc = _node(tmp_path, "--device", "cpu", "--verifier-type", "Tpu",
                 "--host-crossover", "0")
    try:
        host, port = driver.await_node_ready(proc, "solo", 120.0)
        rpc = mod("corda_tpu_torch", "client.rpc").CordaRPCClient(host, port)
        try:
            assert str(rpc.node_identity().legal_identity.name) == \
                "O=Solo, L=London, C=GB"
            checks = rpc.health()["checks"]
            assert checks["batcher_dispatcher_alive"]
            assert "kernels" in rpc.profile_snapshot()
        finally:
            rpc.close()
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0


def test_node_cli_without_device_refuses_a_machine_without_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    proc = _node(tmp_path)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "device 'cuda' requested but torch.cuda.is_available() is " \
        "False" in out
    assert "NODE READY" not in out


def test_node_cli_host_crossover_needs_a_tpu_verifier(tmp_path):
    proc = _node(tmp_path, "--device", "cpu", "--host-crossover", "0")
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 2
    assert "--host-crossover requires --verifier-type Tpu" in out


class RecordingRunner:
    """A NodeRunner that records each command and answers with the READY
    line the driver waits for."""

    class Handle:
        def __init__(self, line: str):
            self.stdout = iter([line])
            self.pid = None

        def poll(self):
            return 0

        def terminate(self):
            pass

        def kill(self):
            pass

        def wait(self, timeout=None):
            return 0

    def __init__(self):
        self.commands = []

    def spawn(self, cmd, env=None, cwd=None):
        self.commands.append(cmd)
        ready = ("VERIFIER READY" if cmd[2].endswith("verifier")
                 else "NODE READY x")
        return self.Handle(f"{ready} 127.0.0.1:{len(self.commands)}\n")

    def prepare_dir(self, path):
        pass


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_driver_hands_its_device_to_every_process(tmp_path, device):
    driver = mod("corda_tpu_torch", "testing.driver")
    runner = RecordingRunner()
    kwargs = {} if device == "cuda" else {"device": device}
    with driver.driver(tmp_path, runner=runner, **kwargs) as dsl:
        dsl.start_notary_node()
        bob = dsl.start_node("O=Bob, L=Paris, C=FR", verifier_type="Tpu",
                             host_crossover=0)
        dsl.restart_node(bob)
        dsl.start_verifier("127.0.0.1:9", host_crossover=0)
        dsl.start_verifier("127.0.0.1:9", use_device=False)
    mods = [cmd[2] for cmd in runner.commands]
    assert mods == ["corda_tpu_torch.node"] * 4 + \
        ["corda_tpu_torch.verifier"] * 2
    for cmd in runner.commands[:5]:
        assert cmd[cmd.index("--device") + 1] == device
        assert "--no-device" not in cmd
    assert "--no-device" in runner.commands[5]
    assert "--device" not in runner.commands[5]
    # Bob's role, crossover included, survives his restart
    for cmd in runner.commands[2:4]:
        assert cmd[cmd.index("--verifier-type") + 1] == "Tpu"
        assert cmd[cmd.index("--host-crossover") + 1] == "0"
    assert "--host-crossover" not in runner.commands[1]


# -- a restart from checkpoints ----------------------------------------------

class EndsAtOnce(mod("corda_tpu_torch", "flows.api").FlowLogic):
    """A flow that, restored, finishes at once and so ends its sessions."""

    def call(self):
        return "done"
        yield


def test_a_restarted_node_restores_its_flows_after_the_map_answers(tmp_path):
    """A node restarted with a checkpointed flow that ends a session with a
    peer at once boots and finishes the flow: it restores its checkpoints
    once the network map has answered its fetch, so the peer resolves (on
    restoring at once, as the reference does, the boot fails on the
    unresolved peer). ``run_driver_cluster_load``'s kill and restart meets
    this when the victim dies between two steps of a payment."""
    node_mod = mod("corda_tpu_torch", "node.node")
    cps = mod("corda_tpu_torch", "node.checkpoints")
    names = {w: f"O={w}, L=London, C=GB" for w in ("Map", "Alice", "Bob")}

    def config(who, **kw):
        return node_mod.NodeConfiguration(
            names[who], port=0, device="cpu",
            base_directory=str(tmp_path / who), **kw)

    nodes = [node_mod.Node(config("Map", notary="simple")).start()]
    try:
        peer = {"network_map_name": names["Map"],
                "network_map_address": f"127.0.0.1:{nodes[0].messaging.port}"}
        nodes.append(node_mod.Node(config("Alice", **peer)).start())
        bob_config = config("Bob", **peer)
        bob = node_mod.Node(bob_config).start()
        bob.smm.checkpoints.add_checkpoint(cps.Checkpoint(
            run_id="restored-1",
            flow_class=mod("corda_tpu_torch", "flows.api").flow_name(
                EndsAtOnce),
            flow_fields={}, response_log=[],
            sessions=[cps.SessionSnapshot(names["Alice"], 11, 12, "open",
                                          [], [])]))
        bob.stop()
        cache = nodes[0].services.network_map_cache
        deadline = time.monotonic() + 30
        while cache.party_from_name(names["Alice"]) is None:
            assert time.monotonic() < deadline, "Alice never registered"
            time.sleep(0.05)
        bob = node_mod.Node(bob_config).start()
        nodes.append(bob)
        assert bob.network_map_client.fetched.is_set()
        assert bob.smm.checkpoints.get_all_checkpoints() == []
    finally:
        for node in reversed(nodes):
            node.stop()


# -- the same cluster through both packages' load tests -----------------------

def _kind(v) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, (int, float)):
        return "number"
    return type(v).__name__


class ReferenceClients:
    """The port's driver seen through the reference's RPC client: each
    handle's ``rpc`` is a ``corda_tpu`` CordaRPCClient on the same node, so
    the reference's flows' arguments cross the wire as its own types (the
    two codecs write the same bytes)."""

    def __init__(self, dsl):
        self.dsl = dsl

    def handle(self, h):
        from corda_tpu.client.rpc import CordaRPCClient
        h.rpc.close()
        return dataclasses.replace(h, rpc=CordaRPCClient(h.host, h.port))

    def restart_node(self, handle):
        return self.handle(self.dsl.restart_node(handle))


def test_driver_cluster_load_reports_alike(tmp_path):
    """Each package's ``run_driver_cluster_load`` drives its own two
    parties of one CPU cluster of port nodes, the reference's through the
    reference's RPC client (``ReferenceClients``), with a kill and restart
    of its second party: the reports have the same keys and kinds, and
    each conserves value."""
    driver = mod("corda_tpu_torch", "testing.driver")
    reports = {}
    with driver.driver(tmp_path, startup_timeout_s=120.0,
                       device="cpu") as dsl:
        dsl.start_notary_node()
        parties = {pkg: [dsl.start_node(f"O={who}, L=London, C=GB")
                         for who in names]
                   for pkg, names in zip(PKGS, (("Alice", "Bob"),
                                                ("Carol", "Dave")))}
        dsl.wait_for_network(6)
        ref = ReferenceClients(dsl)
        parties["corda_tpu"] = [ref.handle(h) for h in parties["corda_tpu"]]
        for pkg in PKGS:
            notary = parties[pkg][0].rpc.notary_identities()[0]
            reports[pkg] = mod(pkg, "tools.loadtest").run_driver_cluster_load(
                ref if pkg == "corda_tpu" else dsl, parties[pkg], notary,
                iterations=4, seed=5,
                kill_restart_at=2, report_path=str(tmp_path / f"{pkg}.json"))
            assert json.load(open(tmp_path / f"{pkg}.json")) == reports[pkg]
    ref, port = reports["corda_tpu"], reports["corda_tpu_torch"]
    assert {k: _kind(v) for k, v in port.items()} == \
        {k: _kind(v) for k, v in ref.items()}
    for report in (ref, port):
        assert report["conserved"] and report["flows"] >= 4, report
        assert report["metric"] == "driver_cluster_flows_per_sec"
        assert report["kill_restart_at"] == 2


# -- DemoBench's configurations -----------------------------------------------

def test_demobench_configs_differ_only_in_device_and_modules(tmp_path):
    spec = {"base_directory": str(tmp_path / "net"), "tls": False,
            "map_port": 10321,
            "nodes": [{"name": "O=Notary, L=Zurich, C=CH",
                       "notary": "validating"},
                      {"name": "O=Alice, L=London, C=GB", "port": 10400,
                       "verifier_type": "Tpu",
                       "cordapps": ["corda_tpu.samples.rates_oracle"]},
                      {"name": "O=Bob, L=Paris, C=FR", "device": "cpu"}]}
    configs = {}
    for pkg in PKGS:
        pkg_spec = json.loads(json.dumps(spec).replace(
            "corda_tpu.", f"{pkg}."))
        paths = mod(pkg, "tools.demobench").generate_node_configs(pkg_spec)
        configs[pkg] = [(os.path.relpath(p, tmp_path), json.load(open(p)))
                        for p in paths]
    ref, port = configs["corda_tpu"], configs["corda_tpu_torch"]
    assert [p for p, _ in port] == [p for p, _ in ref]
    devices = [cfg.pop("device") for _, cfg in port]
    assert devices == ["cuda", "cuda", "cuda", "cpu"]
    for _, cfg in port:
        cfg["cordapps"] = [c.replace("corda_tpu_torch.", "corda_tpu.")
                           for c in cfg["cordapps"]]
    assert port == ref
