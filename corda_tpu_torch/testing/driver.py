"""Driver DSL — boot REAL node processes for integration tests.

Reference parity: test-utils driver{} (Driver.kt:89-239): start a network-map
node, then nodes/notaries as subprocesses, hand back handles with RPC
clients, and tear everything down (ShutdownManager) on exit.

    with driver(tmp_path) as dsl:
        notary = dsl.start_node("O=Notary, L=Zurich, C=CH", notary="simple")
        alice = dsl.start_node("O=Alice, L=London, C=GB")
        alice.rpc.start_flow_and_wait("CashIssueFlow", ...)

A copy of the reference's module. It spawns ``python -m
corda_tpu_torch.node`` and ``python -m corda_tpu_torch.verifier``, and
``DriverDSL(device=...)`` (default "cuda", the card) is the device of every
node and worker it spawns: each gets ``--device <device>``, except a worker
started with ``use_device=False``, which keeps the reference's
``--no-device`` host route. A node on "cuda" without CUDA fails at boot;
nothing falls back to the CPU. ``start_node(host_crossover=N)`` (a Tpu
node's batcher crossover, the node's ``--host-crossover``) is the port's
own, and a restarted node keeps it.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass

from ..client.rpc import CordaRPCClient


@dataclass
class NodeHandle:
    name: str
    host: str
    port: int
    process: "object"            # testing.runner.ProcessHandle
    rpc: CordaRPCClient
    # spawn configuration, so restart_node restores the SAME role
    notary: str | None = None
    verifier_type: str = "InMemory"
    host_crossover: int | None = None

    def stop(self) -> None:
        if self.rpc is not None:
            self.rpc.close()
        self.process.terminate()
        try:
            self.process.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.process.kill()


@dataclass
class VerifierHandle:
    """A standalone verifier worker subprocess (VerifierDriver.startVerifier
    analog, verifier/src/integration-test/.../VerifierDriver.kt:50-68)."""

    host: str
    port: int
    process: "object"            # testing.runner.ProcessHandle
    stats_file: str | None = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        """Graceful: SIGTERM lets the worker flush its stats file."""
        self.process.terminate()
        try:
            self.process.wait(timeout=15)
        except subprocess.TimeoutExpired:
            self.process.kill()

    def kill(self) -> None:
        """Hard kill — the death-redistribution scenario."""
        self.process.kill()
        self.process.wait(timeout=10)


class DriverDSL:
    def __init__(self, base_dir: str, startup_timeout_s: float = 60.0,
                 runner=None, device: str = "cuda"):
        """``runner``: a testing.runner.NodeRunner — LocalRunner (default)
        spawns subprocesses on this machine; SSHRunner places the same
        processes on a remote host with identical lifecycle/disruption
        semantics (LoadTest.kt's ssh-managed cluster). ``device``: the
        device every spawned node and device worker runs on."""
        from .runner import LocalRunner
        self.base_dir = str(base_dir)
        self.device = str(device)
        self.startup_timeout_s = startup_timeout_s
        self.runner = runner if runner is not None else LocalRunner()
        self.nodes: list[NodeHandle] = []
        self.verifiers: list[VerifierHandle] = []
        self.map_handle: NodeHandle | None = None
        self.map_name = "O=Network Map, L=London, C=GB"

    def __enter__(self) -> "DriverDSL":
        self.map_handle = self._spawn(self.map_name, is_map=True)
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- the DSL -------------------------------------------------------------
    def start_node(self, name: str, notary: str | None = None,
                   verifier_type: str = "InMemory",
                   host_crossover: int | None = None) -> NodeHandle:
        return self._spawn(name, notary=notary, verifier_type=verifier_type,
                           host_crossover=host_crossover)

    def start_notary_node(self, name: str = "O=Notary Service, L=Zurich, C=CH",
                          validating: bool = False) -> NodeHandle:
        return self.start_node(name,
                               notary="validating" if validating else "simple")

    def wait_for_network(self, min_nodes: int, timeout_s: float = 30.0) -> None:
        """Block until every started node sees >= min_nodes in its map cache
        (the driver's networkMapStartStrategy readiness wait)."""
        deadline = time.monotonic() + timeout_s
        for handle in self.nodes:
            while True:
                if len(handle.rpc.network_map_snapshot()) >= min_nodes:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{handle.name} sees fewer than {min_nodes} nodes")
                time.sleep(0.3)

    def restart_node(self, handle: NodeHandle) -> NodeHandle:
        """Restart a (possibly killed) node subprocess on the SAME base
        directory and with the SAME role (notary/verifier config recorded
        at spawn): identity key, durable transaction store and checkpoints
        are reloaded from disk; the node re-registers its new address with
        the network map (the loadtest kill/restart disruption,
        Disruption.kt:17-105)."""
        if handle.process.poll() is None:
            handle.stop()
        elif handle.rpc is not None:
            handle.rpc.close()
        if handle in self.nodes:
            self.nodes.remove(handle)
        return self._spawn(handle.name, notary=handle.notary,
                           verifier_type=handle.verifier_type,
                           host_crossover=handle.host_crossover)

    def start_verifier(self, queue_address: str, use_device: bool = True,
                       host_crossover: int | None = None,
                       stats_file: str | None = None,
                       extra_env: dict | None = None) -> VerifierHandle:
        """Spawn a standalone verifier worker subprocess attached to
        ``queue_address`` ("host:port" of the requesting endpoint)."""
        cmd = [sys.executable, "-m", "corda_tpu_torch.verifier",
               "--queue-address", queue_address, "--port", "0"]
        if not use_device:
            cmd.append("--no-device")
        else:
            cmd += ["--device", self.device]
        if host_crossover is not None:
            cmd += ["--host-crossover", str(host_crossover)]
        if stats_file is not None:
            cmd += ["--stats-file", stats_file]
        env = dict(os.environ)
        env.setdefault("PYTHONPATH", os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env.update(extra_env or {})
        proc = self.runner.spawn(cmd, env=env)
        host, port = await_node_ready(proc, "verifier",
                                      self.startup_timeout_s,
                                      ready_prefix="VERIFIER READY")
        handle = VerifierHandle(host, port, proc, stats_file)
        self.verifiers.append(handle)
        return handle

    def shutdown(self) -> None:
        for handle in reversed(self.verifiers):
            handle.stop()
        self.verifiers.clear()
        for handle in reversed(self.nodes):
            handle.stop()
        self.nodes.clear()

    # -- process management --------------------------------------------------
    def _spawn(self, name: str, is_map: bool = False, notary: str | None = None,
               verifier_type: str = "InMemory",
               host_crossover: int | None = None) -> NodeHandle:
        node_dir = os.path.join(self.base_dir,
                                name.replace("=", "_").replace(", ", "_"))
        self.runner.prepare_dir(node_dir)
        cmd = [sys.executable, "-m", "corda_tpu_torch.node", "--name", name,
               "--port", "0", "--base-dir", node_dir, "--quiet",
               "--verifier-type", verifier_type, "--device", self.device]
        if not is_map:
            assert self.map_handle is not None, "driver not entered"
            cmd += ["--network-map-name", self.map_name,
                    "--network-map-address",
                    f"{self.map_handle.host}:{self.map_handle.port}"]
        if notary:
            cmd += ["--notary", notary]
        if host_crossover is not None:
            cmd += ["--host-crossover", str(host_crossover)]
        env = dict(os.environ)
        env.setdefault("PYTHONPATH", os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        proc = self.runner.spawn(cmd, env=env)
        # await_node_ready's reader thread keeps draining stdout for the
        # process lifetime, so the node never blocks on a full pipe
        host, port = await_node_ready(proc, name, self.startup_timeout_s)
        rpc = CordaRPCClient(host, port)
        handle = NodeHandle(name, host, port, proc, rpc,
                            notary=notary, verifier_type=verifier_type,
                            host_crossover=host_crossover)
        self.nodes.append(handle)
        return handle


def await_node_ready(proc, name: str,
                     timeout_s: float = 60.0,
                     ready_prefix: str = "NODE READY"):
    """Block until a node subprocess prints its READY line (driver
    futures); returns (host, port). Lines are read on a helper thread so a
    silently-hung child still trips the timeout instead of blocking readline
    forever. Shared by the driver DSL and the demobench launcher."""
    import queue as _queue
    import threading
    lines_q: "_queue.Queue" = _queue.Queue()

    def _reader():
        for line in proc.stdout:
            lines_q.put(line)
        lines_q.put(None)  # EOF

    threading.Thread(target=_reader, daemon=True).start()
    deadline = time.monotonic() + timeout_s
    lines = []
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            proc.kill()
            raise TimeoutError(
                f"node {name} did not start in time:\n" + "".join(lines))
        try:
            line = lines_q.get(timeout=min(remaining, 1.0))
        except _queue.Empty:
            continue
        if line is None:
            raise RuntimeError(
                f"node {name} exited during startup:\n" + "".join(lines))
        lines.append(line)
        if line.startswith(ready_prefix):
            addr = line.strip().rsplit(" ", 1)[-1]
            host, _, port = addr.rpartition(":")
            return host, int(port)


def driver(base_dir: str, **kwargs) -> DriverDSL:
    return DriverDSL(base_dir, **kwargs)
