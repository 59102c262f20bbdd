"""DemoBench — launch a local node cluster from a cordform-style network spec.

Reference parity: two tools in one, matching how they compose upstream —
the `cordformation` Gradle plugin's deployNodes DSL (gradle-plugins/
cordformation Cordform.groovy: a network spec expands into per-node config
directories) and `tools/demobench` (DemoBench.kt: boot the generated nodes
locally, watch them, tear them down). The GUI becomes a CLI: a status table
on stdout and simple commands on stdin.

Network spec (JSON):

    {
      "base_directory": "demo-network",
      "tls": false,
      "nodes": [
        {"name": "O=Notary, L=Zurich, C=CH", "notary": "simple"},
        {"name": "O=Alice, L=London, C=GB", "web_port": 8080},
        {"name": "O=Bob, L=Paris, C=FR", "verifier_type": "Tpu"}
      ]
    }

The network-map node is implicit (first to boot); p2p ports are ephemeral by
default ("port" pins one). `web_port` attaches an HTTP gateway (REST over
the node's RPC) served from the demobench process — the standalone-webserver
topology of the reference.

Usage:
    python -m corda_tpu_torch.tools.demobench spec.json            # launch + watch
    python -m corda_tpu_torch.tools.demobench spec.json --generate-only

A copy of the reference's module. Each node spec carries ``device``
(default: the spec's top-level ``device``, else "cuda", the card), written
into its NodeConfiguration file; the network-map node takes the top-level
one. Nodes boot as ``python -m corda_tpu_torch.node --config``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import dataclass, field

from ..node.node import NodeConfiguration

MAP_NAME = "O=Network Map, L=London, C=GB"


def _node_dir(base: str, name: str) -> str:
    return os.path.join(base, name.replace("=", "_").replace(", ", "_"))


def generate_node_configs(spec: dict) -> list[str]:
    """Expand the network spec into per-node config directories
    (cordformation deployNodes). Returns the config file paths, network-map
    node first (boot order)."""
    base = spec.get("base_directory", "demo-network")
    device = spec.get("device", "cuda")
    tls = bool(spec.get("tls", False))
    ca_dir = os.path.join(base, "dev-ca") if tls else None
    paths = []

    def write(cfg: NodeConfiguration) -> str:
        os.makedirs(cfg.base_directory, exist_ok=True)
        path = os.path.join(cfg.base_directory, "node.json")
        cfg.save(path)
        return path

    map_cfg = NodeConfiguration(
        my_legal_name=MAP_NAME, port=int(spec.get("map_port", 10000)),
        base_directory=_node_dir(base, MAP_NAME), tls=tls,
        tls_ca_directory=ca_dir, device=device)
    paths.append(write(map_cfg))
    for node in spec.get("nodes", []):
        cfg = NodeConfiguration(
            my_legal_name=node["name"],
            host=node.get("host", "127.0.0.1"),
            port=int(node.get("port", 0)),
            base_directory=_node_dir(base, node["name"]),
            network_map_name=MAP_NAME,
            network_map_address=f"127.0.0.1:{map_cfg.port}",
            notary=node.get("notary"),
            verifier_type=node.get("verifier_type", "InMemory"),
            tls=tls, tls_ca_directory=ca_dir,
            device=node.get("device", device))
        if node.get("cordapps"):
            cfg.cordapps = cfg.cordapps + list(node["cordapps"])
        paths.append(write(cfg))
    return paths


@dataclass
class RunningNode:
    name: str
    config_path: str
    process: subprocess.Popen
    host: str
    port: int
    webserver: object = None
    web_port: int | None = None

    @property
    def alive(self) -> bool:
        return self.process.poll() is None


@dataclass
class DemoBench:
    """The running cluster: spawn order = config order, teardown reversed."""

    spec: dict
    nodes: list[RunningNode] = field(default_factory=list)

    def launch(self) -> "DemoBench":
        from ..testing.driver import await_node_ready
        web_ports = {n["name"]: n.get("web_port")
                     for n in self.spec.get("nodes", [])}
        # in TLS mode the web gateway's RPC client must speak mTLS to the
        # node plane too, using the same dev CA the configs were cut from
        ca_dir = (os.path.join(
            self.spec.get("base_directory", "demo-network"), "dev-ca")
            if self.spec.get("tls") else None)
        for path in generate_node_configs(self.spec):
            with open(path) as f:
                name = json.load(f)["my_legal_name"]
            env = dict(os.environ)
            # PREPEND the repo root: an inherited PYTHONPATH (e.g. a
            # platform site dir) must not keep child nodes from importing
            # this package when launched outside the repo cwd
            repo_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            env["PYTHONPATH"] = (repo_root + os.pathsep + env["PYTHONPATH"]
                                 if env.get("PYTHONPATH") else repo_root)
            proc = subprocess.Popen(
                [sys.executable, "-m", "corda_tpu_torch.node", "--config", path,
                 "--quiet"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env)
            host, port = await_node_ready(proc, name)
            running = RunningNode(name, path, proc, host, port)
            if web_ports.get(name) is not None:   # 0 = ephemeral web port
                from ..client.rpc import CordaRPCClient
                from .webserver import NodeWebServer
                running.webserver = NodeWebServer(
                    CordaRPCClient(host, port, tls_ca_directory=ca_dir),
                    port=int(web_ports[name])
                ).start()
                running.web_port = running.webserver.port
            self.nodes.append(running)
        return self

    def status(self) -> list[dict]:
        return [{"name": n.name, "p2p": f"{n.host}:{n.port}",
                 "web": n.web_port, "alive": n.alive} for n in self.nodes]

    def stop_node(self, name: str) -> bool:
        for n in self.nodes:
            if name in n.name and n.alive:
                n.process.terminate()
                n.process.wait(timeout=10)
                return True
        return False

    def shutdown(self) -> None:
        for n in reversed(self.nodes):
            if n.webserver is not None:
                n.webserver.stop()
            if n.alive:
                n.process.terminate()
        for n in self.nodes:
            try:
                n.process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                n.process.kill()
        self.nodes.clear()


def _print_status(bench: DemoBench) -> None:
    print(f"{'NODE':44} {'P2P':22} {'WEB':6} ALIVE")
    for row in bench.status():
        web = str(row["web"] or "-")
        print(f"{row['name']:44} {row['p2p']:22} {web:6} {row['alive']}")


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(prog="corda_tpu_torch.tools.demobench")
    parser.add_argument("spec", help="network spec JSON file")
    parser.add_argument("--generate-only", action="store_true",
                        help="write node configs without launching")
    args = parser.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    if args.generate_only:
        for path in generate_node_configs(spec):
            print(path)
        return 0
    bench = DemoBench(spec).launch()
    _print_status(bench)
    print("commands: status | stop <name-substring> | quit")
    try:
        for line in sys.stdin:
            cmd = line.strip().split(None, 1)
            if not cmd:
                continue
            if cmd[0] == "status":
                _print_status(bench)
            elif cmd[0] == "stop" and len(cmd) == 2:
                print("stopped" if bench.stop_node(cmd[1]) else "no such node")
            elif cmd[0] in ("quit", "exit"):
                break
    except KeyboardInterrupt:
        pass
    finally:
        bench.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
