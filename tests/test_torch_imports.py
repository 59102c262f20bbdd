"""The port stands alone: no module of corda_tpu_torch imports jax or
anything of corda_tpu, importing it builds nothing, and its entry points
default to the card (raising when CUDA is absent, never running on the CPU
unasked)."""
import ast
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "corda_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


#: The packages of the flow framework, finance, consensus and ledger
#: harness slices, and a module of each, that the scans below must reach.
SLICE_MODULES = ("corda_tpu_torch.flows", "corda_tpu_torch.flows.api",
                 "corda_tpu_torch.flows.library",
                 "corda_tpu_torch.flows.confidential",
                 "corda_tpu_torch.node", "corda_tpu_torch.node.statemachine",
                 "corda_tpu_torch.node.services",
                 "corda_tpu_torch.node.notary", "corda_tpu_torch.storage",
                 "corda_tpu_torch.storage.kvstore",
                 "corda_tpu_torch.testing.mocknetwork",
                 "corda_tpu_torch.observability.resprof",
                 "corda_tpu_torch.core.contracts.amount",
                 "corda_tpu_torch.core.transactions.builder",
                 "corda_tpu_torch.finance", "corda_tpu_torch.finance.cash",
                 "corda_tpu_torch.finance.trade",
                 "corda_tpu_torch.experimental",
                 "corda_tpu_torch.experimental.universal",
                 "corda_tpu_torch.flows.contract_upgrade",
                 "corda_tpu_torch.flows.state_replacement",
                 "corda_tpu_torch.core.contracts.sandbox",
                 "corda_tpu_torch.core.contracts.clauses",
                 "corda_tpu_torch.core.contracts.attachment_contract",
                 "corda_tpu_torch.testing.ledger_dsl",
                 "corda_tpu_torch.consensus",
                 "corda_tpu_torch.consensus.raft",
                 "corda_tpu_torch.consensus.raft_store",
                 "corda_tpu_torch.consensus.raftcore",
                 "corda_tpu_torch.consensus.provider",
                 "corda_tpu_torch.consensus.raft_uniqueness",
                 "corda_tpu_torch.consensus.commit_pipeline",
                 "corda_tpu_torch.consensus.sharded_uniqueness",
                 "corda_tpu_torch.consensus.bft",
                 "corda_tpu_torch.observability.stages",
                 "corda_tpu_torch.observability.timeseries",
                 "corda_tpu_torch.observability.critpath",
                 "corda_tpu_torch.observability.consensus_obs",
                 "corda_tpu_torch.observability.ledger_harness",
                 "corda_tpu_torch.observability.soak",
                 "corda_tpu_torch.tools", "corda_tpu_torch.tools.benchguard",
                 "corda_tpu_torch.tools.benchtrend",
                 "corda_tpu_torch.tools.critpath",
                 "corda_tpu_torch.tools.consensus_stat",
                 "corda_tpu_torch.tools.fleetstat",
                 "corda_tpu_torch.tools.scenario",
                 "corda_tpu_torch.utils.progress",
                 "corda_tpu_torch.utils.affinity",
                 "corda_tpu_torch.node.scheduler",
                 "corda_tpu_torch.node.node", "corda_tpu_torch.node.rpc",
                 "corda_tpu_torch.node.__main__",
                 "corda_tpu_torch.network.tcp", "corda_tpu_torch.network.tls",
                 "corda_tpu_torch.network.netmap",
                 "corda_tpu_torch.network.registration",
                 "corda_tpu_torch.verifier.__main__",
                 "corda_tpu_torch.samples.trader_demo",
                 "corda_tpu_torch.samples.bank_of_corda",
                 "corda_tpu_torch.samples.attachment_demo",
                 "corda_tpu_torch.samples.simulation",
                 "corda_tpu_torch.samples.irs_demo",
                 "corda_tpu_torch.samples.notary_demo",
                 "corda_tpu_torch.client", "corda_tpu_torch.client.rpc",
                 "corda_tpu_torch.client.jackson",
                 "corda_tpu_torch.client.monitor",
                 "corda_tpu_torch.tools.webserver",
                 "corda_tpu_torch.tools.shell",
                 "corda_tpu_torch.tools.explorer",
                 "corda_tpu_torch.tools.demobench",
                 "corda_tpu_torch.tools.loadtest",
                 "corda_tpu_torch.testing.driver",
                 "corda_tpu_torch.testing.runner")


def test_the_scans_reach_the_flow_framework_packages():
    names = {name for _, name in _modules()}
    assert set(SLICE_MODULES) <= names


def test_importing_every_module_loads_no_jax_or_corda_tpu():
    names = [name for _, name in _modules()]
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'corda_tpu.'))\n"
        "             or m in ('corda_tpu', 'msgpack', 'cryptography'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_import_statement_names_jax_or_corda_tpu():
    offenders = []
    for path, _ in _modules():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                if root in ("jax", "jaxlib", "corda_tpu", "msgpack"):
                    offenders.append(f"{path.name}:{node.lineno} {m}")
    assert offenders == []


#: A reference package module named in a string: "corda_tpu." or
#: "corda_tpu:" followed by a name (a module path, or a "module:QualName"
#: error payload) or by the end of the literal (an f-string's part before
#: a formatted name). "corda_tpu_torch." does not match.
_REF_MODULE = re.compile(r"\bcorda_tpu[.:](?=[A-Za-z_]|$)")


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant) and isinstance(
                    first.value.value, str):
                out.add(id(first.value))
    return out


def strings_naming_the_reference(source: str) -> list:
    """(line, text) of every str literal of ``source`` other than a
    docstring — f-strings' literal parts included — that names a module of
    the reference package. Docstrings are prose: they may say what a
    module copies."""
    tree = ast.parse(source)
    docs = _docstrings(tree)
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs and _REF_MODULE.search(node.value)]


def test_no_string_literal_names_a_corda_tpu_module():
    """Flow names, checkpoint restores and error payloads import modules by
    the names in strings (``flow_name``, ``_import_flow_class``,
    ``_ERROR_MODULES``): a copied string naming the reference package would
    import it at run time, which the import scans above cannot see."""
    offenders = []
    for path, _ in _modules():
        for line, text in strings_naming_the_reference(path.read_text()):
            offenders.append(f"{path.relative_to(PKG.parent)}:{line} {text!r}")
    assert offenders == []


def test_the_string_scan_finds_planted_names():
    planted = (
        '"""Copies corda_tpu.flows.api (a docstring: allowed)."""\n'
        'MODS = ("corda_tpu.flows.api", "corda_tpu_torch.node.notary")\n'
        'def f(x):\n'
        '    """A docstring naming corda_tpu.node."""\n'
        '    return f"corda_tpu.{x}", "corda_tpu:Error", b"corda_tpu.bytes"\n')
    assert [line for line, _ in strings_naming_the_reference(planted)] == [
        2, 5, 5]


def test_error_modules_are_the_ports_own():
    import importlib
    from corda_tpu_torch.node import statemachine
    for name in statemachine._ERROR_MODULES:
        assert name.startswith("corda_tpu_torch.")
        importlib.import_module(name)
    assert {"corda_tpu_torch.flows.state_replacement",
            "corda_tpu_torch.flows.contract_upgrade"} <= set(
        statemachine._ERROR_MODULES)
    registry = statemachine._error_registry()
    assert "corda_tpu_torch.flows.api:FlowTimeoutException" in registry
    assert "corda_tpu_torch.flows.state_replacement:StateReplacementException" \
        in registry
    assert "corda_tpu_torch.flows.contract_upgrade:ContractUpgradeException" \
        in registry


def test_default_device_raises_without_cuda():
    from corda_tpu_torch.device import resolve_device
    from corda_tpu_torch.ops import ed25519
    from corda_tpu_torch.verifier import make_verifier_service
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        ed25519.verify_batch([(b"\x00" * 32, b"\x00" * 64, b"m")])
    with pytest.raises(RuntimeError, match="cuda"):
        make_verifier_service("Tpu")
    from corda_tpu_torch.core.crypto import ecmath
    from corda_tpu_torch.ops import weierstrass
    for curve in (ecmath.SECP256K1, ecmath.SECP256R1):
        with pytest.raises(RuntimeError, match="cuda"):
            weierstrass.verify_batch(curve, [(curve.g, b"m", 1, 1)])
    from corda_tpu_torch.network import InMemoryMessagingNetwork
    from corda_tpu_torch.verifier import VerifierWorker
    bus = InMemoryMessagingNetwork()
    bus.create_node("node")
    with pytest.raises(RuntimeError, match="cuda"):
        VerifierWorker(bus.create_node("w"), "node")
    worker = VerifierWorker(bus.create_node("w_cpu"), "node", device="cpu")
    assert worker.device == torch.device("cpu")
    worker.stop()
    from corda_tpu_torch.testing import MockNetwork
    with pytest.raises(RuntimeError, match="cuda"):
        MockNetwork()
    assert MockNetwork(device="cpu").create_node().services.device == \
        torch.device("cpu")
