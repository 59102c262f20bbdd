"""The port stands alone: no module of corda_tpu_torch imports jax or
anything of corda_tpu, importing it builds nothing, and its entry points
default to the card (raising when CUDA is absent, never running on the CPU
unasked)."""
import ast
import json
import pathlib
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
