"""The reference's public package names on the port: the package exports
(``utils.MetricRegistry``, ``ops.sha256``, every name of
``observability.__all__``), the staging pool's setter and the native
scalar seams of ``ops/scalarprep.py`` (``mulmod``, ``mod512``, ``glv``,
``r1p_mulfast``), each held against the reference on the same inputs.

The seams' cases are those of tests/test_scalarprep.py and
tests/test_r1_halfgcd.py (the same seeds, values and bounds), taken alone:
the port's library is built by ``_build`` from native/scalarmath.cpp, the
reference's is native/libscalarmath.so.

Then the module scan: every module of the reference has a twin at the same
path in the port, and each module of the reference's ``client/``,
``tools/`` and ``testing/`` packages has its public names (every name not
starting with ``_`` that is not a module) in the port's twin."""
import importlib
import inspect
import json
import pathlib
import random
import subprocess
import sys

import pytest

from test_torch_flow_framework import PKGS, mod

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("pkg", PKGS)
def test_utils_exports_metric_registry(pkg):
    utils = mod(pkg, "utils")
    assert utils.MetricRegistry is mod(pkg, "utils.metrics").MetricRegistry


@pytest.mark.parametrize("pkg", PKGS)
def test_ops_exports_sha256(pkg):
    ops = mod(pkg, "ops")
    assert "sha256" in ops.__all__
    assert ops.sha256 is mod(pkg, "ops.sha256")
    assert callable(ops.sha256.merkle_root)


def test_observability_exports_every_reference_name():
    ref = mod("corda_tpu", "observability")
    port = mod("corda_tpu_torch", "observability")
    assert set(ref.__all__) <= set(port.__all__)
    for name in ref.__all__:
        assert hasattr(port, name), name


def _build_files() -> dict:
    build = REPO / "corda_tpu_torch" / "_build"
    if not build.is_dir():
        return {}
    return {p.name: p.stat().st_mtime_ns for p in build.iterdir()}


def test_importing_ops_builds_nothing_and_touches_no_device():
    """``import corda_tpu_torch.ops`` (sha256 included) in a fresh process
    whose torch.cuda raises on every call that would reach a driver: the
    import succeeds, and nothing under corda_tpu_torch/_build/ changes."""
    code = (
        "import json, sys, torch\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('touched CUDA')\n"
        "for name in ('init', '_lazy_init', 'current_device', 'device_count',\n"
        "             'is_available', 'synchronize', 'current_stream',\n"
        "             'set_device', 'get_device_name'):\n"
        "    setattr(torch.cuda, name, refuse)\n"
        "import corda_tpu_torch.ops as ops\n"
        "from corda_tpu_torch import _build\n"
        "print(json.dumps({'sha256': ops.sha256.__name__,\n"
        "                  'builds': sum(_build.BUILD_COUNT.values()),\n"
        "                  'loaded': sorted(_build._LIBS)}))\n")
    before = _build_files()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"sha256": "corda_tpu_torch.ops.sha256", "builds": 0,
                   "loaded": []}
    assert _build_files() == before


@pytest.mark.parametrize("pkg", PKGS)
def test_set_staging_pool_round_trips(pkg):
    staging = mod(pkg, "ops.staging")
    prior = staging.get_staging_pool()
    fresh = staging.StagingPool()
    try:
        assert staging.set_staging_pool(fresh) is None
        assert staging.get_staging_pool() is fresh
    finally:
        staging.set_staging_pool(prior)
    assert staging.get_staging_pool() is prior


def test_port_staging_pool_pins_nothing_on_the_cpu(monkeypatch):
    """The soak's staging probe reads the pool: on a machine without CUDA
    the pool pins nothing and creating it reaches no CUDA driver."""
    import torch
    from corda_tpu_torch.ops import staging

    def refuse(*a, **k):
        raise AssertionError("touched CUDA")
    for name in ("init", "_lazy_init", "current_device", "set_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    prior = staging.get_staging_pool()
    monkeypatch.setattr(staging, "_POOL", None)
    pool = staging.get_staging_pool()
    try:
        assert pool is not prior
        assert pool.pinned is False
        assert pool._free == {} and len(pool._attached) == 0
    finally:
        staging.set_staging_pool(prior)


# -- the native scalar seams ---------------------------------------------------

@pytest.fixture(scope="module")
def seams():
    """{pkg: its scalarprep} with each library built and loaded."""
    out = {pkg: mod(pkg, "ops.scalarprep") for pkg in PKGS}
    for pkg, sp in out.items():
        assert sp.available(), f"{pkg}: libscalarmath is not available"
    return out


def _mods():
    from corda_tpu_torch.core.crypto import ecmath
    return [ecmath.SECP256K1.n, ecmath.SECP256K1.p, ecmath.SECP256R1.n,
            ecmath.SECP256R1.p, ecmath.ED_L, ecmath.ED_P]


def test_modulus_ids_match_the_reference(seams):
    names = ("MOD_K1_N", "MOD_K1_P", "MOD_R1_N", "MOD_R1_P", "MOD_ED_L",
             "MOD_ED_P")
    assert [getattr(seams["corda_tpu_torch"], n) for n in names] == \
        [getattr(seams["corda_tpu"], n) for n in names] == list(range(6))


def test_mulmod_and_mod512_match_the_reference(seams):
    """tests/test_scalarprep.py::test_mulmod_matches_python's cases."""
    ref, port = seams["corda_tpu"], seams["corda_tpu_torch"]
    rng = random.Random(11)
    for mid, m in enumerate(_mods()):
        for _ in range(50):
            a, b = rng.getrandbits(256) % m, rng.getrandbits(256) % m
            assert port.mulmod(mid, a, b) == ref.mulmod(mid, a, b) == \
                a * b % m
        for _ in range(50):
            x = rng.getrandbits(512)
            assert port.mod512(mid, x) == ref.mod512(mid, x) == x % m
        for a in (0, 1, m - 1):
            assert port.mulmod(mid, a, m - 1) == ref.mulmod(mid, a, m - 1)
        top = (1 << 512) - 1
        assert port.mod512(mid, top) == ref.mod512(mid, top) == top % m


def test_glv_matches_the_reference(seams):
    """tests/test_scalarprep.py::test_glv_matches_python's cases."""
    from corda_tpu_torch.core.crypto import ecmath
    ref, port = seams["corda_tpu"], seams["corda_tpu_torch"]
    rng = random.Random(12)
    n = ecmath.SECP256K1.n
    cases = [0, 1, n - 1, n // 2, n // 2 + 1]
    cases += [rng.getrandbits(256) % n for _ in range(300)]
    for k in cases:
        assert port.glv(k) == ref.glv(k) == ecmath.glv_decompose(k), k


def test_r1p_mulfast_matches_the_reference(seams):
    """tests/test_r1_halfgcd.py::test_r1p_mulfast_matches_python's cases."""
    from corda_tpu_torch.core.crypto import ecmath
    ref, port = seams["corda_tpu"], seams["corda_tpu_torch"]
    rng = random.Random(503)
    p = ecmath.SECP256R1.p
    ops = [(0, 0), (1, p - 1), (p - 1, p - 1), (1 << 128, 1 << 128)]
    ops += [(rng.randrange(p), rng.randrange(p)) for _ in range(2000)]
    for a, b in ops:
        assert port.r1p_mulfast(a, b) == ref.r1p_mulfast(a, b) == \
            a * b % p, (a, b)


# -- the module scan ----------------------------------------------------------

def _reference_modules(*dirs: str) -> list:
    """Package-relative paths of the reference's modules (under ``dirs``
    only, when given), ``__init__`` naming its package."""
    root = REPO / "corda_tpu"
    out = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        if dirs and rel.parts[0] not in dirs:
            continue
        parts = list(rel.with_suffix("").parts)
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_every_reference_module_has_a_twin():
    root = REPO / "corda_tpu"
    missing = [str(p.relative_to(root)) for p in sorted(root.rglob("*.py"))
               if not (REPO / "corda_tpu_torch" / p.relative_to(root))
               .is_file()]
    assert missing == []
    assert len(_reference_modules("client", "tools", "testing")) >= 27


@pytest.mark.parametrize("path",
                         _reference_modules("client", "tools", "testing"))
def test_client_tools_and_testing_keep_the_reference_public_names(path):
    ref = importlib.import_module(f"corda_tpu.{path}")
    port = importlib.import_module(f"corda_tpu_torch.{path}")
    public = {n for n, v in vars(ref).items()
              if not n.startswith("_") and not inspect.ismodule(v)}
    assert sorted(public - set(vars(port))) == []
