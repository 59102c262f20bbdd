"""How chip_smoke.py's --ab phase binds each side's kernel launchers: from
the ``int`` parameters of ``<target>_verify`` and ``<target>_occupancy`` in
that side's own .cu source (``c_int_params``), so that a parent whose
launchers take the lanes a signature, and one whose launchers do not, are
both called as their sources declare. No compiler and no card: the tests
read the sources' text.
"""
import importlib.util
import pathlib
import re
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "corda_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: The int each launcher of this tree takes between n and the stream.
TREE = {"ed25519_split": ["lanes"], "ed25519_shamir": ["lanes"],
        "ed25519_windowed": ["lanes"], "weierstrass_shamir": ["curve"],
        "weierstrass_windowed": ["curve"], "secp256k1_hybrid": [],
        "secp256r1_split": [], "secp256k1_glv": []}


@pytest.mark.parametrize("target", sorted(TREE))
def test_this_trees_launchers(smoke, target):
    src = (CSRC / f"{target}.cu").read_text()
    assert smoke.c_int_params(src, f"{target}_verify") == TREE[target]
    assert smoke.c_int_params(src, f"{target}_occupancy") == (
        ["block"] + TREE[target])


def test_ab_libs_count_each_launchers_wire_pointers(smoke):
    """AB_LIBS gives each library's wire pointers: the launcher's pointer
    parameters less the verdict and the stream."""
    assert set(smoke.AB_LIBS) == set(TREE) - {"ed25519_split",
                                              "secp256r1_split"}
    for target, n_ptrs in smoke.AB_LIBS.items():
        src = (CSRC / f"{target}.cu").read_text()
        params = re.search(rf"\bint\s+{target}_verify\s*\(([^)]*)\)",
                           src).group(1).split(",")
        assert sum("*" in p for p in params) == n_ptrs + 2, target


# B7 Shamir's launcher in its earlier one-thread form (no lanes) and in its
# two-kernel form (the lanes before the stream), with their occupancy
# functions.
ONE_THREAD = """
extern "C" {
int ed25519_shamir_verify(const void *s_bits, const void *k_bits,
                          const void *ax, const void *ay, const void *az,
                          const void *at, const void *rx, const void *ry,
                          void *ok, int64_t n, void *stream) {
  if (n <= 0) return 0;
  return 0;
}
int ed25519_shamir_occupancy(int block) { return 1; }
int ed25519_shamir_lanes(void) { return kLanes; }
}
"""
WITH_LANES = """
extern "C" {
int ed25519_shamir_lanes(int64_t n) { return n <= kPairItems ? 2 : 1; }
int ed25519_shamir_verify(const void *s_bits, const void *k_bits,
                          const void *ax, const void *ay, const void *az,
                          const void *at, const void *rx, const void *ry,
                          void *ok, int64_t n, int lanes, void *stream) {
  if (lanes != 1 && lanes != 2) return (int)cudaErrorInvalidValue;
  return 0;
}
int ed25519_shamir_occupancy(int block, int lanes) { return 1; }
}
"""


@pytest.mark.parametrize("source, ints", [(ONE_THREAD, []),
                                          (WITH_LANES, ["lanes"])])
def test_a_parent_launcher_with_and_without_lanes(smoke, source, ints):
    assert smoke.c_int_params(source, "ed25519_shamir_verify") == ints
    assert smoke.c_int_params(source, "ed25519_shamir_occupancy") == (
        ["block"] + ints)
    assert smoke.c_int_params(source, "ed25519_shamir_lanes") == []


def test_a_missing_launcher_stops_the_run(smoke):
    with pytest.raises(SystemExit, match="no C function"):
        smoke.c_int_params(ONE_THREAD, "ed25519_windowed_verify")


def fake_lib(target, lanes=2):
    """A library object offering only ``<target>_lanes()``."""
    return types.SimpleNamespace(**{f"{target}_lanes": lambda: lanes})


@pytest.mark.parametrize("target", sorted(TREE))
def test_launch_variants_of_this_trees_launchers(smoke, target):
    """The int each launch passes: the lanes of each lane variant, the
    curve id, or none, as the launcher's own source declares."""
    src = (CSRC / f"{target}.cu").read_text()
    want = {"lanes": [(1, 1), (2, 2)], "curve": [(2, 1)]}.get(
        (TREE[target] or [None])[0], [(2, None)])
    assert smoke.launch_variants(fake_lib(target), src, target, 1) == want


@pytest.mark.parametrize("source, want", [(ONE_THREAD, [(1, None)]),
                                          (WITH_LANES, [(1, 1), (2, 2)])])
def test_launch_variants_of_a_parent_with_and_without_lanes(smoke, source,
                                                            want):
    lib = fake_lib("ed25519_shamir", lanes=1)
    assert smoke.launch_variants(lib, source, "ed25519_shamir") == want
