"""The build keys of the port's native libraries (corda_tpu_torch/_build.py):
a library's file name carries a hash of its sources and of every header they
include, so an edit to any header a kernel reaches renames the library and a
stale build is never loaded. No compiler is needed: the tests read the
sources' quoted ``#include`` lines themselves.
"""
import pathlib
import re
import shutil

import pytest

from corda_tpu_torch import _build

CSRC = pathlib.Path(_build.CSRC)


def _reachable(sources) -> set:
    """The files that ``sources`` reach through quoted includes, each
    resolved beside the file that names it."""
    seen, todo = set(), [pathlib.Path(s) for s in sources]
    while todo:
        src = todo.pop()
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                               src.read_text(), re.M):
            path = (src.parent / name).resolve()
            if path not in seen:
                seen.add(path)
                todo.append(path)
    return seen


@pytest.mark.parametrize("target", sorted(_build._TARGETS))
def test_every_target_hashes_exactly_the_headers_it_includes(target):
    t = _build._TARGETS[target]
    assert {pathlib.Path(d).resolve() for d in t["deps"]} == _reachable(
        t["sources"])


def test_the_pair_kernels_hash_their_pair_headers():
    """B3 and B8 Shamir include the lane-pair curves, which pull in the
    Comba fields, the carry chains and the lane exchanges."""
    names = {t: {pathlib.Path(d).name for d in _build._TARGETS[t]["deps"]}
             for t in ("secp256k1_hybrid", "weierstrass_shamir")}
    pair = {"carry.cuh", "lanes.cuh"}
    assert names["secp256k1_hybrid"] >= {"curve_k1_pair.cuh",
                                         "field_k1_comba.cuh"} | pair
    assert names["weierstrass_shamir"] >= {
        "curve_k1_pair.cuh", "field_k1_comba.cuh", "curve_p256_pair.cuh",
        "field_p256_comba.cuh"} | pair


def test_a_header_edit_renames_exactly_the_libraries_that_reach_it(
        tmp_path, monkeypatch):
    """On a copy of csrc/: appending a comment to carry.cuh (two includes
    deep under the pair kernels) changes the library name of every target
    that reaches it and of no other."""
    src = tmp_path / "csrc"
    shutil.copytree(CSRC, src)
    targets = {}
    for name, t in _build._TARGETS.items():
        if name == "scalarmath":
            continue
        sources = [str(src / pathlib.Path(s).name) for s in t["sources"]]
        targets[name] = {**t, "sources": sources,
                         "deps": _build.include_closure(sources)}
    monkeypatch.setattr(_build, "_TARGETS", targets)
    before = {n: _build._output_path(n) for n in targets}
    with open(src / "carry.cuh", "a") as f:
        f.write("// edited\n")
    changed = {n for n in targets if _build._output_path(n) != before[n]}
    reach = {n for n, t in targets.items()
             if str(src / "carry.cuh") in t["deps"]}
    assert changed == reach
    assert {"secp256k1_hybrid", "weierstrass_shamir", "ed25519_split",
            "secp256r1_split"} <= reach
    assert "sha256" not in reach
