"""The port's key-value store against the JAX package's
(tests/test_kvstore.py): each engine (the port's native kvlog library,
built from ``native/kvlog.cpp`` into the port's build directory, and its
pure-Python engine) keeps the reference's semantics, and a log written by
either package's engine is read back by the other's, with a torn tail
truncated to the same length."""
import os

import pytest

from corda_tpu.storage import kvstore as jkv
from corda_tpu_torch.storage import kvstore as tkv

PORT_ENGINES = [False] + ([True] if tkv.NATIVE_AVAILABLE else [])
REF_ENGINES = [False] + ([True] if jkv.NATIVE_AVAILABLE else [])


def _id(native):
    return "native" if native else "py"


@pytest.mark.parametrize("native", PORT_ENGINES, ids=_id)
def test_roundtrip_and_recovery(tmp_path, native):
    path = str(tmp_path / "store.kv")
    kv = tkv.KvStore(path, use_native=native)
    assert kv.native == native
    kv[b"alpha"] = b"1"
    kv[b"beta"] = b"2" * 1000
    kv[b"alpha"] = b"updated"
    del kv[b"beta"]
    assert kv[b"alpha"] == b"updated"
    assert b"beta" not in kv
    kv.close()
    kv2 = tkv.KvStore(path, use_native=native)
    assert kv2[b"alpha"] == b"updated"
    assert b"beta" not in kv2
    assert len(kv2) == 1
    kv2.close()


@pytest.mark.parametrize("native", PORT_ENGINES, ids=_id)
def test_compaction_drops_dead_records(tmp_path, native):
    path = str(tmp_path / "store.kv")
    kv = tkv.KvStore(path, use_native=native)
    for _ in range(50):
        kv[b"churn"] = b"x" * 100
    kv[b"keep"] = b"forever"
    before = os.path.getsize(path)
    kv.compact()
    assert os.path.getsize(path) < before / 10
    assert kv[b"churn"] == b"x" * 100 and kv[b"keep"] == b"forever"
    kv.close()
    kv2 = tkv.KvStore(path, use_native=native)
    assert len(kv2) == 2
    kv2.close()


def _write(mod, path, native):
    kv = mod.KvStore(path, use_native=native)
    kv[b"k1"] = b"v1"
    kv[b"k2"] = b"v" * 3000
    kv[b"k1"] = b"v1-updated"
    kv[b"gone"] = b"soon"
    del kv[b"gone"]
    kv[b""] = b"empty key"
    kv.close()


@pytest.mark.parametrize("writer", [
    (pkg, native) for pkg, engines in (("corda_tpu", REF_ENGINES),
                                       ("corda_tpu_torch", PORT_ENGINES))
    for native in engines], ids=lambda w: f"{w[0]}-{_id(w[1])}")
def test_logs_cross_between_the_packages(tmp_path, writer):
    """A log written by one package's engine: both packages' engines read
    the same items; a torn tail appended to a copy of it is truncated to
    the same length by each reader, leaving the same items, and the files
    are byte-identical to what the port's Python engine writes."""
    pkg, native = writer
    path = str(tmp_path / "w.kv")
    _write(jkv if pkg == "corda_tpu" else tkv, path, native)
    with open(path, "rb") as f:
        written = f.read()
    ref_path = str(tmp_path / "py.kv")
    _write(tkv, ref_path, False)
    with open(ref_path, "rb") as f:
        assert written == f.read()
    readers = [(jkv, n) for n in REF_ENGINES] + [(tkv, n) for n in PORT_ENGINES]
    for i, (mod, rnative) in enumerate(readers):
        torn = str(tmp_path / f"torn{i}.kv")
        with open(torn, "wb") as f:
            f.write(written + b"\x00\x01\x02\x03\x04\x05garbage")
        kv = mod.KvStore(torn, use_native=rnative)
        assert sorted(kv.items()) == [(b"", b"empty key"),
                                      (b"k1", b"v1-updated"),
                                      (b"k2", b"v" * 3000)]
        kv.close()
        assert os.path.getsize(torn) == len(written)


def test_native_engine_is_built_from_the_repository_source():
    if not tkv.NATIVE_AVAILABLE:
        pytest.skip("no C++ compiler to build native/kvlog.cpp")
    from corda_tpu_torch import _build
    lib = tkv._native_lib()
    path = _build._output_path("kvlog")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.exists(path)
    assert lib is _build.load("kvlog")
