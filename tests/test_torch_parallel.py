"""The port's sharded verification path (B9, corda_tpu_torch.parallel)
against the JAX package's (corda_tpu.parallel) and the host oracles, on
the CPU.

The port's meshes here are ``[torch.device("cpu")] * k`` — k shards on one
device, each running the plain versions of the kernels; the JAX package's
are ``make_mesh(k)`` over the virtual CPU devices tests/conftest.py gives
it. The JAX sharded Merkle root and transaction step run once each, in a
module fixture. Every comparison is exact.
"""
import hashlib

import jax
import numpy as np
import pytest
import torch

from corda_tpu.ops import ed25519 as jed
from corda_tpu.ops import sha256 as jsha
from corda_tpu.parallel import sharded as jsh
from corda_tpu_torch.ops import ed25519 as ted
from corda_tpu_torch.ops import sha256 as tsha
from corda_tpu_torch.ops import weierstrass as twc
from corda_tpu_torch.parallel import sharded as tsh
from test_torch_ed25519_ladders import _items as _ed_items
from test_torch_weierstrass import K1, R1, _mode_items, _oracle

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mesh(k):
    return tsh.make_mesh(devices=[CPU] * k)


def _host_root(hs):
    while len(hs) > 1:
        hs = [hashlib.sha256(hs[i] + hs[i + 1]).digest()
              for i in range(0, len(hs), 2)]
    return hs[0]


LEAVES32 = [hashlib.sha256(b"leaf %d" % i).digest() for i in range(32)]
LEAVES16 = [hashlib.sha256(b"tx leaf %d" % i).digest() for i in range(16)]
TX_ITEMS, TX_WANT = _ed_items(8)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX sharded Merkle root (32 leaves) and transaction step (8
    signatures, 16 leaves) on a 4-device mesh, one call each."""
    mesh = jsh.make_mesh(4)
    root = np.asarray(jsh.sharded_merkle_root(mesh)(
        jsha.digests_from_bytes(LEAVES32)))
    s_bits, k_bits, neg_a, r_aff, _ = jed.prepare_batch(TX_ITEMS)
    ok, tx_root = jsh.tx_verify_step(mesh)(
        s_bits, k_bits, neg_a, r_aff, jsha.digests_from_bytes(LEAVES16))
    return {"root": root, "tx_ok": np.asarray(ok),
            "tx_root": np.asarray(tx_root)}


@pytest.mark.parametrize("count", range(1, 9))
def test_shard_devices_agree_with_jax(count):
    labels = [f"d{i}" for i in range(count)]
    for n_shards in range(1, count + 1):
        got = tsh.shard_devices(n_shards, labels)
        assert got == jsh.shard_devices(n_shards, labels)
        assert [d for group in got for d in group] == labels
    for bad in (0, count + 1):
        with pytest.raises(ValueError) as want:
            jsh.shard_devices(bad, labels)
        with pytest.raises(ValueError, match=str(want.value)[:12]):
            tsh.shard_devices(bad, labels)


@pytest.mark.parametrize("count", range(1, 9))
def test_make_shard_mesh_and_pad_agree_with_jax(count):
    jdevs = jax.devices()[:count]
    tdevs = [CPU] * count
    for n_shards in range(1, count + 1):
        for idx in range(n_shards):
            jm = jsh.make_shard_mesh(idx, n_shards, jdevs)
            tm = tsh.make_shard_mesh(idx, n_shards, tdevs)
            assert tm.size == jm.devices.size
            assert tm.devices == tuple(tdevs[:tm.size])
        with pytest.raises(ValueError):
            tsh.make_shard_mesh(n_shards, n_shards, tdevs)
    jm, tm = jsh.make_mesh(count), _mesh(count)
    for n in list(range(0, 70)) + [255, 256, 1000, 32768, 32769]:
        assert tsh._pad_to_mesh_bucket(n, tm) == jsh._pad_to_mesh_bucket(
            n, jm)


def test_make_mesh_defaults_to_the_card():
    m = tsh.make_mesh(2, devices=[CPU] * 3)
    assert m.size == 2 and m.streams == (None, None)
    with pytest.raises(ValueError, match="need 4 devices"):
        tsh.make_mesh(4, devices=[CPU] * 3)
    with pytest.raises(ValueError):
        tsh.Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tsh.make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            tsh.shard_devices(1)


def test_a_batch_that_is_not_divisible_raises_the_references_error():
    jm, tm = jsh.make_mesh(4), _mesh(4)
    with pytest.raises(ValueError) as want:
        jsh._check_batch(6, jm, "ed25519")
    with pytest.raises(ValueError) as got:
        tsh._check_batch(6, tm, "ed25519")
    assert str(got.value) == str(want.value)
    *wire, _ = ted.prepare_batch(TX_ITEMS[:6])
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        tsh.sharded_ed25519_verify(tm)(*wire)
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        tsh.sharded_merkle_root(tm)(tsha.digests_from_bytes(LEAVES16[:2]))
    with pytest.raises(ValueError, match="power-of-two"):
        tsh.sharded_merkle_root(tm)(tsha.digests_from_bytes(LEAVES16[:12]))


def test_sharded_merkle_root_matches_jax_and_hashlib(jax_results):
    leaves = tsha.digests_from_bytes(LEAVES32)
    for k in (1, 2, 4):
        root = tsh.sharded_merkle_root(_mesh(k))(leaves)
        assert root.shape == (8,)
        assert np.array_equal(tsha.words_to_numpy(root), jax_results["root"])
        assert tsha.digests_to_bytes(root[None])[0] == _host_root(LEAVES32)


def test_tx_verify_step_matches_jax(jax_results):
    *wire, precheck = ted.prepare_batch(TX_ITEMS)
    ok, root = tsh.tx_verify_step(_mesh(4))(
        *wire, tsha.digests_from_bytes(LEAVES16))
    assert np.array_equal(ok.numpy(), jax_results["tx_ok"])
    assert list(ok.numpy() & precheck) == TX_WANT
    assert np.array_equal(tsha.words_to_numpy(root), jax_results["tx_root"])
    assert tsha.digests_to_bytes(root[None])[0] == _host_root(LEAVES16)


def test_sharded_windowed_and_split_match_unsharded():
    items, want = _ed_items(8)
    *wire, precheck = ted.prepare_batch_windowed(items, device_tables=False)
    ok = tsh.sharded_ed25519_verify_windowed(_mesh(2))(*wire)
    assert list(ok.numpy() & precheck) == want
    *wire, precheck = ted.prepare_batch_split(items)
    ok = tsh.sharded_ed25519_verify_split(_mesh(4))(*wire)
    unsharded = ted.verify_core_split(*ted.wire_to_device(*wire, device=CPU),
                                      *ted.split_tables(CPU))
    assert torch.equal(ok, unsharded)
    assert list(ok.numpy() & precheck) == want


def test_sharded_ecdsa_shamir_takes_the_references_q_triple():
    items = _mode_items(K1, 8, 41)
    u1, u2, q_pts, r_cands, precheck = twc.prepare_batch(K1, items)
    ok = tsh.sharded_ecdsa_verify(_mesh(2), "secp256k1")(
        u1, u2, tuple(q_pts), r_cands)
    assert list(ok.numpy() & precheck) == list(_oracle(K1, items))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("scheme", ["ed25519", "secp256k1",
                                    "secp256k1_words", "secp256r1_words"])
def test_batch_wrappers_match_the_host_oracle(scheme, k):
    mesh = _mesh(k)
    if scheme == "ed25519":
        items, want = _ed_items(11)
        got = tsh.sharded_verify_batch_ed25519(mesh, items)
    else:
        curve = R1 if scheme.startswith("secp256r1") else K1
        items = _mode_items(curve, 7, 50 + k)
        want = list(_oracle(curve, items))
        if scheme == "secp256k1":
            got = tsh.sharded_verify_batch_secp256k1(mesh, items)
        else:
            fn = (tsh.sharded_verify_batch_secp256r1_words
                  if curve is R1 else
                  tsh.sharded_verify_batch_secp256k1_words)
            got = fn(mesh, *twc._items_to_words(items))
    assert got.dtype == bool and list(got) == want
    assert True in want and False in want


def test_empty_batches_resolve_without_a_launch():
    mesh = _mesh(2)
    assert tsh.sharded_verify_batch_ed25519(mesh, []).shape == (0,)
    assert tsh.sharded_verify_batch_secp256k1(mesh, []).shape == (0,)
    empty = np.zeros((0, 4), dtype=np.uint64)
    assert tsh.sharded_verify_batch_secp256r1_words(
        mesh, empty, empty, empty, np.zeros((0, 8), np.uint64)).shape == (0,)
