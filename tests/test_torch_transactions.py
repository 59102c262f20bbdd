"""The port's transaction model and bulk Merkle seams against the JAX
package: WireTransaction ids and bytes, FilteredTransaction build and
verify, batch_merkle's verify_filtered_batch and batch_roots, and
SignedTransactions through the verifier service.

Every comparison is exact. Both packages build the same transactions from
the same seeded 32-byte private keys; transactions cross between the
packages only as the bytes of ``serialize``. The port's device route runs
with ``device="cpu"`` (the plain B6 version); the JAX device route at
``device_crossover=1`` compiles ``hash_pairs``/``merkle_root`` only at a
few small shapes.
"""
import datetime
import importlib
from types import SimpleNamespace

import pytest
import torch

from corda_tpu.verifier import TpuTransactionVerifierService as JaxService

NOTARY_NAME = "O=Notary Service, L=Zurich, C=CH"
FIX_OF = ("ICE LIBOR", "2016-03-16", "3M")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads, so the port's CPU work leaves the cores to the
    JAX tests running beside it in the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Builders shared with tests/test_torch_serialization.py
# ---------------------------------------------------------------------------

def package(root: str) -> SimpleNamespace:
    """The modules of one package (``corda_tpu`` or ``corda_tpu_torch``)
    under the same names, plus its keys from fixed seeds."""
    imp = importlib.import_module
    P = SimpleNamespace(
        root=root,
        crypto=imp(f"{root}.core.crypto"),
        schemes=imp(f"{root}.core.crypto.schemes"),
        merkle=imp(f"{root}.core.crypto.merkle"),
        contracts=imp(f"{root}.core.contracts"),
        identity=imp(f"{root}.core.identity"),
        ser=imp(f"{root}.core.serialization"),
        tx=imp(f"{root}.core.transactions"),
        bm=imp(f"{root}.core.transactions.batch_merkle"),
        dummy=imp(f"{root}.testing.dummy"),
        oracle=imp(f"{root}.samples.rates_oracle"),
    )
    S = P.schemes
    P.kp = {name: P.crypto.generate_keypair(scheme,
                                            entropy=bytes([40 + k]) * 32)
            for k, (name, scheme) in enumerate((
                ("notary", S.ECDSA_SECP256K1_SHA256),
                ("alice", S.EDDSA_ED25519_SHA512),
                ("oracle", S.EDDSA_ED25519_SHA512),
                ("bob", S.ECDSA_SECP256R1_SHA256),
                ("carol", S.ECDSA_SECP256K1_SHA256)))}
    P.key = {n: kp.public for n, kp in P.kp.items()}
    P.notary = P.identity.Party(NOTARY_NAME, P.key["notary"])
    return P


_PACKAGES: dict[str, SimpleNamespace] = {}


def pkgs():
    """(JAX package, port) namespaces, built once per process."""
    for root in ("corda_tpu", "corda_tpu_torch"):
        if root not in _PACKAGES:
            _PACKAGES[root] = package(root)
    return _PACKAGES["corda_tpu"], _PACKAGES["corda_tpu_torch"]


def _time_window(P, i: int):
    t0 = datetime.datetime(2026, 10, 17, 9, 30, i % 60, 123456,
                           tzinfo=datetime.timezone.utc)
    return P.contracts.TimeWindow(t0, t0 + datetime.timedelta(minutes=5))


def oracle_wtx(P, i: int, time_window: bool = False):
    """An oracle-shaped transaction: one DummyState output, a Create and a
    Fix command, notary, two must_sign keys and the type (7 components;
    8 with a time window)."""
    C, O = P.contracts, P.oracle
    fix = O.Fix(O.FixOf(*FIX_OF), 525 + i)
    return P.tx.WireTransaction(
        outputs=(C.TransactionState(
            P.dummy.DummyState(i + 1, (P.key["alice"],)), P.notary),),
        commands=(C.Command(P.dummy.DummyContract.Create(),
                            (P.key["alice"],)),
                  C.Command(fix, (P.key["oracle"],))),
        notary=P.notary, must_sign=(P.key["alice"], P.key["oracle"]),
        time_window=_time_window(P, i) if time_window else None)


def cash_wtx(P, i: int, time_window: bool = False):
    """A cash-shaped transaction: three inputs, two outputs, a Move
    command signed by the two owners (Ed25519, secp256r1), notary, three
    must_sign keys (the owners and the secp256k1 notary, which signs for
    the inputs) and the type (11 components; 12 with a time window)."""
    C = P.contracts
    owners = (P.key["alice"], P.key["bob"], P.key["carol"])
    inputs = tuple(C.StateRef(P.crypto.SecureHash.sha256(
        f"prev {i} {k}".encode()), k) for k in range(3))
    outputs = tuple(C.TransactionState(
        P.dummy.DummyState(100 * i + k, (owners[k],)), P.notary)
        for k in range(2))
    return P.tx.WireTransaction(
        inputs=inputs, outputs=outputs,
        commands=(C.Command(P.dummy.DummyContract.Move(), owners[:2]),),
        notary=P.notary, must_sign=owners[:2] + (P.key["notary"],),
        time_window=_time_window(P, i) if time_window else None)


def reveals_fix(P):
    C, Fix = P.contracts.Command, P.oracle.Fix
    return lambda c: isinstance(c, C) and isinstance(c.value, Fix)


def _tree_hashes(node) -> list:
    if node is None:
        return []
    return [node.hash.bytes] + _tree_hashes(node.left) + _tree_hashes(
        node.right)


_SHAPES = {"oracle": oracle_wtx, "cash": cash_wtx}


# ---------------------------------------------------------------------------
# WireTransaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("time_window", [False, True], ids=["no-tw", "tw"])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_wire_transaction_ids_and_bytes_match_jax(shape, time_window):
    J, T = pkgs()
    for i in range(3):
        jw = _SHAPES[shape](J, i, time_window)
        tw = _SHAPES[shape](T, i, time_window)
        assert tw.serialized == jw.serialized
        assert tw.id.bytes == jw.id.bytes
        assert ([h.bytes for h in tw.available_component_hashes]
                == [h.bytes for h in jw.available_component_hashes])
        assert _tree_hashes(tw.merkle_tree) == _tree_hashes(jw.merkle_tree)
        n = len(tw.available_components)
        assert n == {"oracle": 7, "cash": 11}[shape] + time_window
        # the carry-across function: the port reads the JAX bytes into its
        # own classes and writes them back unchanged, and vice versa
        back = T.ser.deserialize(jw.serialized)
        assert isinstance(back, T.tx.WireTransaction)
        assert back.id.bytes == jw.id.bytes
        assert T.ser.serialize(back) == jw.serialized
        assert J.ser.deserialize(tw.serialized).id.bytes == tw.id.bytes


def test_distinct_transactions_have_distinct_ids():
    _, T = pkgs()
    ids = {oracle_wtx(T, i).id for i in range(8)} | {
        cash_wtx(T, i).id for i in range(8)}
    assert len(ids) == 16


def test_to_ledger_transaction_resolves_like_jax():
    J, T = pkgs()
    lts = []
    for P in (J, T):
        wtx = cash_wtx(P, 2)
        states = {ref: P.contracts.TransactionState(
            P.dummy.DummyState(ref.index, (P.key["alice"],)), P.notary)
            for ref in wtx.inputs}
        ltx = wtx.to_ledger_transaction(_services(P, states))
        ltx.verify()
        lts.append(ltx)
        with pytest.raises(P.contracts.TransactionResolutionException):
            wtx.to_ledger_transaction(_services(P, {}))
    assert J.ser.serialize(lts[0]) == T.ser.serialize(lts[1])


# ---------------------------------------------------------------------------
# FilteredTransaction
# ---------------------------------------------------------------------------

_PREDICATES = {
    "fix-only": reveals_fix,
    "all": lambda P: (lambda c: True),
    "outputs": lambda P: (
        lambda c: isinstance(c, P.contracts.TransactionState)),
    "notary-and-type": lambda P: (
        lambda c: isinstance(c, (P.identity.Party,
                                 P.contracts.TransactionType))),
}


@pytest.mark.parametrize("pred", list(_PREDICATES))
def test_filtered_transactions_match_jax(pred):
    J, T = pkgs()
    for i, tw in ((0, False), (1, True)):
        jf = oracle_wtx(J, i, tw).build_filtered_transaction(
            _PREDICATES[pred](J))
        tf = oracle_wtx(T, i, tw).build_filtered_transaction(
            _PREDICATES[pred](T))
        assert T.ser.serialize(tf) == J.ser.serialize(jf)
        assert tf.verify() is jf.verify() is True
        back = T.ser.deserialize(J.ser.serialize(jf))
        assert isinstance(back, T.tx.FilteredTransaction)
        assert back.verify() is True
        assert T.ser.serialize(back) == J.ser.serialize(jf)


def test_filtered_transaction_failures_match_jax():
    J, T = pkgs()
    outs = []
    for P in (J, T):
        ftx = oracle_wtx(P, 0).build_filtered_transaction(reveals_fix(P))
        other = oracle_wtx(P, 1).build_filtered_transaction(reveals_fix(P))
        wrong_root = P.tx.FilteredTransaction(
            P.crypto.SecureHash.sha256(b"wrong"), ftx.filtered_leaves,
            ftx.partial_merkle_tree)
        swapped = P.tx.FilteredTransaction(
            ftx.root_hash, other.filtered_leaves, ftx.partial_merkle_tree)
        empty = oracle_wtx(P, 0).build_filtered_transaction(lambda c: False)
        with pytest.raises(ValueError):
            empty.verify()
        with pytest.raises(P.crypto.MerkleTreeException):
            P.crypto.PartialMerkleTree.build(
                oracle_wtx(P, 0).merkle_tree,
                [P.crypto.SecureHash.sha256(b"not a leaf")])
        outs.append([wrong_root.verify(), swapped.verify(),
                     P.ser.serialize(empty)])
    assert outs[0] == outs[1]
    assert outs[1][:2] == [False, False]


# ---------------------------------------------------------------------------
# batch_merkle
# ---------------------------------------------------------------------------

def _proof_batch(P):
    """16 oracle tear-offs revealing their Fix command (three rounds of 16
    pairs), a reveal-all and an outputs-only tear-off, a wrong root, a
    swapped revealed leaf, an empty reveal, then the first four again as
    the same objects (shared nodes). Returns (ftxs, expected)."""
    wtxs = [oracle_wtx(P, i, time_window=i % 5 == 0) for i in range(16)]
    ftxs = [w.build_filtered_transaction(reveals_fix(P)) for w in wtxs]
    ftxs.append(wtxs[0].build_filtered_transaction(lambda c: True))
    ftxs.append(wtxs[1].build_filtered_transaction(
        _PREDICATES["outputs"](P)))
    ftxs.append(P.tx.FilteredTransaction(
        P.crypto.SecureHash.sha256(b"wrong"), ftxs[2].filtered_leaves,
        ftxs[2].partial_merkle_tree))
    ftxs.append(P.tx.FilteredTransaction(
        ftxs[3].root_hash, ftxs[4].filtered_leaves,
        ftxs[3].partial_merkle_tree))
    ftxs.append(wtxs[5].build_filtered_transaction(lambda c: False))
    ftxs += ftxs[:4]
    want = [True] * 18 + [False, False, False] + [True] * 4
    return ftxs, want


def _hostile_batch(P):
    """The hostile members of tests/test_hostile_inputs.py around a good
    proof: a chain past MAX_PROOF_DEPTH, a junk node, an ftx without any
    attributes, and a small unbalanced tree inside the cap."""
    import hashlib
    M, H = P.merkle, P.crypto.SecureHash
    la, lb = H.sha256(b"a"), H.sha256(b"b")

    def ftx(root, hashes, root_hash):
        return SimpleNamespace(
            partial_merkle_tree=SimpleNamespace(root=root),
            filtered_leaves=SimpleNamespace(
                available_component_hashes=hashes),
            root_hash=root_hash)
    good = ftx(M._Node(M._IncludedLeaf(la), M._IncludedLeaf(lb)), [la, lb],
               H(hashlib.sha256(la.bytes + lb.bytes).digest()))
    chain = M._IncludedLeaf(H.sha256(b"x"))
    for _ in range(P.bm.MAX_PROOF_DEPTH + 200):
        chain = M._Node(chain, M._Leaf(H.sha256(b"pad")))
    inner_h = hashlib.sha256(la.bytes + lb.bytes).digest()
    lc = H.sha256(b"c")
    unbalanced = ftx(M._Node(M._Node(M._IncludedLeaf(la),
                                     M._IncludedLeaf(lb)), M._Leaf(lc)),
                     [la, lb], H(hashlib.sha256(inner_h + lc.bytes).digest()))
    ftxs = [good, ftx(chain, [H.sha256(b"x")], H.sha256(b"x")), good,
            ftx("not a tree node", [H.sha256(b"x")], H.sha256(b"x")),
            SimpleNamespace(), unbalanced, good]
    return ftxs, [True, False, True, False, False, True, True]


@pytest.mark.parametrize("batch", ["proofs", "hostile"])
def test_verify_filtered_batch_matches_jax(batch):
    J, T = pkgs()
    make = _proof_batch if batch == "proofs" else _hostile_batch
    jftxs, want = make(J)
    tftxs, _ = make(T)
    from corda_tpu_torch.ops import sha256 as tsha
    before = tsha.hash_pairs.launches
    got_dev = T.bm.verify_filtered_batch(tftxs, device_crossover=1,
                                         device="cpu")
    assert tsha.hash_pairs.launches == before      # the CPU launches nothing
    got_host = T.bm.verify_filtered_batch(tftxs, use_device=False)
    got_default = T.bm.verify_filtered_batch(tftxs)  # every round < 2^17
    jax_dev = J.bm.verify_filtered_batch(jftxs, device_crossover=1)
    jax_host = J.bm.verify_filtered_batch(jftxs, use_device=False)
    assert got_dev == got_host == got_default == jax_dev == jax_host == want
    for ftx, ok in zip(tftxs, want):
        if ok and hasattr(ftx, "verify"):
            assert ftx.verify()


def test_batch_roots_match_jax_and_transaction_ids():
    J, T = pkgs()
    lists, jlists, ids = [], [], []
    for i in range(12):
        for shape in ("oracle", "cash"):
            for P, out in ((T, lists), (J, jlists)):
                w = _SHAPES[shape](P, i)
                out.append(w.available_component_hashes)
            ids.append(_SHAPES[shape](T, i).id.bytes)
    lists += [lists[0][:1], lists[1][:3], lists[1][:5]]
    jlists += [jlists[0][:1], jlists[1][:3], jlists[1][:5]]
    want = ids + [T.crypto.MerkleTree.root_hash(h).bytes for h in lists[-3:]]
    got_dev = T.bm.batch_roots(lists, device_crossover=1, device="cpu")
    got_host = T.bm.batch_roots(lists, use_device=False)
    got_default = T.bm.batch_roots(lists)
    jax_dev = J.bm.batch_roots(jlists, device_crossover=1)
    for got in (got_dev, got_host, got_default, jax_dev):
        assert [h.bytes for h in got] == want
    with pytest.raises(ValueError):
        T.bm.batch_roots([[]], device="cpu")


def test_default_device_raises_without_cuda_when_a_round_reaches_the_crossover():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    _, T = pkgs()
    ftxs = [oracle_wtx(T, i).build_filtered_transaction(reveals_fix(T))
            for i in range(4)]
    lists = [f.filtered_leaves.available_component_hashes * 2 for f in ftxs]
    with pytest.raises(RuntimeError, match="cuda"):
        T.bm.verify_filtered_batch(ftxs, device_crossover=4)
    with pytest.raises(RuntimeError, match="cuda"):
        T.bm.batch_roots(lists, device_crossover=4)
    # below the crossover the rounds stay on hashlib and nothing is asked
    # of the device
    assert T.bm.verify_filtered_batch(ftxs, device_crossover=5) == [True] * 4
    assert len(T.bm.batch_roots(lists, device_crossover=5)) == 4
    assert T.bm.DEVICE_CROSSOVER == 1 << 17


# ---------------------------------------------------------------------------
# SignedTransaction through verify_signed
# ---------------------------------------------------------------------------

class _Attachments:
    def open_attachment(self, att_id):
        return None


def _services(P, states: dict):
    return SimpleNamespace(load_state=states.get, attachments=_Attachments())


def _signed_cases(J):
    """(name, JAX SignedTransaction, states) cases: fully signed oracle and
    cash transactions, a tampered signature, a missing signer and an
    unresolvable input."""
    sign = J.crypto.Crypto.sign_with_key
    cases = []
    ow = oracle_wtx(J, 3, time_window=True)
    cw = cash_wtx(J, 4)
    states = {ref: J.contracts.TransactionState(
        J.dummy.DummyState(ref.index, (J.key["alice"],)), J.notary)
        for ref in cw.inputs}

    def sigs(wtx, names):
        return [sign(J.kp[n], wtx.id.bytes) for n in names]
    cases.append(("oracle", J.tx.SignedTransaction.of(
        ow, sigs(ow, ["alice", "oracle"])), {}))
    cases.append(("cash", J.tx.SignedTransaction.of(
        cw, sigs(cw, ["alice", "bob", "notary"])), states))
    good = sigs(cw, ["alice", "bob", "notary"])
    bad = good[1].__class__(good[1].bytes[:-1] + bytes([good[1].bytes[-1]
                                                       ^ 1]), good[1].by)
    cases.append(("bad-sig", J.tx.SignedTransaction.of(
        cw, [good[0], bad, good[2]]), states))
    cases.append(("missing-signer", J.tx.SignedTransaction.of(
        ow, sigs(ow, ["alice"])), {}))
    cases.append(("unresolved-input", J.tx.SignedTransaction.of(
        cw, good), {}))
    return cases


def _outcome(fut):
    try:
        fut.result(timeout=300)
        return ("ok", "")
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))


def test_signed_transactions_through_verify_signed_match_jax_service():
    """Each case's JAX bytes, read by the port, through the port's
    verify_signed: the same outcome (type and message) as the JAX service.
    The cases take the batcher's host route (below its host crossover);
    the fully signed cash transaction — one Ed25519, one secp256r1 and one
    secp256k1 signature — then goes through the device buckets as well
    (host_crossover=0: plain B2, B4 and B3 on the CPU)."""
    from corda_tpu_torch.verifier import (SignatureBatcher,
                                          TpuTransactionVerifierService)
    J, T = pkgs()
    cases = _signed_cases(J)
    jax_svc = JaxService()
    host_svc = TpuTransactionVerifierService(batcher=SignatureBatcher(
        device="cpu", max_latency_s=0.01))
    dev_svc = TpuTransactionVerifierService(batcher=SignatureBatcher(
        device="cpu", host_crossover=0, max_latency_s=0.01))
    try:
        for name, jstx, jstates in cases:
            raw = J.ser.serialize(jstx)
            stx = T.ser.deserialize(raw)
            assert isinstance(stx, T.tx.SignedTransaction), name
            assert T.ser.serialize(stx) == raw
            assert stx.id.bytes == jstx.id.bytes
            tstates = {T.ser.deserialize(J.ser.serialize(ref)):
                       T.ser.deserialize(J.ser.serialize(st))
                       for ref, st in jstates.items()}
            want = _outcome(jax_svc.verify_signed(jstx,
                                                  _services(J, jstates)))
            got = _outcome(host_svc.verify_signed(stx,
                                                  _services(T, tstates)))
            assert got == want, name
            assert (want[0] == "ok") == (name in ("oracle", "cash")), want
            if name == "cash":
                assert _outcome(dev_svc.verify_signed(
                    stx, _services(T, tstates))) == want
        host = host_svc.batcher.metrics.snapshot()
        assert host["SigBatcher.HostRouted"]["count"] == 2 + 3 + 3 + 1 + 3
        dev = dev_svc.batcher.metrics.snapshot()
        assert dev["SigBatcher.DeviceChecked"]["count"] == 3
        assert dev["SigBatcher.DeviceBatches"]["count"] == 3
    finally:
        jax_svc.shutdown()
        host_svc.shutdown()
        dev_svc.shutdown()


def test_signed_transaction_api_matches_jax():
    J, T = pkgs()
    _, jstx, _ = _signed_cases(J)[3]          # alice signed, oracle missing
    stx = T.ser.deserialize(J.ser.serialize(jstx))
    assert ({k.encoded for k in stx.get_missing_signatures()}
            == {k.encoded for k in jstx.get_missing_signatures()}
            == {T.key["oracle"].encoded})
    with pytest.raises(T.tx.SignaturesMissingException):
        stx.verify_signatures()
    assert stx.verify_signatures(T.key["oracle"]) == {T.key["oracle"]}
    extra = T.crypto.Crypto.sign_with_key(T.kp["oracle"], stx.id.bytes)
    full = stx.plus(extra)
    assert full.get_missing_signatures() == set()
    assert full.tx is stx.tx and full.id == stx.id
    jfull = jstx.plus(J.crypto.Crypto.sign_with_key(J.kp["oracle"],
                                                    jstx.id.bytes))
    assert T.ser.serialize(full) == J.ser.serialize(jfull)
    with pytest.raises(ValueError):
        T.tx.SignedTransaction(stx.tx_bits, ())
    with pytest.raises(ValueError):
        T.tx.SignedTransaction(T.ser.serialize(T.key["alice"]),
                               stx.sigs).tx
    assert stx == T.ser.deserialize(T.ser.serialize(stx))
