"""The port's consensus package against the JAX package's: every case of
the reference's Raft and BFT tests (tests/test_raft.py,
test_raft_durable.py, test_raftcore.py and test_bft.py) run on both
packages and compared, and the wire between the packages.

Each reference test file runs twice: as the reference's own module, and
as a twin of the port, its source executed with every ``corda_tpu.``
module naming ``corda_tpu_torch.`` (``twin``, on tests/test_torch_flow_
framework.py's ``twin_module``; the cases are tests/test_torch_finance.
py's ``reference_cases``). A case passes when it
passes on the reference and ends the same way on the port, and when a
:class:`Recorder` finds the two runs alike:

* where the case pumps the bus itself (``mode="ticks"``), every tick of
  every replica leaves a row — its role, term, leader, commit index, log
  and the entries it applied, and its state machine's map — and the
  port's rows must equal the reference's row for row. Elections run on
  ticks and on a ``random.Random`` seeded by the node, the fault injector
  on its seed, so a seeded scenario takes the same course in both
  packages;
* where threads run (``mode="threads"``: the group committer, the 2PC
  pool, a commit on a thread of its own), timing decides batch cuts, so
  the runs are compared by outcome: every commit's verdict (the result,
  or the exception's type and message, in call order) and the map each
  replica group converges to (each ref with its owner). Where such a
  case may end more than one way (two spends racing), the port's record
  must equal one the reference made in up to THREAD_ATTEMPTS runs.

Wire messages carry ``perf_counter`` stamps (``ClientRequest.
submit_perf_ns``, ``ClientResponse.resolved_perf_ns``); no row holds a
message, so no row holds a stamp. Logs, maps and verdicts are compared as
``serialize`` bytes, which both packages write alike.

A BFT replica's row holds its view, executed watermark, next sequence,
pending and executed requests, applied entries and state machine. A BFT
replica learns a state response's sender from the bus, so the port's
in-memory bus must name senders as the reference's does: the
state-transfer cases hold that.

The harness serves the chaos twins (tests/test_torch_chaos_*.py) too."""
import hashlib
import importlib
import inspect
import pathlib
import tempfile
import threading

import pytest

from test_torch_finance import reference_cases
from test_torch_flow_framework import PKGS, mod, twin_module

TESTS = pathlib.Path(__file__).resolve().parent


def twin(name: str, subs: tuple = ()):
    """The port's twin of tests/<name>.py: its source with each ``(old,
    new)`` of ``subs`` applied, every ``corda_tpu.`` module then naming
    ``corda_tpu_torch.``."""
    src = (TESTS / f"{name}.py").read_text()
    for old, new in subs:
        assert old in src, old
        src = src.replace(old, new)
    return twin_module("corda_tpu_torch", name, src)


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class Recorder:
    """What one package's run of a case left behind. Installs itself on
    ``pkg``'s consensus classes through ``monkeypatch``: every Raft, native
    Raft and BFT replica built records the entries it applies, every tick
    appends the replica's row (``ticks`` mode), and every state machine
    and coordinator log built is kept for the final comparison. In
    ``threads`` mode the uniqueness entry points record their verdicts."""

    def __init__(self, pkg: str, monkeypatch, mode: str):
        self.pkg = pkg
        self.mode = mode
        self.rows: list = []
        self.replicas: list = []
        self.maps: list = []
        self.logs: list = []
        self.verdicts: list = []
        self._depth = threading.local()
        self.ser = mod(pkg, "core.serialization").serialize
        raft = mod(pkg, "consensus.raft")
        native = mod(pkg, "consensus.raftcore")
        bft = mod(pkg, "consensus.bft")
        uniq = mod(pkg, "consensus.raft_uniqueness")
        sharded = mod(pkg, "consensus.sharded_uniqueness")
        pipeline = mod(pkg, "consensus.commit_pipeline")
        for cls in (raft.RaftNode, native.NativeRaftNode, bft.BFTReplica):
            self._patch_replica(monkeypatch, cls)
        self._patch_registry(monkeypatch, uniq.DistributedImmutableMap,
                             self.maps)
        self._patch_registry(monkeypatch, sharded.CoordinatorLog, self.logs)
        if mode == "threads":
            for cls, names in (
                    (pipeline.GroupCommitter, ("submit",)),
                    (uniq.RaftUniquenessProvider, ("commit", "commit_async")),
                    (sharded.ShardedUniquenessProvider,
                     ("commit", "commit_async", "recover_in_doubt")),
                    (bft.BFTUniquenessProvider, ("commit",))):
                for name in names:
                    self._patch_verdict(monkeypatch, cls, name)

    # -- patches -------------------------------------------------------------
    def _patch_replica(self, monkeypatch, cls) -> None:
        init, tick = cls.__init__, cls.tick
        rec = self

        def __init__(node, *a, **kw):
            init(node, *a, **kw)
            node.twin_applied = []
            apply = node.apply_fn
            node.twin_state_machine = getattr(apply, "__self__", None)

            def recording_apply(entry):
                node.twin_applied.append(rec.ser(entry))
                return apply(entry)
            node.apply_fn = recording_apply
            rec.replicas.append(node)

        def tick_(node):
            tick(node)
            if rec.mode == "ticks":
                rec.rows.append(rec.row(node))
        monkeypatch.setattr(cls, "__init__", __init__)
        monkeypatch.setattr(cls, "tick", tick_)

    @staticmethod
    def _patch_registry(monkeypatch, cls, registry: list) -> None:
        init = cls.__init__

        def __init__(obj, *a, **kw):
            init(obj, *a, **kw)
            registry.append(obj)
        monkeypatch.setattr(cls, "__init__", __init__)

    def _patch_verdict(self, monkeypatch, cls, name: str) -> None:
        """Record the verdict of each outermost call of ``cls.name`` (a
        nested call, e.g. the sharded provider's into a shard's committer,
        is part of its caller's verdict), in call order: the result, or
        the exception's type and message; a returned future's once it
        resolves."""
        fn = getattr(cls, name)
        rec = self

        def call(obj, *a, **kw):
            depth = getattr(rec._depth, "n", 0)
            if depth:
                return fn(obj, *a, **kw)
            slot = len(rec.verdicts)
            rec.verdicts.append((f"{cls.__name__}.{name}", "pending"))
            rec._depth.n = 1
            try:
                out = fn(obj, *a, **kw)
            except Exception as exc:
                rec.verdicts[slot] = (rec.verdicts[slot][0],
                                      type(exc).__name__, str(exc))
                raise
            finally:
                rec._depth.n = 0
            if hasattr(out, "add_done_callback"):
                def done(fut):
                    exc = fut.exception()
                    rec.verdicts[slot] = (
                        (rec.verdicts[slot][0], "ok",
                         _digest(rec.ser(fut.result()))) if exc is None
                        else (rec.verdicts[slot][0], type(exc).__name__,
                              str(exc)))
                out.add_done_callback(done)
            else:
                rec.verdicts[slot] = (rec.verdicts[slot][0], "ok",
                                      _digest(rec.ser(out)))
            return out
        monkeypatch.setattr(cls, name, call)

    # -- rows ----------------------------------------------------------------
    def canon_map(self, sm) -> tuple:
        """A state machine's consumed and reserved maps as sorted
        ``serialize`` bytes: equal maps give equal rows whatever order
        their entries arrived in."""
        if sm is None or not hasattr(sm, "_map"):
            return ()
        return tuple(_digest(b"".join(sorted(
            self.ser(k) + self.ser(v) for k, v in part.items())))
            for part in (sm._map, sm._reserved))

    def row(self, node) -> tuple:
        applied = _digest(b"".join(node.twin_applied))
        sm = self.canon_map(node.twin_state_machine)
        if hasattr(node, "replica_id"):          # BFT
            return ("bft", node.replica_id, node.view, node.executed_through,
                    node.next_seq, tuple(sorted(node._pending)),
                    len(node._executed_requests), applied, sm)
        if hasattr(node, "state"):               # Python Raft
            st = node.state
            return ("raft", node.node_id, node.role, st.current_term,
                    node.leader_id, st.commit_index, st.last_applied,
                    st.snapshot_index, _digest(self.ser(st.log)), applied, sm)
        stats = node.stats()                     # native Raft
        return ("native", node.node_id, stats["role"], stats["term"],
                stats["leader_id"], stats["commit_index"],
                stats["log_entries"], applied, sm)

    def final(self) -> dict:
        """Every replica's last row, every state machine's map and every
        coordinator log's in-doubt set and size."""
        logs = []
        for log in self.logs:
            entries = sorted(
                (self.ser(tx).hex(), e["status"],
                 sorted((s, self.ser(list(refs)).hex())
                        for s, refs in e["by_shard"].items()))
                for tx, e in log.in_doubt())
            logs.append((entries, log.bytes_appended, log.compactions))
        out = {"logs": logs}
        if self.mode == "ticks":
            out["maps"] = [self.canon_map(m) for m in self.maps]
            out["replicas"] = [self.row(n) for n in self.replicas]
        else:
            out["maps"] = self.converged()
            out["verdicts"] = list(self.verdicts)
        return out

    def converged(self) -> list:
        """The map each replica group converges to: the consumed and
        reserved refs, each with its owner (the consuming transaction), on
        the group's most advanced replica. A case ends once the replicas
        it waits on agree; a replica it does not wait on (one cut off,
        still catching up) may hold less at that moment, in either
        package, and a later apply of the same transaction's commit may
        rewrite an entry's other fields."""
        best: dict = {}
        for node in self.replicas:
            sm = node.twin_state_machine
            if not hasattr(sm, "_map"):
                continue
            if hasattr(node, "replica_id"):          # BFT
                group, done = tuple(node.replicas), node.executed_through
            elif hasattr(node, "state"):             # Python Raft
                group = tuple(sorted([node.node_id, *node.peers]))
                done = node.state.last_applied
            else:                                    # native Raft
                group, done = tuple(sorted(node.names)), node.commit_index
            if group not in best or done > best[group][0]:
                best[group] = (done, sm)
        return [tuple(_digest(b"".join(sorted(
            self.ser(k) + self.ser(v.consuming_tx)
            for k, v in part.items())))
            for part in (sm._map, sm._reserved))
            for _, (_, sm) in sorted(best.items())]


def resolve_and_run(module, attr: str, params: dict, tmp: pathlib.Path):
    """``module.attr`` with its parameters and ``tmp_path``: ("ok",) or
    the exception's type and message."""
    fn = getattr(module, attr)
    kwargs = {}
    for p in inspect.signature(fn).parameters:
        if p in params:
            kwargs[p] = params[p]
        elif p == "tmp_path":
            tmp.mkdir(parents=True, exist_ok=True)
            kwargs[p] = tmp
        else:
            raise AssertionError(f"{attr}: no value for {p}")
    try:
        fn(**kwargs)
        return ("ok",)
    except Exception as exc:   # the outcome under comparison
        return (type(exc).__name__, str(exc))


def first_difference(a: list, b: list) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"row {i}: reference {x} != port {y}"
    return f"{len(a)} reference rows, {len(b)} port rows"


#: Runs of a threaded case: where the port's record matches no reference
#: record yet, the pair runs again. A threaded case may end more than one
#: way by its clock (two cross-shard spends racing for one ref: either
#: wins), so the port's record must equal one the reference made.
THREAD_ATTEMPTS = 3


def run_twin(name: str, attr: str, params: dict, tmp_path,
             mode: str = "ticks", subs: tuple = ()) -> dict:
    """The case on both packages. ``ticks``: one after the other, rows and
    final states compared; ``threads``: both at once (each package's
    threads, clocks and fault injector are its own), outcomes compared,
    up to THREAD_ATTEMPTS pairs. Fails unless the case passes on the
    reference and the port's record equals a record the reference made.
    Returns {pkg: Recorder} of the last pair."""
    modules = {"corda_tpu": importlib.import_module(name),
               "corda_tpu_torch": twin(name, subs)}
    seen = []
    for attempt in range(1 if mode == "ticks" else THREAD_ATTEMPTS):
        outcomes = {}

        def run(pkg):
            outcomes[pkg] = resolve_and_run(modules[pkg], attr, params,
                                            tmp_path / f"{pkg}-{attempt}")
        with pytest.MonkeyPatch.context() as mp:
            recs = {pkg: Recorder(pkg, mp, mode) for pkg in PKGS}
            if mode == "ticks":
                for pkg in PKGS:
                    run(pkg)
            else:
                threads = [threading.Thread(target=run, args=(pkg,))
                           for pkg in PKGS]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        assert outcomes["corda_tpu"] == ("ok",), outcomes["corda_tpu"]
        assert outcomes["corda_tpu_torch"] == ("ok",), \
            outcomes["corda_tpu_torch"]
        ref, port = recs["corda_tpu"], recs["corda_tpu_torch"]
        if mode == "ticks":
            assert port.rows == ref.rows, first_difference(ref.rows,
                                                           port.rows)
        seen.append(ref.final())
        if port.final() in seen:
            return recs
    assert port.final() == seen[-1]
    return recs


#: tests/test_raftcore.py reads the reference's module-level library
#: handle; the port's replica holds its library on the instance.
RAFTCORE_SUBS = (("rc._LIB.raft_last_index(follower._handle)",
                  "follower._lib.raft_last_index(follower._handle)"),)
#: cases whose commits run on threads of their own
THREADED = {"test_raft_uniqueness_provider_conflicts",
            "test_bft_uniqueness_provider"}


@pytest.mark.parametrize("name,attr,params",
                         reference_cases("test_raft")
                         + reference_cases("test_raft_durable")
                         + reference_cases("test_bft"))
def test_consensus_case_matches_reference(name, attr, params, tmp_path):
    run_twin(name, attr, params, tmp_path,
             "threads" if attr in THREADED else "ticks")


@pytest.mark.parametrize("name,attr,params",
                         reference_cases("test_raftcore"))
def test_raftcore_case_matches_reference(name, attr, params, tmp_path):
    """The native core: built from native/raftcore.cpp by the port's
    _build (the reference loads native/libraftcore.so); the last case is
    a mixed cluster, native and Python replicas of the port committing
    together."""
    from corda_tpu_torch.consensus import raftcore
    assert raftcore.NATIVE_RAFT_AVAILABLE
    recs = run_twin(name, attr, params, tmp_path, subs=RAFTCORE_SUBS)
    kinds = {row[0] for row in recs["corda_tpu_torch"].final()["replicas"]}
    assert "native" in kinds
    if attr == "test_mixed_native_python_cluster":
        assert kinds == {"native", "raft"}


def test_native_replica_loads_the_ports_build_of_raftcore():
    """NativeRaftNode's library is the one _build made from
    native/raftcore.cpp, never native/libraftcore.so."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.consensus.raftcore import NativeRaftNode
    from corda_tpu_torch.network.inmemory import InMemoryMessagingNetwork
    bus = InMemoryMessagingNetwork()
    node = NativeRaftNode("r0", ["r0"], bus.create_node("r0"), lambda e: e)
    path = pathlib.Path(node._lib._name).resolve()
    assert path.parent == pathlib.Path(_build.BUILD_DIR).resolve()
    assert path.name.startswith("libraftcore-")
    assert _build._TARGETS["raftcore"]["sources"] == [
        str(pathlib.Path(_build._REPO) / "native" / "raftcore.cpp")]


def test_a_failed_build_raises_and_gives_no_python_replica(monkeypatch):
    """Where the core can be had but its build fails, build(native=None)
    raises BuildError: it never hands back a Python replica instead."""
    from corda_tpu_torch import _build
    from corda_tpu_torch.consensus import raftcore
    from corda_tpu_torch.consensus.raft_uniqueness import \
        RaftUniquenessProvider
    from corda_tpu_torch.network.inmemory import InMemoryMessagingNetwork

    def broken(name):
        raise _build.BuildError(f"building {name} failed (exit 1)")
    monkeypatch.setattr(raftcore, "NATIVE_RAFT_AVAILABLE", True)
    raftcore._native_lib.cache_clear()
    monkeypatch.setattr(_build, "load", broken)
    try:
        bus = InMemoryMessagingNetwork()
        with pytest.raises(_build.BuildError):
            RaftUniquenessProvider.build("r0", ["r0"], bus.create_node("r0"))
    finally:
        raftcore._native_lib.cache_clear()
    # native=False and durable storage keep the Python replica
    provider = RaftUniquenessProvider.build(
        "r1", ["r1"], bus.create_node("r1"), native=False)
    assert type(provider.raft).__name__ == "RaftNode"
    with tempfile.TemporaryDirectory() as tmp:
        provider = RaftUniquenessProvider.build(
            "r2", ["r2"], bus.create_node("r2"),
            storage_path=str(pathlib.Path(tmp) / "r2.kv"))
        assert type(provider.raft).__name__ == "RaftNode"
        provider.raft.storage.close()


# -- the wire between the packages --------------------------------------------

def wire_samples(pkg: str) -> list:
    """One message of every ``raft.*`` and ``bft.*`` wire type, the same
    fields in both packages (commands carry StateRefs and SecureHashes as
    the notary's do)."""
    raft = mod(pkg, "consensus.raft")
    bft = mod(pkg, "consensus.bft")
    structures = mod(pkg, "core.contracts.structures")
    sh = mod(pkg, "core.crypto.secure_hash").SecureHash
    tx = sh.sha256(b"spend")
    refs = [structures.StateRef(sh.sha256(b"issue-%d" % i), i)
            for i in range(3)]
    put = ("put_all", [tx, refs, "O=Payer, L=Oslo, C=NO"])
    batch = ("put_all_batch", [[tx, refs[:1], "a"], [sh.sha256(b"b"),
                                                     refs[1:], "b"]])
    entries = (raft.LogEntry(3, raft.NOOP), raft.LogEntry(3, put, "r1", 7),
               raft.LogEntry(4, batch, "r2", 8))
    request = bft.Request(5, "client", put)
    pp = bft.PrePrepare(1, 9, bft._digest(request), request)
    prepares = tuple(bft.Prepare(1, 9, pp.digest, f"bft{i}")
                     for i in range(3))
    cert = bft.PreparedCert(pp, prepares)
    vcs = (bft.ViewChange(2, "bft1", 8, (cert,)),
           bft.ViewChange(2, "bft2", -1, ()))
    return [
        *entries,
        raft.RequestVote(4, "r0", 12, 3),
        raft.VoteResponse(4, "r1", True),
        raft.AppendEntries(4, "r0", 10, 3, entries, 9),
        raft.AppendResponse(4, "r2", False, 11),
        raft.InstallSnapshot(4, "r0", 40, 4, b"\x00snapshot\xff"),
        raft.ClientRequest(7, "r1", put, submit_perf_ns=123456789),
        raft.ClientResponse(7, {"committed": True, "conflicts": {}},
                            resolved_perf_ns=987654321),
        raft.ClientResponse(8, None, "not leader", leader_hint="r0"),
        request, pp, *prepares,
        bft.CommitMsg(1, 9, pp.digest, "bft3"),
        bft.Reply(5, "bft0", {"committed": False,
                              "conflicts": {refs[0]: None}}),
        bft.Reply(6, "bft1", error="boom"),
        cert, *vcs,
        bft.NewView(2, vcs, (request,)),
        bft.StateRequest("bft3", 8),
        bft.StateResponse("bft0", b"\x01snap", 8, (1, 2, 5))]


def test_every_wire_type_crosses_between_the_packages():
    """Every raft.* and bft.* message serialised by one package
    deserialises in the other to equal fields, with identical bytes both
    ways."""
    ser = {pkg: mod(pkg, "core.serialization") for pkg in PKGS}
    samples = {pkg: wire_samples(pkg) for pkg in PKGS}
    names = set()
    for ref_msg, port_msg in zip(samples["corda_tpu"],
                                 samples["corda_tpu_torch"]):
        data = ser["corda_tpu"].serialize(ref_msg)
        assert ser["corda_tpu_torch"].serialize(port_msg) == data
        for src, dst, want in (("corda_tpu", "corda_tpu_torch", port_msg),
                               ("corda_tpu_torch", "corda_tpu", ref_msg)):
            got = ser[dst].deserialize(data)
            assert type(got).__name__ == type(want).__name__
            assert type(got).__module__.startswith(dst + ".")
            assert got == want
            assert ser[dst].serialize(got) == data
        names.add(type(port_msg).__name__)
    raft = mod("corda_tpu_torch", "consensus.raft")
    bft = mod("corda_tpu_torch", "consensus.bft")
    wire = {n for n, v in {**vars(raft), **vars(bft)}.items()
            if isinstance(v, type) and not n.startswith("_")
            and hasattr(v, "__dataclass_fields__")
            and v.__module__ in (raft.__name__, bft.__name__)}
    assert names == wire


def _fill_map(pkg: str):
    uniq = mod(pkg, "consensus.raft_uniqueness")
    structures = mod(pkg, "core.contracts.structures")
    sh = mod(pkg, "core.crypto.secure_hash").SecureHash
    sm = uniq.DistributedImmutableMap()
    refs = [structures.StateRef(sh.sha256(b"r%d" % i), i % 3)
            for i in range(8)]
    verdicts = [
        sm.apply(("put_all", [sh.sha256(b"t0"), refs[:3], "a"])),
        sm.apply(("put_all_batch", [[sh.sha256(b"t1"), refs[3:5], "b"],
                                    [sh.sha256(b"t2"), refs[4:6], "c"]])),
        sm.apply(("reserve_all", [sh.sha256(b"t3"), refs[6:8], "d"])),
        sm.apply(("put_all", [sh.sha256(b"t4"), refs[0:1] + refs[7:8],
                              "e"])),
        sm.apply(("finalize_all", [sh.sha256(b"t3"), refs[6:7], "d"])),
    ]
    return sm, verdicts


def test_a_state_machine_snapshot_restores_in_the_other_package():
    """A DistributedImmutableMap snapshot made by either package restores
    in the other to the same map and reservations; the same commands give
    the same verdicts."""
    ser = {pkg: mod(pkg, "core.serialization").serialize for pkg in PKGS}
    made = {pkg: _fill_map(pkg) for pkg in PKGS}
    assert ser["corda_tpu"](made["corda_tpu"][1]) == \
        ser["corda_tpu_torch"](made["corda_tpu_torch"][1])
    blobs = {pkg: made[pkg][0].snapshot() for pkg in PKGS}
    assert blobs["corda_tpu"] == blobs["corda_tpu_torch"]
    for src, dst in (("corda_tpu", "corda_tpu_torch"),
                     ("corda_tpu_torch", "corda_tpu")):
        sm = mod(dst, "consensus.raft_uniqueness").DistributedImmutableMap()
        sm.restore(blobs[src])
        assert sm._map == made[dst][0]._map
        assert sm._reserved == made[dst][0]._reserved
        assert sm._reserved and len(sm) == 6
        assert sm.snapshot() == blobs[src]


def _write_store(pkg: str, path: str) -> None:
    raft = mod(pkg, "consensus.raft")
    store = mod(pkg, "consensus.raft_store").RaftLogStore(path)
    store.save_meta(6, "r2")
    for i in range(1, 9):
        store.append(i, raft.LogEntry(1 + i // 3, ("put_all", [f"tx{i}"]),
                                      "r1", i))
    store.truncate_from(7)
    store.append(7, raft.LogEntry(6, raft.NOOP))
    store.save_snapshot(3, 2, b"snapshot-at-3")
    store.close()


def test_a_raft_log_store_opens_in_the_other_package(tmp_path):
    """A RaftLogStore written by either package opens in the other with
    the same term, vote, snapshot and log."""
    ser = {pkg: mod(pkg, "core.serialization").serialize for pkg in PKGS}
    states = {}
    for src in PKGS:
        path = str(tmp_path / f"{src}.kv")
        _write_store(src, path)
        for dst in PKGS:
            store = mod(dst, "consensus.raft_store").RaftLogStore(path)
            term, vote, snap_i, snap_t, blob, entries = store.load_state()
            store.close()
            states[(src, dst)] = ser[dst](
                [term, vote, snap_i, snap_t, blob, list(entries)])
            assert (term, vote, snap_i, snap_t, blob) == \
                (6, "r2", 3, 2, b"snapshot-at-3")
            assert [e.term for e in entries] == [2, 2, 3, 6]
    assert len(set(states.values())) == 1


def test_shard_of_agrees_on_seeded_refs():
    """shard_of, which decides the commit log that owns a ref, gives the
    reference's shard for 10,000 seeded refs at 1 to 8 shards."""
    import random
    rng = random.Random(20261018)
    raw = [(rng.randbytes(32), rng.randrange(64)) for _ in range(10_000)]
    shards = {}
    for pkg in PKGS:
        structures = mod(pkg, "core.contracts.structures")
        sh = mod(pkg, "core.crypto.secure_hash").SecureHash
        shard_of = mod(pkg, "consensus.sharded_uniqueness").shard_of
        refs = [structures.StateRef(sh(b), i) for b, i in raw]
        shards[pkg] = [[shard_of(r, n) for r in refs] for n in range(1, 9)]
    assert shards["corda_tpu_torch"] == shards["corda_tpu"]
    assert set(shards["corda_tpu"][7]) == set(range(8))
