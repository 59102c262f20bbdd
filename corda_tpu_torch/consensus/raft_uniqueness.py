"""Raft-replicated notary commit log.

Reference parity: RaftUniquenessProvider (node/services/transactions/
RaftUniquenessProvider.kt:41,101-155) submitting `PutAll` commands to a
replicated `DistributedImmutableMap` (DistributedImmutableMap.kt:1-120):
put-if-absent of all input-state refs, reporting ALL conflicting entries,
applied identically on every replica.
"""
from __future__ import annotations

from ..node.notary import ConsumedStateDetails, UniquenessProvider
from .raft import RaftNode


class DistributedImmutableMap:
    """The replicated state machine: put-if-absent batches keyed by StateRef
    (apply must be deterministic — identical on every replica)."""

    def __init__(self):
        self._map: dict = {}
        #: provisional cross-shard reservations (sharded_uniqueness 2PC
        #: phase 1): ref -> ConsumedStateDetails of the COORDINATING tx.
        #: A reservation blocks every other spender until the coordinator
        #: finalizes or releases it — but unlike a consumed entry it is
        #: REVOCABLE, so verdicts it causes are flagged ``provisional``
        #: (the blocked spender defers and retries; it is not dead).
        self._reserved: dict = {}

    def _conflicts(self, refs, tx_id) -> tuple:
        """find_conflicts over consumed entries PLUS other-tx reservations
        (a reserved ref reports the reserving tx so the loser can retry
        after the reservation resolves). Returns ``(conflicts,
        provisional)`` — provisional is True when every conflict comes
        from a revocable reservation and none from the immutable applied
        map, i.e. the verdict may change once the holder resolves."""
        from ..node.notary import find_conflicts
        conflicts = find_conflicts(self._map, refs, tx_id)
        terminal = bool(conflicts)
        for ref in refs:
            held = self._reserved.get(ref)
            if held is not None and held.consuming_tx != tx_id \
                    and ref not in conflicts:
                conflicts[ref] = held
        return conflicts, bool(conflicts) and not terminal

    @staticmethod
    def _rejection(conflicts: dict, provisional: bool) -> dict:
        out = {"committed": False, "conflicts": conflicts}
        if provisional:
            out["provisional"] = True
        return out

    def apply(self, command) -> dict:
        from ..node.notary import ConsumedStateDetails, record_all
        kind, payload = command
        if kind == "put_all":
            tx_id, refs, caller = payload
            conflicts, provisional = self._conflicts(refs, tx_id)
            if conflicts:
                return self._rejection(conflicts, provisional)
            record_all(self._map, refs, tx_id, caller)
            for ref in refs:           # fast path supersedes own reservation
                self._reserved.pop(ref, None)
            return {"committed": True, "conflicts": {}}
        if kind == "put_all_batch":
            # Group commit (commit_pipeline.GroupCommitter): one log entry
            # carries many transactions, applied IN LIST ORDER with a
            # per-tx verdict — a conflicting tx is rejected individually
            # without poisoning the rest of its batch, and the first
            # spender of a ref within the batch wins deterministically on
            # every replica (apply order == list order == log order).
            results = []
            for tx_id, refs, caller in payload:
                conflicts, provisional = self._conflicts(refs, tx_id)
                if conflicts:
                    results.append(self._rejection(conflicts, provisional))
                else:
                    record_all(self._map, refs, tx_id, caller)
                    for ref in refs:
                        self._reserved.pop(ref, None)
                    results.append({"committed": True, "conflicts": {}})
            return {"batch": True, "results": results}
        if kind == "reserve_all":
            # 2PC phase 1: provisional first-spender-wins claim. Same
            # verdict machinery as put_all (idempotent for the same tx on
            # replay), but the claim is revocable via release_all.
            tx_id, refs, caller = payload
            conflicts, provisional = self._conflicts(refs, tx_id)
            if conflicts:
                return self._rejection(conflicts, provisional)
            for i, ref in enumerate(refs):
                if ref not in self._map:   # already-consumed-by-self stays
                    self._reserved[ref] = ConsumedStateDetails(
                        consuming_tx=tx_id, consuming_index=i,
                        requesting_party=caller)
            return {"committed": True, "conflicts": {}}
        if kind == "finalize_all":
            # 2PC phase 2 (commit): promote the reservation to a consumed
            # entry. Idempotent on replay; records directly even if the
            # reservation was lost (the durable decision record is the
            # commit point, not the reservation); never overwrites another
            # tx's consumption — that would be a protocol violation, so it
            # is reported as a conflict verdict instead.
            tx_id, refs, caller = payload
            conflicts = {ref: held for ref in refs
                         if (held := self._map.get(ref)) is not None
                         and held.consuming_tx != tx_id}
            if conflicts:
                return {"committed": False, "conflicts": conflicts}
            record_all(self._map, refs, tx_id, caller)
            for ref in refs:
                self._reserved.pop(ref, None)
            return {"committed": True, "conflicts": {}}
        if kind == "release_all":
            # 2PC phase 2 (abort): drop this tx's reservations so honest
            # retries succeed. Idempotent; never touches another holder.
            tx_id, refs = payload[0], payload[1]
            released = 0
            for ref in refs:
                held = self._reserved.get(ref)
                if held is not None and held.consuming_tx == tx_id:
                    del self._reserved[ref]
                    released += 1
            return {"committed": True, "conflicts": {}, "released": released}
        raise ValueError(f"unknown command {kind!r}")

    def __len__(self):
        return len(self._map)

    # -- state transfer (BFT catch-up / future raft snapshots) ---------------
    def snapshot(self) -> bytes:
        from ..core.serialization import serialize
        return serialize([self._map, self._reserved])

    def restore(self, blob: bytes) -> None:
        from ..core.serialization import deserialize
        obj = deserialize(blob)
        if isinstance(obj, dict):          # pre-shard snapshot: consumed only
            self._map, self._reserved = dict(obj), {}
        else:
            consumed, reserved = obj
            self._map, self._reserved = dict(consumed), dict(reserved)


class RaftUniquenessProvider(UniquenessProvider):
    """UniquenessProvider backed by a RaftNode; `commit` blocks on consensus
    (CopycatClient.submit(PutAll).get() semantics)."""

    def __init__(self, raft_node: RaftNode, timeout_s: float = 30.0):
        self.raft = raft_node
        self.timeout_s = timeout_s
        self._committer = None   # lazy GroupCommitter (commit_async path)
        #: GroupCommitter keyword overrides (the sharded provider tunes
        #: max_batch / inflight and sets a per-shard ``label`` here).
        self.committer_opts: dict = {}

    @staticmethod
    def build(node_id: str, peers: list[str], messaging,
              state_machine: DistributedImmutableMap | None = None,
              seed: int | None = None, native: bool | None = None,
              storage_path: str | None = None,
              snapshot_entries: int | None = None
              ) -> "RaftUniquenessProvider":
        """``native``: None auto-selects the C++ protocol core when it can be
        had — built, or a compiler is there to build it, and then a failed
        build raises ``_build.BuildError`` (the kvstore engine-selection
        stance); True requires it; False forces
        the pure-Python replica. Both are wire-compatible.

        ``storage_path``: persist the replica's Raft state (term/vote/log,
        and the compaction snapshot) there so the cluster survives
        restarts — durable persistence is the Python replica's feature, so
        it forces native off.

        ``snapshot_entries``: arm log compaction (ISSUE 20) — the replica
        snapshots the DistributedImmutableMap every N applied entries and
        truncates the log prefix; a lagging follower catches up via
        InstallSnapshot. Compaction is a Python-replica feature, so like
        storage it forces native off. The snapshot/restore seam is wired
        regardless (it also serves InstallSnapshot receipt and
        crash-restart restore even on replicas that never self-compact)."""
        sm = state_machine if state_machine is not None else DistributedImmutableMap()
        if storage_path is not None or snapshot_entries is not None:
            if native:
                raise RuntimeError(
                    "durable raft storage and log compaction require the "
                    "Python replica")
            storage = None
            if storage_path is not None:
                from .raft_store import RaftLogStore
                storage = RaftLogStore(storage_path)
            raft = RaftNode(node_id, peers, messaging, sm.apply, seed=seed,
                            storage=storage, snapshot_fn=sm.snapshot,
                            restore_fn=sm.restore,
                            snapshot_entries=snapshot_entries)
        elif native or native is None:
            from .raftcore import NATIVE_RAFT_AVAILABLE, NativeRaftNode
            if NATIVE_RAFT_AVAILABLE:
                raft = NativeRaftNode(node_id, peers, messaging, sm.apply,
                                      seed=seed)
            elif native:
                raise RuntimeError(
                    "native raft requested but libraftcore cannot be built "
                    "(no C++ compiler found)")
            else:
                raft = RaftNode(node_id, peers, messaging, sm.apply,
                                seed=seed, snapshot_fn=sm.snapshot,
                                restore_fn=sm.restore)
        else:
            raft = RaftNode(node_id, peers, messaging, sm.apply, seed=seed,
                            snapshot_fn=sm.snapshot, restore_fn=sm.restore)
        provider = RaftUniquenessProvider(raft)
        provider.state_machine = sm
        return provider

    #: NotaryService.commit passes its notary.uniqueness span context (and
    #: the node's metric registry) through when the provider advertises it —
    #: same capability-flag pattern as the verifier service.
    supports_trace_ctx = True

    def commit(self, states, tx_id, caller: str, trace_ctx=None,
               metrics=None) -> None:
        from .provider import consensus_commit
        consensus_commit(self.raft, states, tx_id, caller, self.timeout_s,
                         trace_ctx=trace_ctx, metrics=metrics)

    def commit_async(self, states, tx_id, caller: str, trace_ctx=None,
                     metrics=None):
        """Group-commit path: enqueue on the shared GroupCommitter and
        return a Future that resolves None on commit or fails with
        UniquenessException on conflict. Requests from many concurrently
        suspended flows coalesce into one ``put_all_batch`` raft append
        per flush — one consensus round amortized over the whole batch
        (commit_pipeline.GroupCommitter)."""
        committer = self._committer
        if committer is None:
            from .commit_pipeline import GroupCommitter
            sm = getattr(self, "state_machine", None)
            # The applied map is immutable-growing, so a hit there is a
            # terminal reject. A ref provisionally held by a cross-shard
            # tx is NOT: the reservation is revocable, so it feeds the
            # committer's defer machinery (reserved_view) instead — the
            # blocked spender re-screens when the holder resolves rather
            # than receiving a false permanent double-spend verdict.
            view = (lambda: sm._map) if sm is not None else None
            rview = (lambda: sm._reserved) if sm is not None else None
            committer = GroupCommitter(
                self.raft, timeout_s=self.timeout_s, metrics=metrics,
                applied_view=view, reserved_view=rview,
                **self.committer_opts)
            self._committer = committer
        return committer.submit(states, tx_id, caller, trace_ctx=trace_ctx)

    @property
    def group_committer(self):
        return self._committer

    def close(self) -> None:
        """Stop the group committer's flush machinery (tests/harness)."""
        if self._committer is not None:
            self._committer.close()
            self._committer = None
