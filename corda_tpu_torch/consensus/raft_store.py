"""Durable Raft persistent state over the kvlog storage engine.

Reference parity: the storage half of Copycat's Raft (the reference's
RaftUniquenessProvider configures Copycat with durable storage so a notary
cluster survives restarts). Raft's PERSISTENT state is exactly: currentTerm,
votedFor, and the log (§5.1) — commit index and the applied state machine
are volatile and re-derived (leader communicates commit; the
DistributedImmutableMap replays on commit advance). With compaction
(ISSUE 20) the store additionally holds ONE snapshot record — the
serialized state machine at ``snapshot_index`` — and the log shrinks to
the suffix above it; a restarting replica restores the snapshot and
replays only that suffix instead of the whole history from genesis.

Keys: b"meta" → serialized [term, voted_for]; b"e%016d" → serialized
LogEntry at that 1-based index; b"snap" → serialized [index, term, blob].
Truncation on conflict writes tombstones.

Crash safety of ``save_snapshot``: the snapshot record is written BEFORE
the covered log prefix is deleted, and ``load_state`` filters out entries
the snapshot covers — a crash (or an injected ``raft.snapshot.persist``
fault) between the two steps leaves a store that is merely redundant,
never unloadable.
"""
from __future__ import annotations

from ..core.serialization import deserialize, serialize
from ..storage.kvstore import KvStore
from .raft import LogEntry


class RaftLogStore:
    def __init__(self, path: str):
        self._kv = KvStore(path)

    @staticmethod
    def _ekey(index: int) -> bytes:
        return b"e%016d" % index

    def save_meta(self, term: int, voted_for: str | None) -> None:
        self._kv[b"meta"] = serialize([term, voted_for])

    def append(self, index: int, entry: LogEntry) -> None:
        self._kv[self._ekey(index)] = serialize(entry)

    def truncate_from(self, index: int) -> None:
        """Drop every entry at/after ``index`` (conflict overwrite)."""
        for key in sorted(self._kv.keys()):
            if key.startswith(b"e") and key >= self._ekey(index):
                del self._kv[key]

    def save_snapshot(self, index: int, term: int, blob: bytes) -> None:
        """Persist the state-machine snapshot at ``index`` and drop the
        log prefix it covers. Ordering is the crash-safety argument:
        snapshot first, prefix delete second — the ``raft.snapshot.persist``
        fault point sits between them so chaos tests can freeze exactly
        the torn state a crash would leave (snapshot + full log), which
        ``load_state`` must and does tolerate."""
        from ..utils.faults import DROP, fault_point
        self._kv[b"snap"] = serialize([index, term, blob])
        if fault_point("raft.snapshot.persist") == DROP:
            return   # injected torn persist: prefix retained, still loadable
        for key in sorted(self._kv.keys()):
            if key.startswith(b"e") and key <= self._ekey(index):
                del self._kv[key]

    def load(self) -> tuple[int, str | None, list[LogEntry]]:
        """Pre-snapshot load shape (kept for callers that predate
        compaction): term, vote, and EVERY stored entry."""
        meta = self._kv.get(b"meta")
        term, voted_for = deserialize(meta) if meta is not None else (0, None)
        entries = [
            deserialize(self._kv[key])
            for key in sorted(k for k in self._kv.keys() if k.startswith(b"e"))
        ]
        return term, voted_for, entries

    def load_state(self) -> tuple[int, str | None, int, int,
                                  bytes | None, list[LogEntry]]:
        """Full recovery shape: ``(term, vote, snapshot_index,
        snapshot_term, snapshot_blob, suffix_entries)``. Entries at or
        below the snapshot index are filtered out here (not trusted to be
        absent — a crash between the snapshot write and the prefix delete
        legitimately leaves them behind)."""
        meta = self._kv.get(b"meta")
        term, voted_for = deserialize(meta) if meta is not None else (0, None)
        snap = self._kv.get(b"snap")
        snap_index, snap_term, blob = \
            deserialize(snap) if snap is not None else (0, 0, None)
        entries = [
            deserialize(self._kv[key])
            for key in sorted(k for k in self._kv.keys() if k.startswith(b"e"))
            if key > self._ekey(snap_index)
        ]
        return term, voted_for, snap_index, snap_term, blob, entries

    def close(self) -> None:
        self._kv.close()
