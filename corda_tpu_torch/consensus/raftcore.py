"""Native-core Raft replica: C++ protocol engine, Python transport + apply.

Reference parity: SURVEY.md §2's native plan for Copycat's role — "C++ Raft
for the notary commit log". The protocol decisions (elections, replication,
the commit rule, in-order apply) run in `native/raftcore.cpp` behind a C
ABI; this wrapper translates the framework's wire messages
(consensus.raft dataclasses over TOPIC_RAFT) into core calls and drains the
core's action queue back onto the messaging plane. Log entries cross the
boundary as canonical-codec blobs of the (entry, client, request_id)
triple, which makes a native replica WIRE-COMPATIBLE with the pure-Python
RaftNode — mixed clusters replicate and commit together (tested).

The library is built by g++ from the repository's `native/raftcore.cpp`
into the port's build directory at its first use (`_build.load("raftcore")`).
Falls back to nothing: NATIVE_RAFT_AVAILABLE says whether it can be had (a
compiler is there or the library is built), and a failed build raises
`_build.BuildError` (same stance as storage.kvstore).
"""
from __future__ import annotations

import ctypes
import functools
import logging
import struct
import threading
from concurrent.futures import Future

from .. import _build
from ..core.serialization import deserialize, serialize
from ..network.messaging import TopicSession
from .raft import (AppendEntries, AppendResponse, CANDIDATE, ClientRequest,
                   ClientResponse, FOLLOWER, LEADER, LogEntry, NOOP,
                   RaftApplyError, RequestVote, TOPIC_RAFT, VoteResponse)

log = logging.getLogger(__name__)

_ROLES = {0: FOLLOWER, 1: CANDIDATE, 2: LEADER}

# action kinds (native/raftcore.cpp ActionKind)
_ACT_SEND_REQUEST_VOTE = 1
_ACT_SEND_VOTE_RESPONSE = 2
_ACT_SEND_APPEND = 3
_ACT_SEND_APPEND_RESPONSE = 4
_ACT_APPLY = 5
_ACT_BECAME_LEADER = 6


class _ActionView(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("peer", ctypes.c_int32),
                ("flag", ctypes.c_int32), ("a", ctypes.c_int64),
                ("b", ctypes.c_int64), ("c", ctypes.c_int64),
                ("d", ctypes.c_int64), ("data", ctypes.c_void_p),
                ("data_len", ctypes.c_uint32)]


def _bind(lib) -> None:
    lib.raft_create.restype = ctypes.c_void_p
    lib.raft_create.argtypes = [ctypes.c_int32] * 5 + [ctypes.c_uint64]
    lib.raft_destroy.argtypes = [ctypes.c_void_p]
    lib.raft_tick.argtypes = [ctypes.c_void_p]
    lib.raft_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32]
    lib.raft_request_vote.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64]
    lib.raft_vote_response.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.raft_append_entries.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int64]
    lib.raft_append_response.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64]
    for fn, res in (("raft_role", ctypes.c_int32),
                    ("raft_leader", ctypes.c_int32),
                    ("raft_term", ctypes.c_int64),
                    ("raft_commit_index", ctypes.c_int64),
                    ("raft_last_index", ctypes.c_int64)):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.raft_next_action.restype = ctypes.c_int32
    lib.raft_next_action.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(_ActionView)]


@functools.lru_cache(maxsize=1)
def _native_lib():
    """The bound raftcore library, built at first use. Raises
    :class:`_build.BuildError` when it cannot be built."""
    lib = _build.load("raftcore")
    _bind(lib)
    return lib


#: The native core can be had: its library is built, or a C++ compiler is
#: there to build it at the first replica's construction. Nothing is built
#: at import.
NATIVE_RAFT_AVAILABLE = _build.can_build("raftcore")


def _pack_entries(entries) -> bytes:
    """LogEntry tuple → the core's packed buffer ([u32 n][i64 term][u32 len]
    [blob]…, little-endian). A Python leader's NOOP becomes the core's empty
    blob so both cores skip it at apply."""
    parts = [struct.pack("<I", len(entries))]
    for e in entries:
        blob = b"" if e.entry == NOOP else serialize(
            [e.entry, e.client, e.request_id])
        parts.append(struct.pack("<qI", e.term, len(blob)))
        parts.append(blob)
    return b"".join(parts)


def _unpack_entries(buf: bytes) -> tuple:
    (count,) = struct.unpack_from("<I", buf, 0)
    off, out = 4, []
    for _ in range(count):
        term, blen = struct.unpack_from("<qI", buf, off)
        off += 12
        blob = buf[off:off + blen]
        off += blen
        if not blob:
            out.append(LogEntry(term, NOOP))
        else:
            entry, client, request_id = deserialize(blob)
            out.append(LogEntry(term, entry, client, request_id))
    return tuple(out)


class NativeRaftNode:
    """Drop-in replacement for consensus.raft.RaftNode backed by the C++
    core. Same public surface: tick(), submit(), abandon(), role,
    leader_id."""

    def __init__(self, node_id: str, peers: list[str], messaging, apply_fn,
                 seed: int | None = None):
        self._lib = _native_lib()
        self.node_id = node_id
        self.names = list(peers)              # index order = cluster config
        self.index = self.names.index(node_id)
        self.messaging = messaging
        self.apply_fn = apply_fn
        # seed None → 0: the core derives a per-replica seed from its index
        # (distinct election timeouts, matching RaftNode's node_id seeding);
        # an explicit seed is offset so seed=0 doesn't alias the fallback
        self._handle = self._lib.raft_create(
            self.index, len(self.names), 10, 20, 3,
            0 if seed is None else seed + 1)
        if not self._handle:
            raise RuntimeError("raft_create failed (cluster too large?)")
        self._request_ids = iter(range(1, 1 << 62))
        self._pending: dict[int, Future] = {}
        self._lock = threading.RLock()
        self._elections_total = 0
        self._leader_since: float | None = None
        self._leader_tenure_last_s = 0.0
        self._registration = messaging.add_message_handler(
            TopicSession(TOPIC_RAFT), self._on_message)

    def stop(self) -> None:
        """Detach from the transport (restart/teardown path)."""
        self.messaging.remove_message_handler(self._registration)

    # -- properties mirroring RaftNode ---------------------------------------
    @property
    def role(self) -> str:
        return _ROLES[self._lib.raft_role(self._handle)]

    @property
    def leader_id(self) -> str | None:
        idx = self._lib.raft_leader(self._handle)
        return None if idx < 0 else self.names[idx]

    @property
    def commit_index(self) -> int:
        return self._lib.raft_commit_index(self._handle)

    # -- entry points --------------------------------------------------------
    def tick(self) -> None:
        with self._lock:
            self._lib.raft_tick(self._handle)
            self._drain()

    def submit(self, entry) -> Future:
        with self._lock:
            fut: Future = Future()
            rid = next(self._request_ids)
            fut.raft_request_id = rid
            self._pending[rid] = fut
            req = ClientRequest(rid, self.node_id, entry)
            if self.role == LEADER:
                self._submit_local(req)
            elif self.leader_id is not None:
                self._post(self.leader_id, req)
            else:
                self._pending.pop(rid)
                fut.set_exception(RuntimeError("no raft leader known"))
            return fut

    def abandon(self, fut: Future) -> None:
        with self._lock:
            self._pending.pop(getattr(fut, "raft_request_id", None), None)

    def _submit_local(self, req: ClientRequest) -> None:
        blob = serialize([req.entry, req.client, req.request_id])
        self._lib.raft_submit(self._handle, blob, len(blob))
        self._drain()

    # -- wire <-> core translation -------------------------------------------
    def _post(self, peer: str, msg) -> None:
        self.messaging.send(TopicSession(TOPIC_RAFT), serialize(msg), peer)

    def _on_message(self, msg) -> None:
        m = deserialize(msg.data)
        with self._lock:
            h = self._handle
            if isinstance(m, RequestVote):
                self._lib.raft_request_vote(h, m.term,
                                            self.names.index(m.candidate),
                                            m.last_log_index, m.last_log_term)
            elif isinstance(m, VoteResponse):
                self._lib.raft_vote_response(
                    h, m.term, self.names.index(m.voter),
                    1 if m.granted else 0)
            elif isinstance(m, AppendEntries):
                packed = _pack_entries(m.entries)
                self._lib.raft_append_entries(
                    h, m.term, self.names.index(m.leader), m.prev_log_index,
                    m.prev_log_term, packed, len(packed), m.leader_commit)
            elif isinstance(m, AppendResponse):
                self._lib.raft_append_response(
                    h, m.term, self.names.index(m.follower),
                    1 if m.success else 0, m.match_index)
            elif isinstance(m, ClientRequest):
                if self.role == LEADER:
                    self._submit_local(m)
                else:
                    self._post(m.client, ClientResponse(
                        m.request_id, error="not leader",
                        leader_hint=self.leader_id))
                return
            elif isinstance(m, ClientResponse):
                self._resolve(m)
                return
            else:
                return
            self._drain()

    def _drain(self) -> None:
        view = _ActionView()
        while self._lib.raft_next_action(self._handle, ctypes.byref(view)):
            kind = view.kind
            data = (ctypes.string_at(view.data, view.data_len)
                    if view.data_len else b"")
            if kind == _ACT_SEND_REQUEST_VOTE:
                self._post(self.names[view.peer], RequestVote(
                    view.a, self.node_id, view.b, view.c))
            elif kind == _ACT_SEND_VOTE_RESPONSE:
                self._post(self.names[view.peer], VoteResponse(
                    view.a, self.node_id, bool(view.flag)))
            elif kind == _ACT_SEND_APPEND:
                from ..utils.faults import DROP, fault_point
                peer_name = self.names[view.peer]
                if fault_point("raft.append",
                               detail=f"{self.node_id}->{peer_name}") == DROP:
                    continue   # injected loss: the core's tick re-sends
                self._post(peer_name, AppendEntries(
                    view.a, self.node_id, view.b, view.c,
                    _unpack_entries(data), view.d))
            elif kind == _ACT_SEND_APPEND_RESPONSE:
                self._post(self.names[view.peer], AppendResponse(
                    view.a, self.node_id, bool(view.flag), view.b))
            elif kind == _ACT_APPLY:
                self._apply(data)
            elif kind == _ACT_BECAME_LEADER:
                import time as _t
                self._elections_total += 1
                self._leader_since = _t.perf_counter()
                log.info("%s (native core) is leader for term %d",
                         self.node_id, view.a)

    def _apply(self, blob: bytes) -> None:
        entry, client, request_id = deserialize(blob)
        try:
            result, error = self.apply_fn(entry), None
        except Exception as e:
            result, error = None, str(e)
        if client is None or request_id is None:
            return
        resp = ClientResponse(request_id, result, error)
        if client == self.node_id:
            self._resolve(resp)
        elif self.role == LEADER:
            self._post(client, resp)

    def _resolve(self, m: ClientResponse) -> None:
        fut = self._pending.pop(m.request_id, None)
        if fut is None:
            return
        if m.error is not None:
            fut.set_exception(RaftApplyError(m.error))
        else:
            fut.set_result(m.result)

    def stats(self) -> dict:
        """Observatory parity with RaftNode.stats(): everything the C core's
        getters expose. Fields the core cannot attribute (per-entry commit
        decomposition, election episode timings, per-peer lag, and the
        ISSUE 20 compaction family — snapshot_index / snapshots_taken /
        installs_sent / installs_received / snapshot_bytes; the native core
        keeps the whole log, so its ``log_entries`` IS the last absolute
        index) are ABSENT — never zero — so a mixed python/native fleet
        renders one coherent observatory with honest gaps."""
        import time as _t
        with self._lock:
            role = self.role
            if role != LEADER and self._leader_since is not None:
                # deposed since the last drain: bank the tenure lazily (the
                # core surfaces no step-down action)
                self._leader_tenure_last_s = \
                    _t.perf_counter() - self._leader_since
                self._leader_since = None
            return {
                "impl": "native",
                "node": self.node_id,
                "role": role,
                "term": self._lib.raft_term(self._handle),
                "leader_id": self.leader_id,
                "commit_index": self._lib.raft_commit_index(self._handle),
                "log_entries": self._lib.raft_last_index(self._handle),
                "elections_total": self._elections_total,
                "leader_tenure_s": (_t.perf_counter() - self._leader_since
                                    if self._leader_since is not None
                                    else 0.0),
                "leader_tenure_last_s": self._leader_tenure_last_s,
                "pending_requests": len(self._pending),
            }

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.raft_destroy(handle)
            self._handle = None
