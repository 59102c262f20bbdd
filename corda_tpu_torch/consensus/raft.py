"""Raft replicated log over the messaging plane.

Reference parity: the role Copycat plays for the notary commit log
(RaftUniquenessProvider.kt:41,101-155 + DistributedImmutableMap.kt) —
re-implemented natively on this framework's transport: leader election, log
replication, commitment, and a client-submission path with leader
forwarding. Works over the deterministic in-memory bus (tests drive `tick()`
manually — no wall-clock in the protocol core) and the TCP plane (a timer
thread calls `tick()`).

Simplifications vs full Raft (documented, safe for the notary use case):
membership changes are not implemented. Snapshot-based log compaction IS
implemented (ISSUE 20): when constructed with a ``snapshot_fn/restore_fn``
seam and an entry-count threshold, a replica periodically serializes the
applied state machine at ``last_applied``, persists it as a snapshot
record, and truncates the log prefix — the log then starts at
``snapshot_index + 1`` and every consistency check anchors prev_index /
prev_term at the snapshot. A leader that needs compacted-away entries to
catch a lagging follower ships a single-frame InstallSnapshot (our frames
are in-process/TCP — no chunking needed); a restarting replica loads
snapshot + log suffix instead of replaying from genesis. Without the seam
(bare protocol tests) logs stay unbounded, exactly as before.
"""
from __future__ import annotations

import logging
import random
import threading
import time as _time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable

from ..core.serialization import deserialize, register_type, serialize
from ..network.messaging import TopicSession

log = logging.getLogger(__name__)

TOPIC_RAFT = "platform.raft"
NOOP = "__raft_noop__"

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

ELECTION_TICKS_MIN = 10
ELECTION_TICKS_MAX = 20
HEARTBEAT_TICKS = 3


@dataclass(frozen=True)
class LogEntry:
    term: int
    entry: Any
    client: str | None = None       # who to answer after commit
    request_id: int | None = None


@dataclass(frozen=True)
class RequestVote:
    term: int
    candidate: str
    last_log_index: int
    last_log_term: int


@dataclass(frozen=True)
class VoteResponse:
    term: int
    voter: str
    granted: bool


@dataclass(frozen=True)
class AppendEntries:
    term: int
    leader: str
    prev_log_index: int
    prev_log_term: int
    entries: tuple           # LogEntry...
    leader_commit: int


@dataclass(frozen=True)
class AppendResponse:
    term: int
    follower: str
    success: bool
    match_index: int


@dataclass(frozen=True)
class InstallSnapshot:
    """Leader → lagging follower: the serialized state machine at
    ``last_index`` (Raft §7). Single frame — the transport is in-process
    or one TCP connection, so the reference's chunked offset/done protocol
    collapses to one message. The follower restores the state machine,
    discards its log, and acks with a normal AppendResponse at
    ``last_index`` so the leader's match/next bookkeeping needs no new
    message type."""
    term: int
    leader: str
    last_index: int
    last_term: int
    data: bytes


@dataclass(frozen=True)
class ClientRequest:
    request_id: int
    client: str
    entry: Any
    #: the client's perf_counter at submit(), integer nanoseconds (the
    #: codec bans floats in consensus data) — rides the forward hop so the
    #: leader's append_wait attribution starts at the CLIENT's submit, not
    #: at leader receipt (clocks are comparable: the framework runs every
    #: node in one process; a cross-machine port must drop this field)
    submit_perf_ns: int | None = None


@dataclass(frozen=True)
class ClientResponse:
    request_id: int
    result: Any = None
    error: str | None = None
    leader_hint: str | None = None
    #: the leader's perf_counter at apply-end, integer nanoseconds — the
    #: client resolves its round measurement against this stamp so the
    #: response delivery hop cancels out of submit→resolve, matching what
    #: attribution can see
    resolved_perf_ns: int | None = None


for _cls in (LogEntry, RequestVote, VoteResponse, AppendEntries,
             AppendResponse, InstallSnapshot, ClientRequest,
             ClientResponse):
    register_type(f"raft.{_cls.__name__}", _cls)


class RaftState:
    """Persistent + volatile Raft state for one replica."""

    def __init__(self):
        self.current_term = 0
        self.voted_for: str | None = None
        self.log: list[LogEntry] = []      # 1-based indexing via helpers
        self.commit_index = 0
        self.last_applied = 0
        # the log base after compaction: ``log[0]`` holds absolute index
        # ``snapshot_index + 1``; ``term_at(snapshot_index)`` answers
        # ``snapshot_term`` so AppendEntries consistency checks anchored
        # exactly at the snapshot still pass (Raft §7)
        self.snapshot_index = 0
        self.snapshot_term = 0

    def last_index(self) -> int:
        return self.snapshot_index + len(self.log)

    def term_at(self, index: int) -> int:
        if index == self.snapshot_index:
            return self.snapshot_term
        if index == 0:
            return 0
        return self.log[index - self.snapshot_index - 1].term

    def entry_at(self, index: int) -> LogEntry:
        return self.log[index - self.snapshot_index - 1]


class RaftNode:
    """One replica. `apply_fn(entry) -> result` is the state machine
    (DistributedImmutableMap's commands); called exactly once per committed
    entry, in log order, on every replica."""

    def __init__(self, node_id: str, peers: list[str], messaging,
                 apply_fn: Callable[[Any], Any], seed: int | None = None,
                 storage=None, snapshot_fn: Callable[[], bytes] | None = None,
                 restore_fn: Callable[[bytes], None] | None = None,
                 snapshot_entries: int | None = None):
        """``storage``: an optional consensus.raft_store.RaftLogStore making
        the replica's persistent state (term, vote, log, snapshot) survive
        restarts — Raft §5.1; the Copycat durable-storage role.

        ``snapshot_fn() -> bytes`` / ``restore_fn(blob)``: the state-machine
        snapshot seam (DistributedImmutableMap.snapshot/restore). When BOTH
        ``snapshot_fn`` and ``snapshot_entries`` are given, the replica
        compacts its log every time ``last_applied - snapshot_index``
        reaches the threshold; ``restore_fn`` additionally lets the replica
        accept InstallSnapshot and resume from a stored snapshot at
        restart. Leave them unset for the unbounded pre-compaction
        behavior."""
        self.node_id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.messaging = messaging
        self.apply_fn = apply_fn
        self.storage = storage
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.snapshot_entries = snapshot_entries
        self.state = RaftState()
        # compaction bookkeeping (under _lock): the latest snapshot blob is
        # retained in memory so InstallSnapshot needs no storage round-trip
        self._snapshot_blob: bytes | None = None
        self._snapshot_bytes = 0
        self._snapshots_taken = 0
        self._installs_sent = 0
        self._installs_received = 0
        if storage is not None:
            if hasattr(storage, "load_state"):
                (term, vote, snap_index, snap_term, blob,
                 entries) = storage.load_state()
            else:   # pre-snapshot store shim
                term, vote, entries = storage.load()
                snap_index, snap_term, blob = 0, 0, None
            self.state.current_term = term
            self.state.voted_for = vote
            self.state.log = entries
            if snap_index > 0 and blob is not None:
                # crash-restart recovery: resume from snapshot + suffix
                # instead of replaying from genesis. commit_index/last_applied
                # start at the snapshot; the leader's heartbeats re-advance
                # them over the suffix (commit index is volatile in Raft).
                self.state.snapshot_index = snap_index
                self.state.snapshot_term = snap_term
                self.state.commit_index = snap_index
                self.state.last_applied = snap_index
                self._snapshot_blob = blob
                self._snapshot_bytes = len(blob)
                if restore_fn is not None:
                    restore_fn(blob)
        self.role = FOLLOWER
        self.leader_id: str | None = None
        self._rng = random.Random(seed if seed is not None else node_id)
        self._election_deadline = self._new_election_timeout()
        self._ticks = 0
        self._votes: set[str] = set()
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._request_ids = iter(range(1, 1 << 62))
        self._pending: dict[int, Future] = {}       # our client requests
        # One coarse reentrant lock serializes every entry point: ticks from a
        # timer thread, messages from the transport thread, and submits from
        # flow threads all mutate the same state.
        self._lock = threading.RLock()
        # -- introspection state (consensus observatory; all under _lock) --
        # submit-time clock per locally-submitted request: (client, rid) ->
        # (perf_t0, epoch_t0); consumed when the leader appends the entry.
        self._submit_clock: dict = {}
        # per-appended-entry clock on the LEADER: (term, index) ->
        # [perf_t0, epoch_t0, perf_append, perf_fsync_end]; popped at apply.
        self._entry_clock: dict = {}
        # bounded exact samples per commit-path component (seconds). Exact
        # lists, not histograms: the bench validity probe compares the
        # attribution sum against the measured round within 10%, far inside
        # the log-bucket histogram's quantile resolution.
        self._attrib: dict = {
            k: deque(maxlen=self.ATTRIB_SAMPLE_CAP)
            for k in ("append_wait", "fsync", "replicate", "apply", "total")}
        self._elections: deque = deque(maxlen=64)   # episode dicts
        self._elections_total = 0
        self._election_started = None    # (perf_t0, epoch_t0, tick0, cause)
        self._leader_since = None        # (perf_t, epoch_t) while LEADER
        self._leader_tenure_last_s = 0.0
        self._leader_tenure_total_s = 0.0
        self._stopped = False
        self._registration = messaging.add_message_handler(
            TopicSession(TOPIC_RAFT), self._on_message)

    #: exact attribution samples retained per component (oldest evicted)
    ATTRIB_SAMPLE_CAP = 4096

    def stop(self) -> None:
        """Detach from the transport (restart/teardown path: a revived
        replica re-registers on the same endpoint). A delivery already in
        flight on another thread when this runs is dropped, not applied:
        the caller may close the replica's storage next."""
        with self._lock:
            self._stopped = True
        self.messaging.remove_message_handler(self._registration)

    # -- timers --------------------------------------------------------------
    def _new_election_timeout(self) -> int:
        return self._rng.randint(ELECTION_TICKS_MIN, ELECTION_TICKS_MAX)

    def tick(self) -> None:
        """Advance logical time one step (tests call this directly; production
        wraps it in a timer thread)."""
        with self._lock:
            self._tick_locked()

    def _tick_locked(self) -> None:
        self._ticks += 1
        if self.role == LEADER:
            if self._ticks % HEARTBEAT_TICKS == 0:
                self._broadcast_append()
            return
        self._election_deadline -= 1
        if self._election_deadline <= 0:
            self._start_election()

    # -- persistence hooks ---------------------------------------------------
    def _persist_meta(self) -> None:
        if self.storage is not None:
            self.storage.save_meta(self.state.current_term,
                                   self.state.voted_for)

    def _persist_append(self) -> None:
        """Persist the entry just appended in memory."""
        if self.storage is not None:
            idx = self.state.last_index()
            self.storage.append(idx, self.state.entry_at(idx))

    def _persist_suffix(self, from_index: int) -> None:
        """Persist a conflict overwrite: truncate + rewrite from_index on."""
        if self.storage is not None:
            self.storage.truncate_from(from_index)
            for idx in range(from_index, self.state.last_index() + 1):
                self.storage.append(idx, self.state.entry_at(idx))

    # -- elections -----------------------------------------------------------
    def _start_election(self) -> None:
        if self.role != CANDIDATE:
            # a new episode: first candidacy after losing sight of a leader.
            # Re-elections after split votes extend the SAME episode — the
            # observable outage is one window, however many terms it burns.
            cause = "startup" if self.state.current_term == 0 else "timeout"
            self._election_started = (_time.perf_counter(), _time.time(),
                                      self._ticks, cause)
        self.state.current_term += 1
        self.role = CANDIDATE
        self.state.voted_for = self.node_id
        self._persist_meta()
        self._votes = {self.node_id}
        self._election_deadline = self._new_election_timeout()
        log.debug("%s starts election for term %d", self.node_id,
                  self.state.current_term)
        msg = RequestVote(self.state.current_term, self.node_id,
                          self.state.last_index(),
                          self.state.term_at(self.state.last_index()))
        for peer in self.peers:
            self._post(peer, msg)
        self._maybe_win()

    def _maybe_win(self) -> None:
        if self.role == CANDIDATE and len(self._votes) > (len(self.peers) + 1) // 2:
            self.role = LEADER
            self.leader_id = self.node_id
            self._next_index = {p: self.state.last_index() + 1 for p in self.peers}
            self._match_index = {p: 0 for p in self.peers}
            log.info("%s is leader for term %d", self.node_id,
                     self.state.current_term)
            self._record_election_won()
            # a current-term no-op lets _maybe_commit advance over entries
            # replicated in previous terms (Raft 5.4.2 liveness)
            self.state.log.append(LogEntry(self.state.current_term, NOOP))
            self._persist_append()
            self._broadcast_append()
            self._maybe_commit()

    def _record_election_won(self) -> None:
        """Close the open election episode: this node won leadership."""
        now_perf, now_epoch = _time.perf_counter(), _time.time()
        started = self._election_started
        self._election_started = None
        self._leader_since = (now_perf, now_epoch)
        self._elections_total += 1
        if started is None:
            return
        perf_t0, epoch_t0, tick0, cause = started
        episode = {"term": self.state.current_term, "cause": cause,
                   "duration_s": now_perf - perf_t0,
                   "ticks": self._ticks - tick0, "started_at": epoch_t0}
        self._elections.append(episode)
        from ..observability import get_tracer, jlog
        jlog(log, "raft.election.won", node=self.node_id, **episode)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record("raft.election", start_s=epoch_t0,
                          duration_s=episode["duration_s"],
                          node=self.node_id, term=episode["term"],
                          cause=cause, ticks=episode["ticks"])

    def _end_leader_tenure(self) -> None:
        """Deposed (or stepped down): bank the tenure, drop stale per-entry
        clocks — entries we appended as leader may never commit and would
        otherwise pin their timing records forever."""
        if self._leader_since is not None:
            tenure = _time.perf_counter() - self._leader_since[0]
            self._leader_tenure_last_s = tenure
            self._leader_tenure_total_s += tenure
            self._leader_since = None
        self._entry_clock.clear()
        self._submit_clock.clear()

    # -- replication ---------------------------------------------------------
    def _broadcast_append(self) -> None:
        for peer in self.peers:
            self._send_append(peer)

    def _send_append(self, peer: str) -> None:
        from ..utils.faults import DROP, fault_point
        next_i = self._next_index.get(peer, self.state.last_index() + 1)
        if next_i <= self.state.snapshot_index:
            # the entries this follower needs were compacted away: ship the
            # snapshot instead (Raft §7) — the follower's AppendResponse at
            # snapshot last_index resumes normal replication from there
            self._send_snapshot(peer)
            return
        if fault_point("raft.append",
                       detail=f"{self.node_id}->{peer}") == DROP:
            return   # injected replication loss: the retry tick re-sends
        prev = next_i - 1
        entries = tuple(
            self.state.log[prev - self.state.snapshot_index:])
        self._post(peer, AppendEntries(
            self.state.current_term, self.node_id, prev,
            self.state.term_at(prev), entries, self.state.commit_index))

    def _send_snapshot(self, peer: str) -> None:
        from ..utils.faults import DROP, fault_point
        blob = self._snapshot_blob
        if blob is None:
            # defensive: a snapshot_index > 0 without a retained blob can
            # only mean a storage load gave us an index but no data; the
            # best we can do is resume appends from the base
            self._next_index[peer] = self.state.snapshot_index + 1
            return
        if fault_point("raft.snapshot.install",
                       detail=f"{self.node_id}->{peer}") == DROP:
            return   # injected install loss: the heartbeat tick re-sends
        self._installs_sent += 1
        from ..observability import jlog
        jlog(log, "raft.snapshot.install.sent", node=self.node_id,
             peer=peer, last_index=self.state.snapshot_index,
             bytes=len(blob))
        self._post(peer, InstallSnapshot(
            self.state.current_term, self.node_id,
            self.state.snapshot_index, self.state.snapshot_term, blob))

    # -- client submission ---------------------------------------------------
    #: consensus_commit threads the notary's span context through submit()
    #: when this flag is set (NativeRaftNode / BFTClient don't take it yet)
    supports_trace_ctx = True

    def submit(self, entry, trace_ctx=None) -> Future:
        """Replicate `entry`; the future resolves with apply_fn's result once
        committed. On a follower, forwards to the known leader. The caller
        owns the timeout: call `abandon(fut)` if it gives up waiting, so the
        pending-request table cannot leak. ``trace_ctx`` parents a
        "raft.submit" span covering submission → commit/apply (finished when
        the response resolves the future)."""
        from ..observability import get_tracer, jlog
        tracer = get_tracer()
        jlog(log, "raft.submit", ctx=trace_ctx, node=self.node_id,
             role=self.role)
        # the attribution clock starts BEFORE the lock: contending with the
        # pump thread's tick is append-queue wait the caller experiences,
        # so it must land in the append_wait component, not vanish
        perf_t0, epoch_t0 = _time.perf_counter(), _time.time()
        with self._lock:
            fut: Future = Future()
            rid = next(self._request_ids)
            fut.raft_request_id = rid
            if tracer.enabled:
                fut.raft_trace_span = tracer.span(
                    "raft.submit", parent=trace_ctx, node=self.node_id,
                    role=self.role, request_id=rid)
            self._pending[rid] = fut
            req = ClientRequest(rid, self.node_id, entry,
                                submit_perf_ns=int(perf_t0 * 1e9))
            if self.role == LEADER:
                # local leader submit: the per-entry component sum then
                # telescopes to the same submit→resolve interval the
                # caller measures
                self._submit_clock[(self.node_id, rid)] = (perf_t0, epoch_t0)
                self._handle_client_request(req)
            elif self.leader_id is not None:
                self._post(self.leader_id, req)
            else:
                self._pending.pop(rid)
                span = getattr(fut, "raft_trace_span", None)
                if span is not None:
                    span.set_tag("error", "no raft leader known")
                    span.finish()
                fut.set_exception(RuntimeError("no raft leader known"))
            return fut

    def abandon(self, fut: Future) -> None:
        """Drop a timed-out submission from the pending table."""
        with self._lock:
            self._pending.pop(getattr(fut, "raft_request_id", None), None)

    def _handle_client_request(self, req: ClientRequest) -> None:
        if self.role != LEADER:
            self._post(req.client, ClientResponse(
                req.request_id, error="not leader", leader_hint=self.leader_id))
            return
        perf_append = _time.perf_counter()
        clock = self._submit_clock.pop((req.client, req.request_id), None)
        if clock is None:
            # forwarded from a follower: the client's submit stamp rides the
            # request, so the forward hop lands in append_wait — exactly the
            # queue wait the caller experiences (the conservation probe broke
            # 45% when rounds forwarded to a post-election leader and these
            # hops vanished). An absent or insane stamp (hostile peer, clock
            # from the future) falls back to receipt.
            sp_ns = getattr(req, "submit_perf_ns", None)
            sp = sp_ns / 1e9 if type(sp_ns) is int else None
            if sp is not None and 0.0 < sp <= perf_append:
                clock = (sp, _time.time() - (perf_append - sp))
            else:
                clock = (perf_append, _time.time())
        self.state.log.append(LogEntry(self.state.current_term, req.entry,
                                       req.client, req.request_id))
        self._persist_append()
        self._entry_clock[(self.state.current_term,
                           self.state.last_index())] = \
            [clock[0], clock[1], perf_append, _time.perf_counter()]
        if len(self._entry_clock) > self.ATTRIB_SAMPLE_CAP:
            self._entry_clock.clear()   # straggler-record runaway guard
        self._broadcast_append()
        self._maybe_commit()   # single-node cluster commits immediately

    # -- message handling ----------------------------------------------------
    def _post(self, peer: str, msg) -> None:
        self.messaging.send(TopicSession(TOPIC_RAFT), serialize(msg), peer)

    def _observe_term(self, term: int) -> None:
        if term > self.state.current_term:
            if self.role == LEADER:
                self._end_leader_tenure()
            self.state.current_term = term
            self.state.voted_for = None
            self._persist_meta()
            self.role = FOLLOWER
            self.leader_id = None  # stale until the new leader heartbeats

    def _on_message(self, msg) -> None:
        m = deserialize(msg.data)
        with self._lock:
            if self._stopped:
                return
            self._on_message_locked(m)

    def _on_message_locked(self, m) -> None:
        if isinstance(m, RequestVote):
            self._on_request_vote(m)
        elif isinstance(m, VoteResponse):
            self._on_vote_response(m)
        elif isinstance(m, AppendEntries):
            self._on_append(m)
        elif isinstance(m, AppendResponse):
            self._on_append_response(m)
        elif isinstance(m, InstallSnapshot):
            self._on_install_snapshot(m)
        elif isinstance(m, ClientRequest):
            self._handle_client_request(m)
        elif isinstance(m, ClientResponse):
            self._on_client_response(m)

    def _on_request_vote(self, m: RequestVote) -> None:
        self._observe_term(m.term)
        up_to_date = (m.last_log_term, m.last_log_index) >= (
            self.state.term_at(self.state.last_index()),
            self.state.last_index())
        grant = (m.term == self.state.current_term and up_to_date
                 and self.state.voted_for in (None, m.candidate))
        if grant:
            self.state.voted_for = m.candidate
            self._persist_meta()
            self._election_deadline = self._new_election_timeout()
        self._post(m.candidate, VoteResponse(self.state.current_term,
                                             self.node_id, grant))

    def _on_vote_response(self, m: VoteResponse) -> None:
        self._observe_term(m.term)
        if self.role == CANDIDATE and m.term == self.state.current_term and m.granted:
            self._votes.add(m.voter)
            self._maybe_win()

    def _on_append(self, m: AppendEntries) -> None:
        self._observe_term(m.term)
        if m.term < self.state.current_term:
            self._post(m.leader, AppendResponse(self.state.current_term,
                                                self.node_id, False, 0))
            return
        self.role = FOLLOWER
        self.leader_id = m.leader
        self._election_started = None   # another node won this episode
        self._election_deadline = self._new_election_timeout()
        if m.prev_log_index < 0:
            # negative values never come from a correct leader and would
            # index the log from the end
            self._post(m.leader, AppendResponse(self.state.current_term,
                                                self.node_id, False, 0))
            return
        # compaction base: entries at or below our snapshot index are
        # committed and applied here by definition — drop the overlap and
        # re-anchor prev at the snapshot. A frame entirely below the base
        # (stale retransmit, or a leader probing backwards) is acked at its
        # own coverage so the leader's next_index walks forward again.
        prev, prev_term, entries = m.prev_log_index, m.prev_log_term, m.entries
        snap = self.state.snapshot_index
        if prev < snap:
            drop = min(len(entries), snap - prev)
            if drop:
                prev_term = entries[drop - 1].term
                entries = entries[drop:]
                prev += drop
            if prev < snap:
                self._post(m.leader, AppendResponse(
                    self.state.current_term, self.node_id, True,
                    m.prev_log_index + len(m.entries)))
                return
        # consistency check at prev (Raft §5.3). On failure the response
        # carries our last_index as a fast-backup hint: the leader jumps
        # next_index there instead of decrementing once per round trip —
        # without it a rejoining follower far behind a compacted leader
        # would never walk back to the snapshot boundary in useful time.
        if prev > self.state.last_index() \
                or self.state.term_at(prev) != prev_term:
            self._post(m.leader, AppendResponse(
                self.state.current_term, self.node_id, False,
                self.state.last_index()))
            return
        # Raft §5.3: truncate only from the first term-conflicting entry —
        # a stale/duplicated append whose entries match the existing suffix
        # must not discard later entries already replicated past it
        idx = prev + 1
        keep = 0
        for keep, entry in enumerate(entries):
            if idx + keep > self.state.last_index() or \
                    self.state.term_at(idx + keep) != entry.term:
                break
        else:
            keep = len(entries)
        if keep < len(entries):
            self.state.log = (self.state.log[:idx + keep - 1 - snap]
                              + list(entries[keep:]))
            self._persist_suffix(idx + keep)
        if m.leader_commit > self.state.commit_index:
            # Raft: clamp to the last entry THIS append covered, not the
            # whole local log — with conflict-only truncation an uncommitted
            # divergent suffix may extend past prev+len(entries), and a
            # stale/forged append must not commit it
            self.state.commit_index = min(
                m.leader_commit, m.prev_log_index + len(m.entries))
        self._apply_committed()
        # match index = last entry THIS append verified, not last_index():
        # with conflict-only truncation the local log can extend past the
        # verified entries, and last_index() would let a batching leader
        # commit entries the follower does not hold (ADVICE r2)
        self._post(m.leader, AppendResponse(
            self.state.current_term, self.node_id, True,
            m.prev_log_index + len(m.entries)))

    def _on_append_response(self, m: AppendResponse) -> None:
        self._observe_term(m.term)
        if self.role != LEADER or m.term != self.state.current_term:
            return
        if m.success:
            # clamp: a forged/corrupt response with a huge match_index would
            # drive next_index past the log end and _send_append's term_at
            # out of range — same hostile-input posture as the prev_log_index
            # check in _on_append
            match = min(max(m.match_index, 0), self.state.last_index())
            self._match_index[m.follower] = match
            self._next_index[m.follower] = match + 1
            self._maybe_commit()
        else:
            # fast backup: the rejection carries the follower's last_index
            # as a hint — jump straight below it (clamped so a forged huge
            # hint cannot push next_index forward past the decrement)
            nxt = self._next_index.get(m.follower, 1) - 1
            hint = m.match_index
            if isinstance(hint, int) and 0 <= hint < nxt:
                nxt = hint + 1
            self._next_index[m.follower] = max(1, nxt)
            self._send_append(m.follower)

    def _on_install_snapshot(self, m: InstallSnapshot) -> None:
        self._observe_term(m.term)
        if m.term < self.state.current_term:
            self._post(m.leader, AppendResponse(self.state.current_term,
                                                self.node_id, False, 0))
            return
        self.role = FOLLOWER
        self.leader_id = m.leader
        self._election_started = None
        self._election_deadline = self._new_election_timeout()
        if m.last_index <= self.state.commit_index:
            # already caught up past the snapshot (duplicate/stale install):
            # ack so the leader resumes appends from last_index + 1
            self._post(m.leader, AppendResponse(
                self.state.current_term, self.node_id, True, m.last_index))
            return
        if self.restore_fn is None:
            # a replica without the restore seam cannot accept a snapshot;
            # stay silent — the leader keeps re-offering on heartbeats
            log.warning("%s received InstallSnapshot but has no restore_fn",
                        self.node_id)
            return
        self.restore_fn(m.data)
        # discard the whole local log: everything ≤ last_index is covered
        # by the snapshot, and anything beyond it is uncommitted here
        # (commit_index < m.last_index) hence safe to drop (Raft §7)
        self.state.log = []
        self.state.snapshot_index = m.last_index
        self.state.snapshot_term = m.last_term
        self.state.commit_index = m.last_index
        self.state.last_applied = m.last_index
        self._snapshot_blob = m.data
        self._snapshot_bytes = len(m.data)
        self._installs_received += 1
        if self.storage is not None:
            self.storage.save_snapshot(m.last_index, m.last_term, m.data)
            self.storage.truncate_from(m.last_index + 1)
        from ..observability import get_tracer, jlog
        jlog(log, "raft.snapshot.installed", node=self.node_id,
             leader=m.leader, last_index=m.last_index, bytes=len(m.data))
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record("raft.snapshot.install", node=self.node_id,
                          last_index=m.last_index, bytes=len(m.data))
        self._post(m.leader, AppendResponse(
            self.state.current_term, self.node_id, True, m.last_index))

    def _maybe_commit(self) -> None:
        n_nodes = len(self.peers) + 1
        for idx in range(self.state.last_index(), self.state.commit_index, -1):
            if self.state.term_at(idx) != self.state.current_term:
                break  # only commit entries from the current term directly
            replicated = 1 + sum(1 for p in self.peers
                                 if self._match_index.get(p, 0) >= idx)
            if replicated > n_nodes // 2:
                self.state.commit_index = idx
                break
        self._apply_committed()

    def _apply_committed(self) -> None:
        while self.state.last_applied < self.state.commit_index:
            self.state.last_applied += 1
            entry = self.state.entry_at(self.state.last_applied)
            if entry.entry == NOOP:
                continue
            clock = self._entry_clock.pop(
                (entry.term, self.state.last_applied), None)
            perf_commit = _time.perf_counter() if clock is not None else 0.0
            try:
                result = self.apply_fn(entry.entry)
                error = None
            except Exception as e:
                result, error = None, str(e)
            perf_end = _time.perf_counter()
            if clock is not None:
                self._record_attribution(entry, clock, perf_commit, perf_end)
            if entry.client is not None and entry.request_id is not None:
                resp = ClientResponse(entry.request_id, result, error,
                                      resolved_perf_ns=int(perf_end * 1e9))
                if entry.client == self.node_id:
                    self._resolve(resp)
                elif self.role == LEADER:
                    self._post(entry.client, resp)
        self._maybe_snapshot()

    def _maybe_snapshot(self) -> None:
        """Compact when the applied span since the last snapshot reaches
        the configured entry-count threshold (injectable for tests)."""
        if self.snapshot_fn is None or not self.snapshot_entries:
            return
        if (self.state.last_applied - self.state.snapshot_index
                < self.snapshot_entries):
            return
        self._take_snapshot()

    def _take_snapshot(self) -> None:
        """Serialize the state machine at last_applied, persist the
        snapshot record, truncate the in-memory prefix. Persist failures
        (including injected ``raft.snapshot.persist`` faults) abort the
        round with nothing mutated in memory — the store stays loadable
        (snapshot record written before the prefix delete, and load
        filters entries the snapshot covers) and the next apply retries."""
        from ..observability import get_tracer, jlog
        snap_index = self.state.last_applied
        snap_term = self.state.term_at(snap_index)
        perf_t0, epoch_t0 = _time.perf_counter(), _time.time()
        blob = self.snapshot_fn()
        if self.storage is not None:
            try:
                self.storage.save_snapshot(snap_index, snap_term, blob)
            except Exception as e:
                jlog(log, "raft.snapshot.persist_failed",
                     level=logging.WARNING, node=self.node_id,
                     index=snap_index, error=str(e))
                return
        drop = snap_index - self.state.snapshot_index
        self.state.log = self.state.log[drop:]
        self.state.snapshot_index = snap_index
        self.state.snapshot_term = snap_term
        self._snapshot_blob = blob
        self._snapshot_bytes = len(blob)
        self._snapshots_taken += 1
        duration = _time.perf_counter() - perf_t0
        jlog(log, "raft.snapshot.taken", node=self.node_id,
             index=snap_index, term=snap_term, bytes=len(blob),
             dropped_entries=drop)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record("raft.snapshot.persist", start_s=epoch_t0,
                          duration_s=duration, node=self.node_id,
                          index=snap_index, bytes=len(blob))

    def _on_client_response(self, m: ClientResponse) -> None:
        self._resolve(m)

    # -- introspection (consensus observatory) --------------------------------
    def _record_attribution(self, entry: LogEntry, clock: list,
                            perf_commit: float, perf_end: float) -> None:
        """One committed entry's commit-path decomposition: append-queue
        wait, local fsync (_persist_append), replication (append → quorum
        commit), apply. The four parts are CONTIGUOUS, so their sum is
        exactly the submit→applied interval — the invariant the bench
        validity probe holds against the measured round time."""
        perf_t0, epoch_t0, perf_append, perf_fsync_end = clock
        fsync = perf_fsync_end - perf_append
        replicate = max(0.0, perf_commit - perf_fsync_end)
        apply_s = perf_end - perf_commit
        self._attrib["append_wait"].append(perf_append - perf_t0)
        self._attrib["fsync"].append(fsync)
        self._attrib["replicate"].append(replicate)
        self._attrib["apply"].append(apply_s)
        self._attrib["total"].append(perf_end - perf_t0)
        # retroactive child spans under the pending raft.submit span: the
        # critical-path extractor can now decompose raft.commit one level
        # deeper (raft.fsync / raft.replicate components)
        if entry.client != self.node_id or entry.request_id is None:
            return
        fut = self._pending.get(entry.request_id)
        span = getattr(fut, "raft_trace_span", None) if fut is not None \
            else None
        if span is None:
            return
        from ..observability import get_tracer
        tracer = get_tracer()
        if not tracer.enabled:
            return
        ctx = span.context()
        t = epoch_t0 + (perf_append - perf_t0)
        tracer.record("raft.fsync", parent=ctx, start_s=t,
                      duration_s=fsync, node=self.node_id)
        tracer.record("raft.replicate", parent=ctx, start_s=t + fsync,
                      duration_s=replicate, node=self.node_id)
        tracer.record("raft.apply", parent=ctx,
                      start_s=t + fsync + replicate,
                      duration_s=apply_s, node=self.node_id)

    def attribution_samples(self) -> dict:
        """Exact retained per-commit component samples (seconds), keyed
        append_wait / fsync / replicate / apply / total. Only the leader
        that appended an entry holds its samples — pool across replicas."""
        with self._lock:
            return {k: list(v) for k, v in self._attrib.items()}

    def stats(self) -> dict:
        """Introspection snapshot (the /debug/raft payload's per-node leaf).
        Everything is cheap reads under the node lock; attribution
        percentiles come from the exact retained samples."""
        with self._lock:
            now = _time.perf_counter()
            out = {
                "impl": "python",
                "node": self.node_id,
                "role": self.role,
                "term": self.state.current_term,
                "leader_id": self.leader_id,
                "commit_index": self.state.commit_index,
                "last_applied": self.state.last_applied,
                # retained (post-compaction) log length; equals the last
                # absolute index only while no snapshot has been taken
                "log_entries": len(self.state.log),
                "last_log_index": self.state.last_index(),
                "snapshot_index": self.state.snapshot_index,
                "snapshots_taken": self._snapshots_taken,
                "installs_sent": self._installs_sent,
                "installs_received": self._installs_received,
                "snapshot_bytes": self._snapshot_bytes,
                "elections_total": self._elections_total,
                "elections": list(self._elections),
                "leader_tenure_s": (now - self._leader_since[0]
                                    if self._leader_since is not None
                                    else 0.0),
                "leader_tenure_last_s": self._leader_tenure_last_s,
                "pending_requests": len(self._pending),
            }
            if self.role == LEADER:
                last = self.state.last_index()
                out["peer_lag"] = {
                    p: max(0, last - self._match_index.get(p, 0))
                    for p in self.peers}
            attrib = {}
            for name, samples in self._attrib.items():
                if not samples:
                    continue
                s = sorted(samples)
                attrib[name] = {
                    "n": len(s),
                    "p50_ms": _pctl(s, 0.50) * 1000.0,
                    "p99_ms": _pctl(s, 0.99) * 1000.0,
                    "mean_ms": (sum(s) / len(s)) * 1000.0,
                }
            out["attribution"] = attrib
            return out

    def _resolve(self, m: ClientResponse) -> None:
        fut = self._pending.pop(m.request_id, None)
        if fut is None:
            return
        span = getattr(fut, "raft_trace_span", None)
        if span is not None:
            if m.error is not None:
                span.set_tag("error", m.error)
            span.finish()
        # resolution stamp: lets the caller measure submit→resolve without
        # the waiter's thread-wakeup noise (GroupCommitter round samples —
        # the attribution-sum probe's measured side). Prefer the leader's
        # apply-end stamp carried on the response: the delivery hop back
        # then cancels out of the round, matching the interval the leader's
        # attribution telescopes over.
        rp_ns = getattr(m, "resolved_perf_ns", None)
        fut.raft_resolved_perf = rp_ns / 1e9 \
            if type(rp_ns) is int and rp_ns > 0 else _time.perf_counter()
        if m.error is not None:
            fut.set_exception(RaftApplyError(m.error))
        else:
            fut.set_result(m.result)


def _pctl(sorted_samples, q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample list."""
    idx = min(len(sorted_samples) - 1, int(q * len(sorted_samples)))
    return sorted_samples[idx]


class RaftApplyError(Exception):
    pass
