"""BFT total-order broadcast for the notary commit log (PBFT-style).

Reference parity: the role BFT-SMaRt plays (node/services/transactions/
BFTSMaRt.kt:73-145 Client via ServiceProxy.invokeOrdered, :169+ Replica via
DefaultRecoverable; BFTNonValidatingNotaryService.kt): a 3f+1 replica
cluster totally orders commit requests and each replica applies them to the
same deterministic state machine; the client accepts a result once f+1
replicas agree.

Protocol (PBFT normal case): client Request → primary PrePrepare(view, seq)
→ replicas Prepare → (2f matching) → Commit → (2f+1 matching) → execute in
sequence order → Reply; the client waits for f+1 matching replies.

View change (PBFT §4.4 shape, certificate-carrying): on timeout a replica
broadcasts ViewChange carrying its *prepared certificates* — for every
sequence it prepared, the PrePrepare plus ≥2f matching Prepare messages.
The new primary assembles a 2f+1 ViewChange quorum into a NewView whose
re-proposal order is a DETERMINISTIC function of the quorum (certificates
sorted by (view, seq), deduplicated by request id); every replica
re-derives that order from the embedded quorum and rejects a NewView (or a
subsequent out-of-order PrePrepare) that deviates, voting the next view
instead. Re-proposals take fresh sequence numbers above every sequence the
quorum can have committed; the state machine's per-request idempotence
makes re-execution of already-applied requests a no-op.

Documented simplifications vs full PBFT: (a) message authenticity comes
from the transport (mutual-TLS peer identity / the in-memory bus), not
per-message signatures; (b) the stable-checkpoint subsystem is replaced
by a certificate retention window (CERT_RETENTION executed sequences); a
correct replica lagging by more than the window catches up via the built-in
state transfer — it asks EVERY other replica and installs a snapshot only
once f+1 distinct replicas return byte-identical state, so a single
Byzantine responder (including a Byzantine new primary) cannot install
fabricated notary state (PBFT §4.6 shape).
"""
from __future__ import annotations

import hashlib
import logging
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable

from ..core.serialization import deserialize, register_type, serialize
from ..network.messaging import TopicSession

log = logging.getLogger(__name__)

TOPIC_BFT = "platform.bft"

VIEW_CHANGE_TICKS = 20
STATE_RETRY_TICKS = 10  # re-poll cadence while a state transfer is pending
CERT_RETENTION = 256   # executed seqs whose prepared certs are retained
                       # (the stable-checkpoint-window analog)


@dataclass(frozen=True)
class Request:
    request_id: int
    client: str
    entry: Any


@dataclass(frozen=True)
class PrePrepare:
    view: int
    seq: int
    digest: bytes
    request: Request


@dataclass(frozen=True)
class Prepare:
    view: int
    seq: int
    digest: bytes
    replica: str


@dataclass(frozen=True)
class CommitMsg:
    view: int
    seq: int
    digest: bytes
    replica: str


@dataclass(frozen=True)
class Reply:
    request_id: int
    replica: str
    result: Any = None
    error: str | None = None


@dataclass(frozen=True)
class PreparedCert:
    """Proof that a sequence prepared: the PrePrepare plus ≥2f matching
    Prepare messages from distinct replicas."""

    pre_prepare: PrePrepare
    prepares: tuple       # Prepare...


@dataclass(frozen=True)
class ViewChange:
    new_view: int
    replica: str
    executed_through: int = -1
    prepared: tuple = ()  # PreparedCert...


@dataclass(frozen=True)
class NewView:
    view: int
    view_changes: tuple   # the 2f+1 ViewChange quorum (the certificate)
    requests: tuple       # re-proposal order — must re-derive from the quorum


@dataclass(frozen=True)
class StateRequest:
    """Catch-up request from a replica whose watermark jumped past requests
    it never applied (lagging beyond the certificate window)."""

    replica: str
    through: int          # requester's executed_through


@dataclass(frozen=True)
class StateResponse:
    replica: str          # responder (transport-authenticated identity)
    snapshot: bytes       # state-machine snapshot (snapshot_fn)
    through: int          # seq the snapshot covers
    executed_ids: tuple   # request-id dedup set at that point


for _cls in (Request, PrePrepare, Prepare, CommitMsg, Reply, PreparedCert,
             ViewChange, NewView, StateRequest, StateResponse):
    register_type(f"bft.{_cls.__name__}", _cls)


def _digest(request: Request) -> bytes:
    return hashlib.sha256(serialize(request)).digest()


class BFTReplica:
    """One of the 3f+1 replicas (BFTSMaRt.Replica / CordaServiceReplica)."""

    def __init__(self, replica_id: str, replicas: list[str], messaging,
                 apply_fn: Callable[[Any], Any],
                 snapshot_fn: Callable[[], bytes] | None = None,
                 restore_fn: Callable[[bytes], None] | None = None,
                 cert_retention: int = CERT_RETENTION):
        """``snapshot_fn``/``restore_fn``: state-machine snapshot hooks
        enabling state transfer for replicas that fall behind the
        certificate window (DistributedImmutableMap.snapshot/restore)."""
        self.replica_id = replica_id
        self.replicas = list(replicas)
        self.index = replicas.index(replica_id)
        self.n = len(replicas)
        self.f = (self.n - 1) // 3
        self.messaging = messaging
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.cert_retention = cert_retention
        self.view = 0
        self.next_seq = 0              # primary's sequence counter
        self.executed_through = -1
        self._log: dict[int, PrePrepare] = {}
        self._prepares: dict[tuple, dict[str, Prepare]] = {}
        self._commits: dict[tuple, set] = {}
        self._committed: dict[int, PrePrepare] = {}
        self._prepared: dict[int, PreparedCert] = {}     # seq -> newest cert
        self._executed_requests: set = set()
        self._pending: dict[int, Request] = {}   # awaiting execution (by rid)
        self._vc_msgs: dict[int, dict[str, ViewChange]] = {}
        self._nv_sent: set[int] = set()
        self._expected_order: list = []   # request ids owed by a NewView
        self._ticks_waiting = 0
        self._lock = threading.RLock()
        messaging.add_message_handler(TopicSession(TOPIC_BFT), self._on_message)

    # -- helpers -------------------------------------------------------------
    @property
    def primary(self) -> str:
        return self.replicas[self.view % self.n]

    @property
    def is_primary(self) -> bool:
        return self.primary == self.replica_id

    def _broadcast(self, msg) -> None:
        for r in self.replicas:
            if r == self.replica_id:
                self._handle(msg)
            else:
                self.messaging.send(TopicSession(TOPIC_BFT), serialize(msg), r)

    def _send(self, to: str, msg) -> None:
        self.messaging.send(TopicSession(TOPIC_BFT), serialize(msg), to)

    # -- liveness ------------------------------------------------------------
    def tick(self) -> None:
        with self._lock:
            if self._state_request_mark is not None:
                # pending state transfer: re-poll until f+1 replicas answer
                # with identical state. Responders at different watermarks
                # hash to different vote keys, so a tally can stall while
                # the cluster is mid-flight; once it quiesces the snapshots
                # converge and a retry completes the install.
                self._st_ticks += 1
                if self._st_ticks >= STATE_RETRY_TICKS:
                    self._request_state()
            if self._pending and not self.is_primary:
                self._ticks_waiting += 1
                if self._ticks_waiting >= VIEW_CHANGE_TICKS:
                    self._ticks_waiting = 0
                    self._vote_view_change(self.view + 1)
            else:
                self._ticks_waiting = 0

    def _vote_view_change(self, new_view: int) -> None:
        log.info("%s votes for view %d", self.replica_id, new_view)
        certs = tuple(cert for _, cert in sorted(self._prepared.items()))
        self._broadcast(ViewChange(new_view, self.replica_id,
                                   self.executed_through, certs))

    # -- message handling ----------------------------------------------------
    def _on_message(self, msg) -> None:
        self._handle(deserialize(msg.data), sender=msg.sender)

    def _handle(self, m, sender: str | None = None) -> None:
        with self._lock:
            if isinstance(m, Request):
                self._on_request(m)
            elif isinstance(m, PrePrepare):
                self._on_preprepare(m)
            elif isinstance(m, Prepare):
                self._on_prepare(m)
            elif isinstance(m, CommitMsg):
                self._on_commit(m)
            elif isinstance(m, ViewChange):
                self._on_view_change(m)
            elif isinstance(m, NewView):
                self._on_new_view(m)
            elif isinstance(m, StateRequest):
                self._on_state_request(m)
            elif isinstance(m, StateResponse):
                self._on_state_response(m, sender)

    def _on_request(self, req: Request) -> None:
        if req.request_id in self._executed_requests:
            return
        self._pending[req.request_id] = req
        if self.is_primary:
            seq = self.next_seq
            self.next_seq += 1
            pp = PrePrepare(self.view, seq, _digest(req), req)
            self._broadcast(pp)

    def _on_preprepare(self, pp: PrePrepare) -> None:
        if pp.view != self.view:
            return
        if pp.digest != _digest(pp.request):
            # a forged digest would let an equivocating primary reach quorum
            # on one digest while shipping different requests — reject it
            self._vote_view_change(self.view + 1)
            return
        if self._expected_order:
            # a NewView promised this exact re-proposal order; a primary that
            # deviates from its own certificate is equivocating
            expected = self._expected_order.pop(0)
            if pp.request.request_id != expected:
                self._vote_view_change(self.view + 1)
                return
        existing = self._log.get(pp.seq)
        if existing is not None and existing.view == pp.view \
                and existing.digest != pp.digest:
            # primary equivocation within one view: refuse, push a view change
            self._vote_view_change(self.view + 1)
            return
        self._log[pp.seq] = pp
        if pp.request.request_id not in self._executed_requests:
            self._pending.setdefault(pp.request.request_id, pp.request)
        self._broadcast(Prepare(pp.view, pp.seq, pp.digest, self.replica_id))

    def _on_prepare(self, p: Prepare) -> None:
        if p.view != self.view:
            return
        key = (p.view, p.seq, p.digest)
        votes = self._prepares.setdefault(key, {})
        votes[p.replica] = p
        # prepared: matching preprepare + 2f prepares; commit once
        if len(votes) >= 2 * self.f and p.seq in self._log \
                and self._log[p.seq].digest == p.digest:
            pp = self._log[p.seq]
            held = self._prepared.get(p.seq)
            if held is None or held.pre_prepare.view < pp.view:
                self._prepared[p.seq] = PreparedCert(
                    pp, tuple(sorted(votes.values(), key=lambda m: m.replica)))
            if self.replica_id not in self._commits.get(key, set()):
                self._broadcast(CommitMsg(p.view, p.seq, p.digest,
                                          self.replica_id))

    def _on_commit(self, c: CommitMsg) -> None:
        if c.view != self.view:
            return
        key = (c.view, c.seq, c.digest)
        votes = self._commits.setdefault(key, set())
        votes.add(c.replica)
        if len(votes) >= 2 * self.f + 1 and c.seq in self._log \
                and self._log[c.seq].digest == c.digest:
            self._committed[c.seq] = self._log[c.seq]
            self._execute_ready()

    def _execute_ready(self) -> None:
        while self.executed_through + 1 in self._committed:
            self.executed_through += 1
            pp = self._committed[self.executed_through]
            req = pp.request
            self._pending.pop(req.request_id, None)
            if req.request_id in self._executed_requests:
                continue   # re-proposal of an already-applied request: no-op
            self._executed_requests.add(req.request_id)
            self._ticks_waiting = 0
            try:
                result, error = self.apply_fn(req.entry), None
            except Exception as e:
                result, error = None, str(e)
            self._send(req.client, Reply(req.request_id, self.replica_id,
                                         result, error))
            self._gc(self.executed_through)

    def _gc(self, through: int) -> None:
        """Prune per-sequence protocol state at/below the executed watermark
        (the minimal stable-checkpoint analog) so replica memory tracks the
        state machine, not total historical throughput. Prepared certificates
        are retained for CERT_RETENTION extra sequences so view changes can
        still re-propose recently executed requests to lagging replicas."""
        self._log = {s: pp for s, pp in self._log.items() if s > through}
        self._committed = {s: pp for s, pp in self._committed.items()
                           if s > through}
        self._prepares = {k: v for k, v in self._prepares.items()
                          if k[1] > through}
        self._commits = {k: v for k, v in self._commits.items()
                         if k[1] > through}
        self._prepared = {s: c for s, c in self._prepared.items()
                          if s > through - self.cert_retention}

    # -- view change (certificate-carrying; see module docstring) ------------
    def _derive_requests(self, view_changes) -> tuple | None:
        """The deterministic re-proposal order a ViewChange quorum implies:
        validated prepared certificates sorted by (view, seq), deduplicated
        by request id. None if any certificate fails validation."""
        certs = []
        for vc in view_changes:
            for cert in vc.prepared:
                pp = cert.pre_prepare
                if pp.digest != _digest(pp.request):
                    return None
                voters = {p.replica for p in cert.prepares
                          if (p.view, p.seq, p.digest)
                          == (pp.view, pp.seq, pp.digest)}
                if len(voters) < 2 * self.f:
                    return None
                certs.append(cert)
        certs.sort(key=lambda c: (c.pre_prepare.view, c.pre_prepare.seq))
        seen, out = set(), []
        for c in certs:
            rid = c.pre_prepare.request.request_id
            if rid not in seen:
                seen.add(rid)
                out.append(c.pre_prepare.request)
        return tuple(out)

    @staticmethod
    def _safe_next_seq(view_changes) -> int:
        """First sequence no member of the quorum can have committed below:
        above every reported executed watermark and every certified seq."""
        top = -1
        for vc in view_changes:
            top = max(top, vc.executed_through)
            for cert in vc.prepared:
                top = max(top, cert.pre_prepare.seq)
        return top + 1

    def _on_view_change(self, vc: ViewChange) -> None:
        if vc.new_view <= self.view:
            return
        msgs = self._vc_msgs.setdefault(vc.new_view, {})
        msgs[vc.replica] = vc
        # PBFT join rule: co-vote once f+1 others want the change, regardless
        # of local pending state — otherwise a replica that never saw the
        # client request blocks the 2f+1 quorum at exactly 2f+1 live replicas
        if self.replica_id not in msgs and len(msgs) >= self.f + 1:
            self._vote_view_change(vc.new_view)
            msgs = self._vc_msgs[vc.new_view]
        if len(msgs) < 2 * self.f + 1:
            return
        if (self.replicas[vc.new_view % self.n] == self.replica_id
                and vc.new_view not in self._nv_sent):
            # I lead the new view: publish the quorum + derived order, then
            # re-propose (certified requests first, my other pendings after)
            self._nv_sent.add(vc.new_view)
            quorum = tuple(msgs.values())
            reqs = self._derive_requests(quorum)
            if reqs is None:   # a peer shipped a bogus certificate
                self._vote_view_change(vc.new_view + 1)
                return
            log.info("%s leads view %d: %d certified re-proposals",
                     self.replica_id, vc.new_view, len(reqs))
            self.view = vc.new_view
            self._ticks_waiting = 0
            self._expected_order = []
            self._log = {s: pp for s, pp in self._log.items()
                         if s <= self.executed_through}
            # the view's sequence base: above anything the quorum can have
            # committed. Jump the execution watermark there — sequences below
            # it can never commit in this view, and every request that might
            # have committed in one rides the certified re-proposals.
            old = self.executed_through
            base = self._safe_next_seq(quorum)
            self.next_seq = base
            self.executed_through = max(self.executed_through, base - 1)
            # a leader that lagged beyond the certificate window must catch
            # up too (ADVICE r1): it would otherwise serve snapshots from a
            # deficient state machine
            self._maybe_request_state(old, base)
            self._broadcast(NewView(vc.new_view, quorum, reqs))
            for req in reqs:
                self._propose(req)
            for req in list(self._pending.values()):
                if req.request_id not in {r.request_id for r in reqs}:
                    self._propose(req)

    def _propose(self, req: Request) -> None:
        """Assign the next sequence and pre-prepare (primary only). Unlike
        _on_request this does NOT skip locally-executed requests: a certified
        re-proposal must reach replicas that never executed it."""
        seq = self.next_seq
        self.next_seq += 1
        self._broadcast(PrePrepare(self.view, seq, _digest(req), req))

    def _on_new_view(self, nv: NewView) -> None:
        if nv.view <= self.view:
            return
        senders = {vc.replica for vc in nv.view_changes}
        derived = (self._derive_requests(nv.view_changes)
                   if (len(senders) >= 2 * self.f + 1
                       and all(vc.new_view == nv.view
                               for vc in nv.view_changes)) else None)
        if derived is None or derived != nv.requests:
            # invalid quorum or a re-proposal order that doesn't follow from
            # it — treat the claimed leader as faulty
            self._vote_view_change(nv.view + 1)
            return
        self.view = nv.view
        self._ticks_waiting = 0
        self._log = {s: pp for s, pp in self._log.items()
                     if s <= self.executed_through}
        old = self.executed_through
        base = self._safe_next_seq(nv.view_changes)   # same jump as the leader
        self.executed_through = max(self.executed_through, base - 1)
        self._expected_order = [r.request_id for r in nv.requests]
        for req in nv.requests:
            if req.request_id not in self._executed_requests:
                self._pending.setdefault(req.request_id, req)
        self._maybe_request_state(old, base)

    # -- state transfer (the BFT-SMaRt state-transfer role) ------------------
    _state_request_mark: int | None = None
    _applied_marker: int = -1
    _state_votes: dict = None   # replaced with a fresh dict per request round
    _st_ticks: int = 0

    def _request_state(self) -> None:
        """(Re)start a state-transfer round: reset the mark + vote tally and
        ask EVERY other replica (≥2f+1 reachable in any view-change quorum)
        for its state at our applied watermark."""
        self._st_ticks = 0
        self._state_request_mark = self.executed_through
        self._state_votes = {}
        for r in self.replicas:
            if r != self.replica_id:
                self._send(r, StateRequest(self.replica_id,
                                           self._applied_marker))

    def _maybe_request_state(self, old: int, base: int) -> None:
        """If the watermark jump skipped sequences outside the certificate
        window, requests executed elsewhere that no re-proposal carries are
        missing locally — catch up via cross-validated state transfer.
        The request goes to EVERY other replica (≥2f+1 reachable in any
        view-change quorum) and a snapshot is only installed once f+1
        distinct replicas return byte-identical state (PBFT §4.6 /
        BFT-SMaRt state transfer): one Byzantine responder — including a
        Byzantine new primary — cannot install fabricated notary state."""
        if old >= base - 1 - self.cert_retention:
            return
        if self.restore_fn is None:
            log.warning(
                "%s: watermark jump %d -> %d skipped sequences beyond the "
                "certificate window but no restore_fn is configured — the "
                "local state machine is missing commits and cannot catch up",
                self.replica_id, old, base - 1)
            return
        self._applied_marker = old
        self._request_state()

    def _on_state_request(self, m: StateRequest) -> None:
        if self.snapshot_fn is None or self.executed_through <= m.through:
            return
        self._send(m.replica, StateResponse(
            self.replica_id, self.snapshot_fn(), self.executed_through,
            tuple(sorted(self._executed_requests))))

    def _on_state_response(self, m: StateResponse,
                           sender: str | None = None) -> None:
        if self.restore_fn is None or self._state_request_mark is None:
            return
        # the vote identity is the TRANSPORT-authenticated sender (mTLS cert
        # CN / in-memory bus name) — the payload's self-declared replica
        # field alone would let one Byzantine peer cast all f+1 votes. A
        # payload that disagrees with its transport identity is discarded.
        voter = sender if sender is not None else m.replica
        if m.replica != voter or voter == self.replica_id \
                or voter not in self.replicas:
            return
        if self.executed_through != self._state_request_mark:
            # we applied new commits since asking: those snapshots may miss
            # them — ask everyone again (the applied marker still
            # lower-bounds what we could be missing)
            self._request_state()
            return
        if m.through < self.executed_through:
            return
        # tally byte-identical responses; install only at f+1 agreement
        key = hashlib.sha256(
            serialize([m.snapshot, m.through, m.executed_ids])).digest()
        votes = self._state_votes if self._state_votes is not None else {}
        self._state_votes = votes
        votes.setdefault(key, set()).add(voter)
        if len(votes[key]) < self.f + 1:
            return
        self.restore_fn(m.snapshot)
        self._executed_requests.update(m.executed_ids)
        self.executed_through = max(self.executed_through, m.through)
        for rid in m.executed_ids:
            self._pending.pop(rid, None)
        self._state_request_mark = None
        self._state_votes = {}
        self._st_ticks = 0


class BFTClient:
    """The ServiceProxy.invokeOrdered analog: broadcast the request to every
    replica, accept once f+1 replicas return the same verdict."""

    def __init__(self, client_id: str, replicas: list[str], messaging):
        self.client_id = client_id
        self.replicas = list(replicas)
        self.f = (len(replicas) - 1) // 3
        self.messaging = messaging
        self._ids = iter(range(1, 1 << 62))
        self._waiting: dict[int, dict] = {}
        self._lock = threading.Lock()
        messaging.add_message_handler(TopicSession(TOPIC_BFT), self._on_reply)

    def submit(self, entry) -> Future:
        with self._lock:
            rid = next(self._ids)
            fut: Future = Future()
            fut.bft_request_id = rid
            self._waiting[rid] = {"future": fut, "replies": {}}
        req = Request(rid, self.client_id, entry)
        for r in self.replicas:
            self.messaging.send(TopicSession(TOPIC_BFT), serialize(req), r)
        return fut

    def abandon(self, fut: Future) -> None:
        with self._lock:
            self._waiting.pop(getattr(fut, "bft_request_id", None), None)

    def _on_reply(self, msg) -> None:
        m = deserialize(msg.data)
        if not isinstance(m, Reply):
            return
        with self._lock:
            entry = self._waiting.get(m.request_id)
            if entry is None:
                return
            key = serialize([m.result, m.error])
            entry["replies"].setdefault(key, set()).add(m.replica)
            if len(entry["replies"][key]) >= self.f + 1:
                del self._waiting[m.request_id]
                fut = entry["future"]
            else:
                return
        if m.error is not None:
            fut.set_exception(BFTApplyError(m.error))
        else:
            fut.set_result(m.result)


class BFTApplyError(Exception):
    pass


class BFTUniquenessProvider:
    """UniquenessProvider over the BFT cluster (BFTSMaRt.Client.
    commitTransaction semantics)."""

    def __init__(self, client: BFTClient, timeout_s: float = 30.0):
        self.client = client
        self.timeout_s = timeout_s

    def commit(self, states, tx_id, caller: str) -> None:
        from .provider import consensus_commit
        consensus_commit(self.client, states, tx_id, caller, self.timeout_s)
