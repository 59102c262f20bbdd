"""Group-commit pipeline for notary uniqueness.

LEDGER_r01 spent one raft consensus round per committed transaction
(10.2 tx/s against 42.2k service verifies/s); this module closes that
gap the same way continuous batching closed it for signatures —
accumulate, cut batches, pipeline. Many concurrently suspended flows
call :meth:`GroupCommitter.submit`; a stall-tick dispatcher coalesces
their requests and submits ONE ``put_all_batch`` raft append carrying
the whole batch. The replicated ``DistributedImmutableMap.apply``
returns per-transaction verdicts in list order, so a conflicting
transaction is rejected individually without poisoning its batch, and
the first spender of a ref within a batch wins deterministically on
every replica.

Admission is pre-screened on the leader:

* **applied-map check** — a ref already consumed in the local replica's
  applied map can never un-consume (the map is immutable-growing), so
  the request is rejected immediately without spending a consensus
  round on it.
* **pending-overlap defer** — a ref claimed by an in-flight or queued
  transaction parks the request in a deferred list instead of rejecting
  it: if the blocker ultimately fails, the deferred request must still
  get its chance. Deferred requests are re-screened every time a batch
  completes.
* **reservation defer** — a ref provisionally held by a cross-shard
  2PC (``reserved_view``) is treated the same way: a reservation is
  revocable, so the request parks instead of receiving a terminal
  double-spend verdict for a state that may never be consumed. Because
  the blocker resolves OUTSIDE this committer (the coordinator's
  finalize/release rounds bypass it), the stall ticker re-screens the
  deferred list whenever no batch completion is coming. A consensus
  verdict whose conflicts are reservation-only arrives flagged
  ``provisional`` and re-parks the same way.

Batch cutting mirrors ``verifier.batcher.SignatureBatcher``: flush at
``max_batch`` depth, at the ``max_latency_s`` deadline from the first
enqueue, or on a stall (no new arrivals for ``stall_fraction`` of the
deadline). Batches run on a small pool so batch N+1's consensus round
overlaps batch N's (the raft leader serializes appends, not rounds).

Observability: a per-transaction ``raft.commit`` span (parented to the
caller's ``notary.uniqueness`` context) covers enqueue→verdict so
/traces stitching and the commit-path stage attribution keep working;
a per-batch ``notary.batch_commit`` span wraps the actual append; the
``ledger_commit_batch_size`` histogram and ``GroupCommit.*`` meters
feed the LEDGER artifact's amortization fields
(``commit_batch_occupancy_mean``, ``raft_appends_per_committed_tx``).
"""
from __future__ import annotations

import concurrent.futures
import threading
import time as _time
from collections import deque

from ..node.notary import UniquenessException, find_conflicts
from .provider import consensus_round


class _Req:
    """One queued uniqueness-commit request."""

    __slots__ = ("refs", "tx_id", "caller", "trace_ctx", "future", "span",
                 "t_enq")

    def __init__(self, refs, tx_id, caller, trace_ctx, future, span,
                 t_enq=0.0):
        self.refs = refs
        self.tx_id = tx_id
        self.caller = caller
        self.trace_ctx = trace_ctx
        self.future = future
        self.span = span
        self.t_enq = t_enq      # wall-clock enqueue time (wait-state span)


class GroupCommitter:
    """Accumulates uniqueness commits and submits them as batched raft
    appends — one consensus round amortized over the whole batch."""

    def __init__(self, backend, timeout_s: float = 30.0,
                 max_batch: int = 256, max_latency_s: float = 0.005,
                 stall_fraction: float = 0.2, metrics=None,
                 applied_view=None, reserved_view=None,
                 prescreen: bool = True,
                 max_inflight_batches: int = 4, label: str | None = None,
                 attempt_timeout_s: float | None = None):
        from ..observability import get_tracer
        from ..utils.metrics import MetricRegistry
        self.backend = backend
        self.timeout_s = timeout_s
        #: per-attempt bound on one consensus submit (provider.py): a
        #: batch stranded on a deposed leader is abandoned + re-submitted
        #: instead of serialising the whole pipeline behind timeout_s
        self.attempt_timeout_s = attempt_timeout_s
        self.max_batch = max_batch
        self.max_latency_s = max_latency_s
        self.stall_fraction = stall_fraction
        #: shard label ("s0"): tags this committer's spans and adds a
        #: labeled per-shard committed meter next to the shared aggregate
        #: ones (the federation `Family{worker="w0"}` naming convention).
        self.label = label
        #: prescreen=False feeds conflicting pairs into the SAME batch so
        #: apply's first-wins-in-list-order verdict is what's under test
        #: (the chaos suite uses this knob); production leaves it on.
        self.prescreen = prescreen
        self._applied_view = applied_view
        self._reserved_view = reserved_view
        self._tracer = get_tracer()
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._batch_size_hist = self.metrics.histogram(
            "ledger_commit_batch_size")
        self._raft_commit_hist = self.metrics.histogram("raft_commit_seconds")
        self._m_appends = self.metrics.meter("GroupCommit.RaftAppends")
        self._m_committed = self.metrics.meter("GroupCommit.Committed")
        self._m_rejected = self.metrics.meter("GroupCommit.Rejected")
        self._m_prescreened = self.metrics.meter("GroupCommit.PreScreened")
        self._m_deferred = self.metrics.meter("GroupCommit.Deferred")
        self._m_committed_shard = (
            self.metrics.meter(f'GroupCommit.Committed{{shard="{label}"}}')
            if label else None)

        self._lock = threading.Lock()
        # exact consensus-round durations (seconds), bounded. The same
        # value feeds the raft_commit_seconds histogram; the exact list
        # exists because the consensus-observatory validity probe compares
        # the raft-side attribution sum against this measured round within
        # 10% — inside the log-bucket histogram's quantile resolution.
        self._round_samples: deque = deque(maxlen=4096)
        self._queue: list[_Req] = []
        self._pending: dict = {}        # ref -> tx_id claimed by queue/flight
        self._deferred: list = []       # (refs, tx_id, caller, ctx, fut, t)
        self._inflight = 0              # batches submitted, not yet finished
        self._t_first = 0.0
        self._t_last = 0.0
        self._n_batches = 0
        self._closed = False
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, max_inflight_batches),
            thread_name_prefix="group-commit")
        self._stop = threading.Event()
        self._tick = max(0.0005, max_latency_s * stall_fraction / 2)
        self._ticker_thread = threading.Thread(
            target=self._ticker, name="group-commit-tick", daemon=True)
        self._ticker_thread.start()

    # -- admission -----------------------------------------------------------

    def submit(self, states, tx_id, caller: str, trace_ctx=None):
        """Enqueue one transaction's input refs for group commit. Returns a
        Future resolving ``None`` on commit or failing with
        :class:`UniquenessException` on conflict."""
        fut = concurrent.futures.Future()
        self._admit(tuple(states), tx_id, caller, trace_ctx, fut,
                    raise_closed=True)
        return fut

    def _admit(self, refs, tx_id, caller, trace_ctx, fut,
               raise_closed=False, t_defer=None):
        """Admission with prescreen. ``t_defer`` is set when this call is
        a re-screen of a previously deferred request: the original park
        time is preserved (one defer meter mark and one wait span per
        deferred EPISODE, however many re-screen polls it takes)."""
        reject = None
        do_flush = False
        now = _time.time()
        with self._lock:
            if self._closed:
                if raise_closed:
                    raise RuntimeError("GroupCommitter is closed")
                fut.set_exception(RuntimeError("GroupCommitter is closed"))
                return
            if self.prescreen:
                applied = (self._applied_view()
                           if self._applied_view is not None else None)
                if applied is not None:
                    conflicts = find_conflicts(applied, refs, tx_id)
                    if conflicts:
                        reject = UniquenessException(conflicts)
                blocked = False
                if reject is None and self._reserved_view is not None:
                    held = self._reserved_view()
                    blocked = any(
                        (h := held.get(r)) is not None
                        and getattr(h, "consuming_tx", None) != tx_id
                        for r in refs)
                if reject is None and (
                        blocked or any(r in self._pending for r in refs)):
                    # Park, never terminal-reject: a pending overlap
                    # resolves at batch completion, and a cross-shard
                    # reservation is REVOCABLE — its holder may abort and
                    # release, in which case this spend must still get
                    # its chance (the ticker re-screens for resolutions
                    # that happen outside this committer).
                    self._deferred.append(
                        (refs, tx_id, caller, trace_ctx, fut,
                         now if t_defer is None else t_defer))
                    if t_defer is None:
                        self._m_deferred.mark()
                    return
            if reject is None:
                tags = {"shard": self.label} if self.label else {}
                span = self._tracer.span(
                    "raft.commit", parent=trace_ctx, n_states=len(refs),
                    caller=caller, group_commit=True, **tags)
                for r in refs:
                    self._pending[r] = tx_id
                mono = _time.monotonic()
                if not self._queue:
                    self._t_first = mono
                self._t_last = mono
                self._queue.append(
                    _Req(refs, tx_id, caller, trace_ctx, fut, span,
                         t_enq=now))
                do_flush = len(self._queue) >= self.max_batch
        if t_defer is not None:
            # leaving the deferred state (enqueued or rejected): one wait
            # span covering the whole parked interval
            self._record_wait(trace_ctx, "wait.group_commit_defer",
                              "group_commit.defer", t_defer, now)
        if reject is not None:
            self._m_prescreened.mark()
            fut.set_exception(reject)
        elif do_flush:
            self._flush("max_batch")

    # -- batch cutting -------------------------------------------------------

    def _ticker(self):
        while not self._stop.wait(self._tick):
            reason = None
            rescreen = None
            with self._lock:
                if self._queue:
                    now = _time.monotonic()
                    if now >= self._t_first + self.max_latency_s:
                        reason = "deadline"
                    elif now >= (self._t_last
                                 + self.max_latency_s * self.stall_fraction):
                        reason = "stalled"
                elif self._deferred and self._inflight == 0:
                    # nothing queued and no batch in flight: no batch
                    # completion is coming to re-screen the deferred set,
                    # and its blocker (a cross-shard reservation) resolves
                    # OUTSIDE this committer — poll from the ticker so a
                    # released ref's spender is never stranded
                    rescreen, self._deferred = self._deferred, []
            if reason is not None:
                self._flush(reason)
            if rescreen:
                for refs, tx_id, caller, trace_ctx, fut, t_defer in rescreen:
                    self._admit(refs, tx_id, caller, trace_ctx, fut,
                                t_defer=t_defer)

    def _flush(self, reason: str):
        with self._lock:
            if not self._queue:
                return
            reqs = self._queue[:self.max_batch]
            del self._queue[:len(reqs)]
            if self._queue:
                # restamp the deadline clock for the remainder
                self._t_first = _time.monotonic()
            self._n_batches += 1
            self._inflight += 1
        try:
            self._pool.submit(self._run_batch, reqs, reason)
        except RuntimeError:
            # pool already shut down (close race): run inline so no
            # future is ever dropped
            self._run_batch(reqs, reason)

    def _run_batch(self, reqs, reason: str):
        first_ctx = next(
            (r.trace_ctx for r in reqs if r.trace_ctx is not None), None)
        n_states = sum(len(r.refs) for r in reqs)
        tags = {"shard": self.label} if self.label else {}
        sp = self._tracer.span("notary.batch_commit", parent=first_ctx,
                               n_txs=len(reqs), n_states=n_states,
                               reason=reason, **tags)
        trace_id = getattr(sp.context() or first_ctx, "trace_id", None)
        self._batch_size_hist.update(float(len(reqs)), trace_id=trace_id)
        round_t0 = _time.time()
        t0 = _time.perf_counter()
        results = None
        error = None
        timing: dict = {}
        try:
            payload = [[r.tx_id, list(r.refs), r.caller] for r in reqs]
            out = consensus_round(
                self.backend, ("put_all_batch", payload), self.timeout_s,
                trace_ctx=sp.context() or first_ctx,
                on_attempt=self._m_appends.mark,
                site="raft.submit.group_commit",
                attempt_timeout_s=self.attempt_timeout_s,
                timing=timing)
            results = out["results"]
        except BaseException as e:
            error = e
            sp.set_tag("error", f"{type(e).__name__}: {e}")
        finally:
            sp.finish()
            # prefer the backend's resolution stamp: submit→resolve without
            # this waiter thread's wakeup latency, matching what the raft
            # side can attribute (the 10% conservation probe's comparison)
            submit_p = timing.get("submit_perf")
            resolved_p = timing.get("resolved_perf")
            if isinstance(submit_p, float) and isinstance(resolved_p, float) \
                    and resolved_p > submit_p:
                round_s = resolved_p - submit_p
            else:
                round_s = _time.perf_counter() - t0
            self._raft_commit_hist.update(round_s, trace_id=trace_id)
            self._round_samples.append(round_s)
        self._finish_batch(reqs, results, error,
                           round_t0=round_t0, round_t1=_time.time())

    def _record_wait(self, parent, name: str, kind: str, t0, t1,
                     **tags) -> None:
        """Retroactive wait-state span under a request's ``raft.commit``
        span: decomposes enqueue→verdict into cutter-queue time vs the
        consensus round actually in flight (critpath.py blame input)."""
        if not t0 or not t1 or t1 <= t0:
            return
        self._tracer.record(name, parent=parent, start_s=t0,
                            duration_s=t1 - t0, wait_kind=kind, **tags)

    def _finish_batch(self, reqs, results, error, round_t0=None,
                      round_t1=None):
        for req in reqs:
            # queue wait: enqueue → batch cut; round wait: the shared
            # consensus round this request rode (overlaps its batch-mates)
            self._record_wait(req.span, "wait.group_commit_queue",
                              "group_commit.queue", req.t_enq, round_t0)
            self._record_wait(req.span, "wait.group_commit_round",
                              "group_commit.round", round_t0, round_t1)
        provisional: list[_Req] = []
        for i, req in enumerate(reqs):
            if error is not None:
                req.span.set_tag("error",
                                 f"{type(error).__name__}: {error}")
                req.span.finish()
                req.future.set_exception(error)
                continue
            verdict = results[i]
            if (self.prescreen and not verdict["committed"]
                    and verdict.get("provisional")):
                # every conflict is a revocable cross-shard reservation,
                # not a consumed entry: re-park instead of handing the
                # client a terminal double-spend for an unspent state
                req.span.set_tag("deferred_reservation", True)
                req.span.finish()
                provisional.append(req)
                continue
            req.span.set_tag("committed", verdict["committed"])
            req.span.finish()
            if verdict["committed"]:
                self._m_committed.mark()
                if self._m_committed_shard is not None:
                    self._m_committed_shard.mark()
                req.future.set_result(None)
            else:
                self._m_rejected.mark()
                req.future.set_exception(
                    UniquenessException(verdict["conflicts"]))
        # release this batch's ref claims, then give every deferred
        # request another pass through admission (it may commit now that
        # its blocker resolved, defer again behind a still-queued tx, or
        # reject against the freshly grown applied map)
        with self._lock:
            for req in reqs:
                for ref in req.refs:
                    if self._pending.get(ref) == req.tx_id:
                        del self._pending[ref]
            deferred, self._deferred = self._deferred, []
            self._inflight -= 1
        for refs, tx_id, caller, trace_ctx, fut, t_defer in deferred:
            self._admit(refs, tx_id, caller, trace_ctx, fut, t_defer=t_defer)
        for req in provisional:
            self._admit(req.refs, req.tx_id, req.caller, req.trace_ctx,
                        req.future)

    # -- lifecycle -----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"queue_depth": len(self._queue),
                    "pending_refs": len(self._pending),
                    "deferred": len(self._deferred),
                    "batches": self._n_batches,
                    "closed": self._closed}

    def round_samples(self) -> list:
        """Exact retained consensus-round durations (seconds, oldest
        evicted at the cap) — the measured side of the consensus
        observatory's attribution-conservation probe."""
        with self._lock:
            return list(self._round_samples)

    def close(self) -> None:
        """Flush whatever is queued, drain in-flight batches, and fail any
        request still deferred (its blocker never resolved)."""
        self._stop.set()
        self._pool.shutdown(wait=True)
        # drain inline: each pass runs a batch synchronously (the pool is
        # gone, so _flush falls back to inline), whose completion may
        # re-enqueue deferred requests — loop until nothing is queued
        while True:
            with self._lock:
                empty = not self._queue
            if empty:
                break
            self._flush("close")
        with self._lock:
            self._closed = True
            leftovers = self._queue + [
                _Req(refs, tx_id, caller, ctx, fut, None)
                for refs, tx_id, caller, ctx, fut, _t in self._deferred]
            self._queue = []
            self._deferred = []
            self._pending.clear()
        for req in leftovers:
            if req.span is not None:
                req.span.set_tag("error", "GroupCommitter closed")
                req.span.finish()
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("GroupCommitter closed before commit"))
        if self._ticker_thread.is_alive():
            self._ticker_thread.join(timeout=1.0)
