"""Out-of-process verification: request/response queues + worker pool.

Port of corda_tpu.verifier.out_of_process: the same messages (same codec
names, same bytes), queue and service; the worker's SignatureBatcher runs
the port's CUDA kernels on the device the worker is given (``device=``,
default "cuda").

Reference parity:
- `VerifierApi.VerificationRequest{verificationId, transaction,
  responseAddress}` / `VerificationResponse{verificationId, exception?}`
  (node-api/.../VerifierApi.kt:17-59)
- the standalone verifier worker loop (verifier/.../Verifier.kt:42-79):
  deserialize the LedgerTransaction, run `.verify()`, reply exception-or-null
- competing consumers + redistribution on worker death
  (VerifierTests.kt:53-71, 73+ "verification redistributes on verifier
  death"), and the node's warning when no verifier is attached
  (NodeMessagingClient.kt:200-210)

The queue semantics live in `VerifierRequestQueue` (the Artemis
`verifier.requests` queue analog): work is dealt to attached workers by a
load-aware router (live queue depth from periodic worker load reports +
scheme affinity, round-robin tie-break), outstanding work is tracked per
worker, and a worker's detachment requeues everything it held. An idle
worker triggers WORK STEALING: the node asks the deepest straggler to hand
back the tail of its stealable backlog (WorkReturned) and re-deals it —
exactly-once future resolution is preserved because a returned request is
re-dealt only while still charged to the victim, and duplicate responses
find their handle already popped. Transport-independent — the deterministic
in-memory bus in tests, the TCP plane in production.
"""
from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, replace as dc_replace
from typing import Any

from ..core.serialization import deserialize, register_type, serialize
from ..device import resolve_device
from ..network.messaging import (TOPIC_VERIFIER_REQUESTS,
                                 TOPIC_VERIFIER_RESPONSES, TopicSession)
from ..observability import (FleetMetricsFederation, RequestLog, get_tracer,
                             make_span_dict)
from ..observability.slog import jlog
from ..utils import retry
from ..utils.faults import DROP, fault_point
from ..utils.metrics import MetricRegistry
from .service import TransactionVerifierService

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class VerificationRequest:
    """One transaction's verification work unit (VerifierApi.kt:33-37).

    Device-first extension of the reference shape: ``signatures`` carries the
    (public key, signature bytes, signed content) triples of the enclosing
    SignedTransaction so the WORKER runs them through its device batcher —
    N workers × cross-request batching is the scale-out story
    (Verifier.kt:42-79) with the EC math actually on the accelerator.
    Empty signatures = reference semantics (ltx platform/contract rules
    only, host-side)."""

    verification_id: int
    transaction: Any          # LedgerTransaction
    response_address: str
    signatures: tuple = ()    # ((PublicKey, sig_bytes, content_bytes), ...)
    #: Serialized SpanContext ``(trace_id, span_id)`` of the node-side
    #: verifier.oop_submit span — the worker parents its child spans here.
    #: Trailing default keeps old-worker decode working (cross-process
    #: trace stitching; empty when node tracing is off).
    trace: tuple = ()


@dataclass(frozen=True)
class VerificationResponse:
    verification_id: int
    error_message: str | None
    #: Finished worker-side span dicts (backlog wait, device dispatch,
    #: host verify) piggybacked on the reply — the node ``ingest``s them
    #: into its span ring to stitch the end-to-end trace. JSON-encoded
    #: (``_pack_obs``): span timings are floats, which the codec forbids
    #: in typed consensus data; the diagnostic payload rides as a string.
    spans: str = ""


@dataclass(frozen=True)
class WorkerHello:
    """A worker attaching to the queue (the Artemis consumer-creation analog).

    ``device_shard`` carries the CUDA device indices this worker's
    batcher is pinned to and ``capacity`` its relative weight (≈ devices
    in the shard) — the router normalizes estimated load by capacity, and
    both surface as per-worker ``Fleet.*`` gauges on /metrics. Defaults
    keep pre-fleet hellos deserializing."""

    worker_address: str
    device_shard: tuple = ()    # CUDA device indices, () = unpinned
    capacity: int = 1


@dataclass(frozen=True)
class WorkerGoodbye:
    worker_address: str


@dataclass(frozen=True)
class WorkerLoadReport:
    """Periodic worker → node load report (the batcher's gauges shipped
    back over the worker wire): ``pending`` is the stealable backlog weight
    in signatures, ``in_flight`` the signatures submitted to the batcher but
    unresolved, ``queue_depths`` the per-scheme batcher depths (affinity
    signal). A report is also a liveness signal (_last_activity)."""

    worker_address: str
    pending: int
    in_flight: int
    queue_depths: tuple = ()    # ((scheme, depth), ...)
    capacity: int = 1
    #: Finished spans with no reply to ride (worker.stolen parked-time
    #: spans) — drained from the worker's span outbox onto the next
    #: report. JSON-encoded list (``_pack_obs``).
    spans: str = ""
    #: The worker's metric registry snapshot, JSON-encoded
    #: ``{family: fields}`` — the node federates these into worker-labeled
    #: /metrics families (observability/federation.py).
    metrics: str = ""


@dataclass(frozen=True)
class StealRequest:
    """Node → straggler: hand back up to ``max_items`` requests from the
    tail of your stealable backlog (``thief_address`` is informational —
    the node re-deals through the router, it does not promise the thief)."""

    thief_address: str
    max_items: int
    #: SpanContext of the node's verifier.steal_request span — stolen-work
    #: spans tag it so a steal decision cross-links to the requests it moved.
    trace: tuple = ()


@dataclass(frozen=True)
class WorkReturned:
    """Straggler → node: the stolen requests (possibly empty — an empty
    return still acks the StealRequest and clears the in-flight marker)."""

    worker_address: str
    requests: tuple = ()


for _cls in (VerificationRequest, VerificationResponse, WorkerHello,
             WorkerGoodbye, WorkerLoadReport, StealRequest, WorkReturned):
    register_type(f"verifier.{_cls.__name__}", _cls)


def _pack_obs(obj) -> str:
    """Observability piggyback (span lists / metric snapshots) → JSON
    string. The codec deliberately rejects floats in typed wire data
    (non-deterministic in consensus), but span durations and metric rates
    ARE floats — so the diagnostic payload travels as one opaque string
    and never constrains (or is constrained by) consensus typing. Returns
    "" for empty/unserializable input: observability must never fail a
    verification message."""
    if not obj:
        return ""
    try:
        return json.dumps(obj, default=str)
    except (TypeError, ValueError):
        return ""


def _unpack_obs(blob, default):
    """Inverse of _pack_obs — tolerant: anything malformed (an old worker,
    a truncated report) yields ``default`` rather than raising."""
    if not blob or not isinstance(blob, str):
        return default
    try:
        out = json.loads(blob)
    except ValueError:
        return default
    return out if isinstance(out, type(default)) else default


def _weight(req: VerificationRequest) -> int:
    """Routing weight of one request: its signature count (≥ 1 — an
    ltx-only request still occupies the worker's host path)."""
    return max(1, len(req.signatures))


def _dominant_bucket(signatures) -> str | None:
    """The batcher bucket most of a request's signatures route to — the
    scheme-affinity token the router compares against the worker's last
    dealt bucket (same vocabulary as SigBatcher.<name>.* gauges)."""
    if not signatures:
        return None
    from .batcher import _BUCKETS
    counts: dict[str, int] = {}
    for key, _sig, _content in signatures:
        b = _BUCKETS.get(key.scheme.scheme_number_id, "host")
        counts[b] = counts.get(b, 0) + 1
    return max(counts, key=counts.get)


class VerifierRequestQueue:
    """Node-side queue with competing-consumer semantics. Attach it to the
    node's messaging; workers announce themselves with WorkerHello.

    Guarded by one lock: control messages arrive on the messaging executor,
    submissions on flow/RPC threads, and overdue-redelivery scans on a timer
    thread. ``redelivery_timeout_s`` is the Artemis-redelivery analog for
    REAL transports, where a killed worker process never sends Goodbye: a
    request outstanding longer than the timeout declares its worker dead and
    requeues everything it held."""

    #: Router slack (capacity-normalized signature weight): workers within
    #: this much of the least-loaded worker stay candidates, so light loads
    #: keep the old round-robin fairness and affinity has room to act.
    ROUTE_SLACK = 4.0
    #: Minimum reported stealable backlog (signatures) before the node asks
    #: a straggler to hand work back — below this a steal round-trip costs
    #: more than it saves.
    STEAL_MIN_WEIGHT = 4
    #: Max requests one StealRequest may pull (the worker additionally caps
    #: at half its backlog, so a steal can never starve the victim).
    STEAL_MAX_ITEMS = 64
    #: A StealRequest with no WorkReturned after this long is forgotten —
    #: the victim crashed (detach requeues its work anyway) or the ack got
    #: lost; either way the victim becomes stealable again.
    STEAL_TIMEOUT_S = 2.0
    #: Smoothing for the per-worker service-rate EWMA (signatures/s,
    #: updated on every acknowledge): high enough to track a worker that
    #: slowed down mid-run, low enough that one lucky tiny batch does not
    #: whipsaw the router.
    EWMA_ALPHA = 0.3

    def __init__(self, network_service, redelivery_timeout_s: float | None = None,
                 metrics: MetricRegistry | None = None):
        self.network_service = network_service
        self.redelivery_timeout_s = redelivery_timeout_s
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._lock = threading.RLock()
        self._workers: list[str] = []
        self._rr = 0
        self._pending: list[VerificationRequest] = []      # no worker yet
        self._outstanding: dict[str, list[VerificationRequest]] = {}
        self._dealt_at: dict[int, tuple[str, float]] = {}  # vid -> (worker, t)
        self._last_activity: dict[str, float] = {}         # worker -> t
        # fleet state: per-worker shard/capacity from the hello, latest load
        # report (+ node arrival time), last-dealt scheme bucket (affinity),
        # and in-flight StealRequests (one per victim at a time)
        self._shards: dict[str, tuple] = {}
        self._capacity: dict[str, int] = {}
        self._reports: dict[str, tuple[WorkerLoadReport, float]] = {}
        self._affinity: dict[str, str] = {}
        self._steal_inflight: dict[str, float] = {}
        self._gauged: set[str] = set()
        # predictive routing state: per-worker completed-signature rate
        # EWMA (from acknowledge timing) + the previous acknowledge time
        self._ewma_rate: dict[str, float] = {}
        self._last_ack: dict[str, float] = {}
        # fleet observability plane: per-request lifecycle timelines
        # (/debug/requests + request.* jlog events) and the worker-metrics
        # federation whose families ride every metrics snapshot
        self.request_log = RequestLog()
        self.federation = FleetMetricsFederation()
        self.metrics.add_collector(self.federation.snapshot)
        self.metrics.gauge("Fleet.WorkersAttached",
                           lambda: len(self._workers))
        network_service.add_message_handler(
            TopicSession(TOPIC_VERIFIER_REQUESTS), self._on_control)

    # -- worker membership ---------------------------------------------------
    def _on_control(self, msg) -> None:
        payload = deserialize(msg.data)
        if isinstance(payload, WorkerHello):
            with self._lock:
                if payload.worker_address not in self._workers:
                    self._workers.append(payload.worker_address)
                    self._outstanding.setdefault(payload.worker_address, [])
                self._last_activity[payload.worker_address] = time.monotonic()
                self._shards[payload.worker_address] = \
                    tuple(payload.device_shard)
                self._capacity[payload.worker_address] = \
                    max(1, int(payload.capacity))
                self._register_worker_gauges(payload.worker_address)
            self._drain()
        elif isinstance(payload, WorkerGoodbye):
            self.detach_worker(payload.worker_address)
        elif isinstance(payload, WorkerLoadReport):
            self._on_load_report(payload)
        elif isinstance(payload, WorkReturned):
            self._on_work_returned(payload)

    def _register_worker_gauges(self, worker: str) -> None:
        """Per-worker fleet gauges on /metrics (CALLER HOLDS THE LOCK).
        Registration is idempotent; a detached worker's gauges read 0
        (capacity is popped on detach) rather than disappearing."""
        if worker in self._gauged:
            return
        self._gauged.add(worker)
        self.metrics.gauge(
            f"Fleet.WorkerCapacity.{worker}",
            lambda w=worker: self._capacity.get(w, 0))
        self.metrics.gauge(
            f"Fleet.WorkerQueueDepth.{worker}",
            lambda w=worker: self._queue_depth_of(w))

    def _queue_depth_of(self, worker: str) -> int:
        """Raw (un-normalized) estimated signature depth of one worker."""
        with self._lock:
            if worker not in self._workers:
                return 0
            return int(self._est_load_locked(worker, time.monotonic())
                       * self._capacity.get(worker, 1))

    def detach_worker(self, worker: str) -> None:
        """Worker death: requeue everything it held (broker redelivery)."""
        with self._lock:
            if worker in self._workers:
                self._workers.remove(worker)
            held = self._outstanding.pop(worker, [])
            for req in held:
                self._dealt_at.pop(req.verification_id, None)
            if held:
                log.info("requeueing %d verifications from dead worker %s",
                         len(held), worker)
            self._pending = held + self._pending
            self._reports.pop(worker, None)
            self._capacity.pop(worker, None)
            self._shards.pop(worker, None)
            self._affinity.pop(worker, None)
            self._steal_inflight.pop(worker, None)
            self._ewma_rate.pop(worker, None)
            self._last_ack.pop(worker, None)
        self.federation.detach(worker)
        for req in held:
            self.request_log.append(req.verification_id, "requeued",
                                    trace=req.trace or None,
                                    reason="worker-detached", worker=worker)
        self._drain()

    # -- load reports + work stealing ----------------------------------------
    def _on_load_report(self, report: WorkerLoadReport) -> None:
        with self._lock:
            worker = report.worker_address
            if worker not in self._workers:
                return   # detached (or never attached): its re-hello re-joins
            now = time.monotonic()
            self._reports[worker] = (report, now)
            self._last_activity[worker] = now
            if report.capacity:
                self._capacity[worker] = max(1, int(report.capacity))
        # piggybacked observability: orphan spans (stolen parked-time) into
        # the span ring, the metric snapshot into the federation
        spans = _unpack_obs(report.spans, [])
        if spans:
            tracer = get_tracer()
            for s in spans:
                tracer.ingest(s)
        metrics = _unpack_obs(report.metrics, {})
        if metrics:
            self.federation.ingest(worker, metrics)
        # a newly idle worker can take pending work right away — and may
        # justify stealing from a straggler's backlog
        self._drain()
        self._maybe_steal()

    def _on_work_returned(self, ret: WorkReturned) -> None:
        """Stolen work coming back from a straggler. Re-deal ONLY requests
        still charged to the victim in _dealt_at — a request the overdue
        scan already requeued (steal racing a requeue) has a live copy
        elsewhere, and re-dealing the stale return would double-verify it
        (harmless for the future — _on_response pops the handle — but a
        wasted batch slot)."""
        victim = ret.worker_address
        with self._lock:
            self._steal_inflight.pop(victim, None)
            self._last_activity[victim] = time.monotonic()
            requeued = []
            still_held = self._outstanding.get(victim)
            for req in ret.requests:
                owner, _t = self._dealt_at.get(req.verification_id,
                                               (None, 0.0))
                if owner != victim or still_held is None:
                    continue
                del self._dealt_at[req.verification_id]
                still_held[:] = [r for r in still_held
                                 if r.verification_id != req.verification_id]
                requeued.append(req)
            self._pending = requeued + self._pending
        if requeued:
            self.metrics.meter("Fleet.Stolen").mark(len(requeued))
            tracer = get_tracer()
            for req in requeued:
                self.request_log.append(req.verification_id, "stolen",
                                        trace=req.trace or None,
                                        victim=victim)
                if req.trace:
                    # node-side steal-hop marker inside the request's own
                    # trace: the stitched tree shows the re-deal boundary
                    tracer.record("verifier.steal_return",
                                  parent=tuple(req.trace), victim=victim)
        self._drain()

    def _maybe_steal(self) -> None:
        """If some worker sits idle while another holds a deep stealable
        backlog, ask the straggler to hand back its tail. One StealRequest
        in flight per victim; the send itself rides the crash-detach path
        (a dead victim's work requeues via detach, not via the steal)."""
        with self._lock:
            if len(self._workers) < 2:
                return
            now = time.monotonic()
            for v, t in list(self._steal_inflight.items()):
                if now - t > self.STEAL_TIMEOUT_S:
                    del self._steal_inflight[v]
            idle = [w for w in self._workers
                    if self._est_load_locked(w, now) <= 0.0]
            if not idle:
                return
            victim, backlog = None, 0
            for w in self._workers:
                if w in idle or w in self._steal_inflight:
                    continue
                rep = self._reports.get(w)
                stealable = rep[0].pending if rep is not None else 0
                if stealable > backlog:
                    victim, backlog = w, stealable
            if victim is None or backlog < self.STEAL_MIN_WEIGHT:
                return
            self._steal_inflight[victim] = now
            thief = idle[0]
        self.metrics.meter("Fleet.Steals").mark()
        steal_trace: tuple = ()
        tracer = get_tracer()
        if tracer.enabled:
            ctx = tracer.record("verifier.steal_request", thief=thief,
                                victim=victim,
                                max_items=self.STEAL_MAX_ITEMS)
            if ctx is not None:
                steal_trace = ctx.as_tuple()
        try:
            if fault_point("oop.deliver", detail=f"->{victim}") == DROP:
                return   # lost steal: the timeout forgets it
            self.network_service.send(
                TopicSession(TOPIC_VERIFIER_REQUESTS),
                serialize(StealRequest(thief, self.STEAL_MAX_ITEMS,
                                       steal_trace)), victim)
        except Exception:
            log.warning("steal request to verifier %s failed; detaching",
                        victim, exc_info=True)
            self.detach_worker(victim)

    # -- load-aware routing --------------------------------------------------
    def _est_load_locked(self, worker: str, now: float) -> float:
        """Estimated queue depth of one worker, normalized by its capacity:
        the last load report's (pending + in-flight) signatures, plus the
        weight of everything dealt to it SINCE that report arrived (the
        report already accounts for earlier deals). No report yet → the
        full outstanding weight."""
        rep = self._reports.get(worker)
        if rep is None:
            base, since = 0, 0.0
        else:
            report, t_rep = rep
            base, since = report.pending + report.in_flight, t_rep
        dealt = sum(_weight(r) for r in self._outstanding.get(worker, ())
                    if self._dealt_at.get(r.verification_id,
                                          (None, 0.0))[1] > since)
        return (base + dealt) / max(1, self._capacity.get(worker, 1))

    def _service_rate_ref_locked(self) -> float | None:
        """Median of the known per-worker service-rate EWMAs — the
        neutral rate assumed for workers with no completion history yet
        (None while NO worker has one: routing falls back to raw load)."""
        rates = sorted(r for r in self._ewma_rate.values() if r > 0.0)
        if not rates:
            return None
        return rates[len(rates) // 2]

    def _pick_worker_locked(self, req: VerificationRequest,
                            now: float) -> tuple[str, str, dict]:
        """The router: workers within ROUTE_SLACK of the least estimated
        load are candidates; among candidates, prefer the ones whose last
        dealt bucket matches this request's dominant scheme (a warm batcher
        queue coalesces same-scheme groups into fuller device batches);
        round-robin breaks the remaining tie so light load keeps the old
        fair dealing.

        PREDICTIVE refinement: once acknowledge timing has produced
        service-rate EWMAs, each worker's load is scaled by (median rate /
        its rate) — i.e. compared by predicted *drain time*, not snapshot
        depth, so a worker that completes twice as fast legitimately
        carries twice the queue before the router balks. Returns ``(pick,
        reason, est-load vector)`` — the decision record the request's
        lifecycle timeline keeps, so a misrouted request is debuggable
        from the loads the router SAW."""
        if len(self._workers) == 1:
            only = self._workers[0]
            return only, "single-worker", {
                only: round(self._est_load_locked(only, now), 2)}
        loads = {w: self._est_load_locked(w, now) for w in self._workers}
        ref = self._service_rate_ref_locked()
        reason = "least-loaded-rr"
        if ref is not None:
            loads = {w: (v * (ref / self._ewma_rate[w])
                         if self._ewma_rate.get(w, 0.0) > 0.0 else v)
                     for w, v in loads.items()}
            reason = "predictive-ewma"
        best = min(loads.values())
        slack = max(self.ROUTE_SLACK, best * 0.25)
        candidates = [w for w in self._workers if loads[w] <= best + slack]
        bucket = _dominant_bucket(req.signatures)
        if bucket is not None:
            affine = [w for w in candidates
                      if self._affinity.get(w) == bucket]
            if affine:
                candidates = affine
                reason = f"affinity:{bucket}"
        pick = candidates[self._rr % len(candidates)]
        self._rr += 1
        if bucket is not None:
            self._affinity[pick] = bucket
        return pick, reason, {w: round(v, 2) for w, v in loads.items()}

    def requeue_overdue(self) -> None:
        """Declare dead any worker that is BOTH holding a request past the
        redelivery timeout AND silent for that long — a busy worker that is
        still acknowledging results (or re-Hello-ing) must not be flagged
        while it works through a deep backlog. VerifierTests.kt
        :73+ semantics for transports without liveness signals."""
        if self.redelivery_timeout_s is None:
            return
        cutoff = time.monotonic() - self.redelivery_timeout_s
        with self._lock:
            overdue = {w for w, t in self._dealt_at.values()
                       if t < cutoff
                       and self._last_activity.get(w, 0.0) < cutoff}
        for worker in overdue:
            log.warning("verifier %s overdue past %.1fs with no activity; "
                        "presuming dead", worker, self.redelivery_timeout_s)
            self.detach_worker(worker)

    @property
    def worker_count(self) -> int:
        with self._lock:
            return len(self._workers)

    # -- dispatch ------------------------------------------------------------
    def submit(self, request: VerificationRequest) -> None:
        with self._lock:
            self._pending.append(request)
            no_worker = not self._workers
        self.request_log.append(request.verification_id, "submitted",
                                trace=request.trace or None,
                                n_sigs=len(request.signatures))
        if no_worker:
            self.request_log.append(request.verification_id, "parked",
                                    trace=request.trace or None,
                                    reason="no-worker-attached")
            log.warning("verification request queued but no verifier is "
                        "attached (reference warns every 10s here)")
        self._drain()

    def acknowledge(self, verification_id: int) -> str | None:
        """Retire a completed request from its worker's outstanding list;
        returns the worker it was charged to (None for an unknown or
        already-acknowledged id). Acknowledge timing feeds the worker's
        service-rate EWMA (signatures completed per second between
        consecutive acknowledges) — the predictive-routing signal."""
        with self._lock:
            worker, _ = self._dealt_at.pop(verification_id, (None, 0.0))
            if worker is None:
                return None
            now = time.monotonic()
            self._last_activity[worker] = now
            held = self._outstanding.get(worker, [])
            weight = next((_weight(r) for r in held
                           if r.verification_id == verification_id), 1)
            self._outstanding[worker] = [
                r for r in held if r.verification_id != verification_id]
            prev_t = self._last_ack.get(worker)
            self._last_ack[worker] = now
            if prev_t is not None:
                inst = weight / max(1e-6, now - prev_t)
                prev = self._ewma_rate.get(worker)
                self._ewma_rate[worker] = (
                    inst if prev is None
                    else self.EWMA_ALPHA * inst
                    + (1.0 - self.EWMA_ALPHA) * prev)
        return worker

    def service_rates(self) -> dict:
        """Per-worker service-rate EWMA snapshot (signatures/s) — the
        controller's and fleet_status's view of the predictive signal."""
        with self._lock:
            return {w: round(r, 2) for w, r in self._ewma_rate.items()}

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending or not self._workers:
                    return
                req = self._pending.pop(0)
                worker, reason, loads = self._pick_worker_locked(
                    req, time.monotonic())
                self._outstanding[worker].append(req)
                self._dealt_at[req.verification_id] = (worker,
                                                       time.monotonic())
            self.request_log.append(req.verification_id, "routed",
                                    trace=req.trace or None, worker=worker,
                                    reason=reason, est_load=loads)
            try:
                # a "drop" rule here models a lost delivery (the worker
                # never sees the request): the redelivery-timeout scan is
                # what recovers it — exactly the path chaos tests pin down
                if fault_point("oop.deliver", detail=f"->{worker}") == DROP:
                    continue
                self.network_service.send(
                    TopicSession(TOPIC_VERIFIER_REQUESTS),
                    serialize(req), worker)
            except Exception:
                # a SEND failure is a live crash signal — detach now and
                # requeue everything the worker held (this request
                # included), instead of waiting out redelivery_timeout_s
                log.warning("delivering to verifier %s failed; detaching",
                            worker, exc_info=True)
                self.detach_worker(worker)
                return   # detach_worker re-drained onto the survivors


class OutOfProcessTransactionVerifierService(TransactionVerifierService):
    """Async verify(ltx) backed by the worker pool
    (OutOfProcessTransactionVerifierService.kt:18-71: nonce → handle map,
    duration/success/failure/in-flight metrics, response consumer)."""

    def __init__(self, network_service, metrics: MetricRegistry | None = None,
                 redelivery_timeout_s: float | None = None,
                 expected_workers: int | None = None,
                 load_report_interval_s: float | None = None,
                 stale_detach_intervals: int | None = None):
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.network_service = network_service
        # expected fleet size (config): /readyz compares attached against it
        # and reports a partial fleet as degraded (fleet_status)
        self.expected_workers = expected_workers
        # the interval workers were configured to report at: fleet_status
        # flags a worker silent past 3× it as stale/degraded (None = the
        # deployment has no report loop, staleness is not judged)
        self.load_report_interval_s = load_report_interval_s
        # after this many CONSECUTIVE stale windows (each 3× the report
        # interval) of total silence, the worker is presumed wedged and
        # crash-detached — its charged work requeues instead of hanging
        # behind a worker that merely LOOKS attached. None = flag-only
        # (the pre-controller behavior).
        self.stale_detach_intervals = stale_detach_intervals
        # the FleetController driving this service, when one is attached
        # (fleet_status / readyz surface its status block)
        self.controller = None
        self.queue = VerifierRequestQueue(
            network_service, redelivery_timeout_s=redelivery_timeout_s,
            metrics=self.metrics)
        self._ids = itertools.count(1)
        self._handles: dict[int, Future] = {}
        self._timers: dict[int, object] = {}
        # vid -> live verifier.oop_submit span: opened at submit, finished
        # EXACTLY ONCE when the final response lands — a request that gets
        # stolen or crash-requeued keeps its span open across the re-deal
        self._spans: dict[int, object] = {}
        self._scanner = None
        self._stopping = threading.Event()
        network_service.add_message_handler(
            TopicSession(TOPIC_VERIFIER_RESPONSES), self._on_response)
        self.metrics.gauge("Verification.InFlightOOP",
                           lambda: len(self._handles))
        # transport-level crash detection: the TCP plane reports abandoned
        # sends via on_send_failure — chain it into an immediate
        # detach-and-requeue so a crashed worker costs one redelivery, not
        # a redelivery_timeout_s wait. Detaching an address that is not a
        # worker is a no-op, so sharing the hook is safe.
        if hasattr(network_service, "on_send_failure"):
            prev_hook = network_service.on_send_failure

            def _send_failed(recipient, _prev=prev_hook):
                if _prev is not None:
                    _prev(recipient)
                self.queue.detach_worker(recipient)

            network_service.on_send_failure = _send_failed
        periods = []
        if redelivery_timeout_s is not None:
            periods.append(redelivery_timeout_s / 2)
        if (stale_detach_intervals is not None
                and load_report_interval_s is not None):
            periods.append(stale_detach_intervals * 3.0
                           * load_report_interval_s / 2)
        if periods:
            self._scan_period_s = min(periods)
            self._scanner = threading.Thread(
                target=self._scan_overdue, daemon=True,
                name="verifier-redelivery")
            self._scanner.start()

    def _scan_overdue(self) -> None:
        while not self._stopping.wait(self._scan_period_s):
            try:
                self.queue.requeue_overdue()
                self.reap_stale_workers()
            except Exception:
                log.exception("overdue-redelivery scan failed")

    def reap_stale_workers(self, now: float | None = None) -> list[str]:
        """Crash-detach workers whose load reports went silent for
        ``stale_detach_intervals`` consecutive stale windows (each 3× the
        report interval — the same window ``fleet_status`` flags at). The
        detach rides the standard crash path, so everything the wedged
        worker held requeues to the survivors and every future still
        resolves exactly once. No-op (returns []) unless both
        ``load_report_interval_s`` and ``stale_detach_intervals`` are
        configured. Called by the redelivery scanner and every controller
        tick; deterministic tests call it by hand with an explicit
        ``now``."""
        interval = self.load_report_interval_s
        n = self.stale_detach_intervals
        if interval is None or n is None:
            return []
        if now is None:
            now = time.monotonic()
        horizon = n * 3.0 * interval
        q = self.queue
        doomed: list[tuple[str, float]] = []
        with q._lock:
            for w in list(q._workers):
                rep = q._reports.get(w)
                seen = rep[1] if rep is not None \
                    else q._last_activity.get(w, now)
                # a worker whose results are still acknowledging is alive
                # even when its reports lag (GIL stalls under host verify
                # delay the report pump long before work actually stops)
                seen = max(seen, q._last_ack.get(w, 0.0))
                if now - seen > horizon:
                    doomed.append((w, now - seen))
        for w, age in doomed:
            jlog(log, "fleet.stale_detach", level=logging.WARNING,
                 worker=w, silent_s=round(age, 3),
                 stale_windows=n, window_s=round(3.0 * interval, 3))
            self.metrics.meter("Fleet.StaleDetached").mark()
            q.detach_worker(w)
        return [w for w, _ in doomed]

    def shutdown(self) -> None:
        self._stopping.set()

    def fleet_status(self) -> dict:
        """Fleet membership + per-worker load for /readyz: attached vs
        expected, each worker's shard / capacity / estimated depth, and
        report freshness — ``last_report_age_s`` per worker, with workers
        silent past 3× the configured load-report interval flagged
        ``stale`` (the whole fleet reads degraded while any worker is:
        the router is flying blind on its load)."""
        q = self.queue
        interval = self.load_report_interval_s
        now = time.monotonic()
        stale: list[str] = []
        with q._lock:
            workers = {}
            for w in q._workers:
                rep = q._reports.get(w)
                age = (now - rep[1]) if rep is not None else None
                # a just-attached worker has no report yet: judge it from
                # its hello (last_activity), not as instantly stale
                seen = rep[1] if rep is not None \
                    else q._last_activity.get(w, now)
                is_stale = (interval is not None
                            and now - seen > 3.0 * interval)
                if is_stale:
                    stale.append(w)
                rate = q._ewma_rate.get(w)
                workers[w] = {
                    "device_shard": list(q._shards.get(w, ())),
                    "capacity": q._capacity.get(w, 1),
                    "queue_depth": q._queue_depth_of(w),
                    "last_report_age_s": (round(age, 3)
                                          if age is not None else None),
                    "service_rate_ewma": (round(rate, 2)
                                          if rate is not None else None),
                    "stale": is_stale}
        out = {"expected": self.expected_workers, "attached": len(workers),
               "workers": workers, "stale": stale}
        if self.stale_detach_intervals is not None:
            out["stale_detach_intervals"] = self.stale_detach_intervals
        out["degraded"] = bool(stale) or (
            self.expected_workers is not None
            and len(workers) < self.expected_workers)
        if self.controller is not None:
            out["controller"] = self.controller.status()
        return out

    @property
    def request_log(self) -> RequestLog:
        """Per-request lifecycle timelines (the /debug/requests payload)."""
        return self.queue.request_log

    def verify_signatures(self, checks) -> Future:
        """Bulk signature-group verification through the fleet: one future
        resolving when every (key, sig, content) check of the group passed
        (None) or with the first failure's message. The request carries no
        transaction — the worker runs only the EC math through its batcher
        (the fleet bench / bulk-backlog path; verify_signed for full
        SignedTransaction semantics)."""
        sigs = tuple((key, sig, content) for key, sig, content in checks)
        return self._submit(VerificationRequest(
            next(self._ids), None, self.network_service.my_address, sigs))

    def verify(self, ltx) -> Future:
        return self._submit(VerificationRequest(
            next(self._ids), ltx, self.network_service.my_address))

    def verify_signed(self, stx, services,
                      check_sufficient_signatures: bool = True,
                      trace_ctx=None) -> Future:
        """Full SignedTransaction verification with the signature EC math on
        the WORKER's device batcher (SignedTransaction.verify semantics,
        SignedTransaction.kt:174-178, shipped over the VerifierApi seam).
        Coverage (missing-signer) checks are cheap and need the stx, so they
        run node-side before dispatch; resolution happens node-side because
        it needs the ServiceHub. The worker hop is TRACED: the submit span's
        context rides the request and the worker's child spans ship back on
        the reply (cross-process stitching)."""
        if check_sufficient_signatures:
            missing = stx.get_missing_signatures()
            if missing:
                from ..core.transactions.signed import (
                    SignaturesMissingException)
                fut: Future = Future()
                fut.set_exception(SignaturesMissingException(
                    missing, [k.to_string_short() for k in missing], stx.id))
                return fut
        ltx = stx.to_ledger_transaction(services)
        sigs = tuple((sig.by, sig.bytes, stx.id.bytes) for sig in stx.sigs)
        return self._submit(
            VerificationRequest(next(self._ids), ltx,
                                self.network_service.my_address, sigs),
            trace_ctx=trace_ctx, tx_id=stx.id.bytes.hex()[:16])

    def _submit(self, request: VerificationRequest, trace_ctx=None,
                **tags) -> Future:
        # a LIVE span per request, finished exactly once in _on_response:
        # its duration covers the whole fleet round-trip, including any
        # steal hops and crash-requeues in between. With tracing off this
        # is the shared no-op span and the request ships without a context.
        span = get_tracer().span("verifier.oop_submit", parent=trace_ctx,
                                 n_sigs=len(request.signatures), **tags)
        ctx = span.context()
        if ctx is not None:
            request = dc_replace(request, trace=ctx.as_tuple())
            self._spans[request.verification_id] = span
        fut: Future = Future()
        self._handles[request.verification_id] = fut
        timer = self.metrics.timer("Verification.Duration")
        timer.__enter__()
        self._timers[request.verification_id] = timer
        self.queue.submit(request)
        return fut

    def _on_response(self, msg) -> None:
        resp: VerificationResponse = deserialize(msg.data)
        fut = self._handles.pop(resp.verification_id, None)
        timer = self._timers.pop(resp.verification_id, None)
        if timer is not None:
            timer.__exit__(None, None, None)
        if fut is None:
            return   # duplicate reply: the first copy finished the span too
        worker = self.queue.acknowledge(resp.verification_id)
        # stitch: worker-side spans from the reply into the node's ring
        tracer = get_tracer()
        dispatched = None
        for s in _unpack_obs(resp.spans, []):
            tracer.ingest(s)
            if isinstance(s, dict) and s.get("name") == "worker.device_dispatch":
                dispatched = s
        span = self._spans.pop(resp.verification_id, None)
        trace = None
        if span is not None:
            trace = span.context().as_tuple()
            if worker is not None:
                span.set_tag("worker", worker)
            if resp.error_message is not None:
                span.set_tag("error", resp.error_message)
            span.finish()
        rlog = self.queue.request_log
        if dispatched is not None:
            tags = dispatched.get("tags", {})
            rlog.append(resp.verification_id, "dispatched", trace=trace,
                        worker=tags.get("worker"),
                        n_sigs=tags.get("n_sigs"),
                        duration_s=round(dispatched.get("duration_s", 0.0),
                                         6))
        rlog.append(resp.verification_id, "resolved", trace=trace,
                    ok=resp.error_message is None, worker=worker)
        if resp.error_message is None:
            self.metrics.meter("Verification.Success").mark()
            fut.set_result(None)
        else:
            self.metrics.meter("Verification.Failure").mark()
            from ..core.contracts.exceptions import TransactionVerificationException
            fut.set_exception(
                TransactionVerificationException(None, resp.error_message))


class VerifierWorker:
    """The worker half (Verifier.kt:42-79): attach, consume, verify, reply.
    Stateless — run N of them against one queue; kill any mid-run and its
    work redistributes.

    Device path: requests carrying ``signatures`` run their EC checks
    through this worker's ``SignatureBatcher`` on ``device`` (default
    "cuda"; without a batcher given, a worker whose device is the card
    raises RuntimeError at construction where CUDA is absent — pass
    ``device="cpu"`` for the plain PyTorch kernels) — the message
    handler parks them on a STEALABLE BACKLOG and a feeder admits at most
    ``max_inflight_groups`` groups into the batcher at a time, so
    consecutive requests' signatures still coalesce into one device batch
    while everything beyond the in-flight window stays reclaimable: a
    StealRequest pops the backlog's tail (LIFO — the feeder drains the
    head) and hands it back to the node for re-dealing. The default
    ``max_inflight_groups=None`` disables the holdback (everything goes
    straight to the batcher, preserving the pre-fleet batch shapes); fleet
    deployments set a finite window so a
    straggler keeps a stealable tail. Requests without signatures keep the
    reference's synchronous host semantics (deterministic for the
    manually-pumped test bus)."""

    def __init__(self, network_service, queue_address: str,
                 batcher=None, use_device: bool = True, pool_workers: int = 4,
                 hello_interval_s: float | None = None,
                 device_shard: tuple = (), capacity: int | None = None,
                 load_report_interval_s: float | None = None,
                 max_inflight_groups: int | None = None, device="cuda"):
        self.network_service = network_service
        self.queue_address = queue_address
        self.verified_count = 0
        self.processed_sig_count = 0   # signatures through the batcher
        self.last_completion_t = None  # monotonic t of last device group
        self._count_lock = threading.Lock()
        self.use_device = use_device
        # the device the lazily built batcher runs on; resolved now when it
        # will launch kernels, so a worker without its card fails here
        # instead of failing its first request
        self.device = (resolve_device(device) if batcher is None and use_device
                       else device)
        self.device_shard = tuple(device_shard)
        self.capacity = (capacity if capacity is not None
                         else max(1, len(self.device_shard)))
        self.max_inflight_groups = max_inflight_groups
        self._backlog: "deque[VerificationRequest]" = deque()
        self._backlog_lock = threading.Lock()
        # trace stitching state (only populated for requests that ARRIVE
        # carrying a trace context, i.e. node tracing is on): arrival wall
        # time per vid feeds the backlog-wait span; the outbox holds
        # finished spans with no reply to ride (worker.stolen), drained
        # onto the next load report
        self._arrival: dict[int, float] = {}
        self._span_outbox: "deque[dict]" = deque(maxlen=512)
        self._inflight_groups = 0
        self._inflight_sigs = 0
        self._report_enabled = load_report_interval_s is not None
        self._batcher = batcher            # created lazily if None
        self._pool = None
        self._registration = network_service.add_message_handler(
            TopicSession(TOPIC_VERIFIER_REQUESTS), self._on_request)
        self._alive = True
        self._pool_workers = pool_workers
        self._hello()
        if hello_interval_s is not None:
            # periodic re-attach (consumer keep-alive): a worker the queue
            # presumed dead during a long kernel build re-joins on the
            # next Hello — attachment is idempotent on the queue side
            def _rehello():
                while self._alive:
                    time.sleep(hello_interval_s)
                    if self._alive:
                        try:
                            self._hello()
                        except Exception:
                            # the keep-alive thread must survive a flaky
                            # queue link — the next interval retries anyway
                            log.warning("re-hello to %s failed",
                                        self.queue_address, exc_info=True)
            threading.Thread(target=_rehello, daemon=True,
                             name="verifier-hello").start()
        if load_report_interval_s is not None:
            def _report_loop():
                while self._alive:
                    time.sleep(load_report_interval_s)
                    if self._alive:
                        try:
                            self.send_load_report()
                        except Exception:
                            log.warning("load report to %s failed",
                                        self.queue_address, exc_info=True)
            threading.Thread(target=_report_loop, daemon=True,
                             name="verifier-load-report").start()

    def _hello(self) -> None:
        retry.retry_call(
            lambda: self.network_service.send(
                TopicSession(TOPIC_VERIFIER_REQUESTS),
                serialize(WorkerHello(self.network_service.my_address,
                                      self.device_shard, self.capacity)),
                self.queue_address),
            site="oop.hello",
            policy=retry.RetryPolicy(base_s=0.05, cap_s=0.5, max_attempts=4),
            retry_on=(OSError, ConnectionError, LookupError))

    def send_load_report(self) -> None:
        """Ship the live load picture to the node's router: stealable
        backlog weight + batcher in-flight signatures + the per-scheme
        queue-depth gauges. Called on the report interval, on going idle,
        and by hand from deterministic tests.

        Federation piggyback: the worker's full metric snapshot rides each
        report (the node re-exports it under a worker label), along with
        any orphan spans waiting in the outbox."""
        with self._backlog_lock:
            pending = sum(_weight(r) for r in self._backlog)
            in_flight = self._inflight_sigs
        depths: tuple = ()
        metrics: str = ""
        if self._batcher is not None:
            try:
                depths = tuple(sorted(self._batcher.queue_depths().items()))
            except Exception:
                depths = ()
            try:
                metrics = _pack_obs(self._batcher.metrics.snapshot())
            except Exception:
                metrics = ""
        spans: list = []
        while len(spans) < 128:
            try:
                spans.append(self._span_outbox.popleft())
            except IndexError:
                break
        try:
            self.network_service.send(
                TopicSession(TOPIC_VERIFIER_REQUESTS),
                serialize(WorkerLoadReport(
                    self.network_service.my_address, pending, in_flight,
                    depths, self.capacity, _pack_obs(spans), metrics)),
                self.queue_address)
        except Exception:
            # a lost report loses its piggybacked spans; put them back so
            # the next report retries (bounded — the deque cap still holds)
            self._span_outbox.extendleft(reversed(spans))
            raise

    @property
    def batcher(self):
        if self._batcher is None:
            from .batcher import SignatureBatcher
            self._batcher = SignatureBatcher(use_device=self.use_device,
                                             device=self.device)
        return self._batcher

    def _on_request(self, msg) -> None:
        if not self._alive:
            return
        payload = deserialize(msg.data)
        if isinstance(payload, StealRequest):
            self._on_steal(payload)
            return
        req: VerificationRequest = payload
        if not req.signatures:
            if req.trace:
                t0_wall, t0 = time.time(), time.perf_counter()
                error = self._verify_host(req)
                span = make_span_dict(
                    "worker.host_verify", tuple(req.trace), t0_wall,
                    time.perf_counter() - t0, **self._span_tags())
                self._reply(req, error, spans=(span,))
            else:
                self._reply(req, self._verify_host(req))
            return
        # device path: park on the stealable backlog; the feeder admits up
        # to max_inflight_groups into the batcher (non-blocking)
        with self._backlog_lock:
            self._backlog.append(req)
            if req.trace:
                self._arrival[req.verification_id] = time.time()
        self._feed()

    def _span_tags(self) -> dict:
        """Identity tags every worker-side span carries."""
        tags = {"worker": self.network_service.my_address}
        if self.device_shard:
            tags["device_shard"] = list(self.device_shard)
        return tags

    def _feed(self) -> None:
        """Admit backlog head-first into the batcher while the in-flight
        window has room. Everything still on the backlog is stealable.

        Traced requests grow a per-request span accumulator here: the
        backlog-wait span closes on admission, a device-dispatch span opens
        (its context handed to the batcher so in-process batcher spans nest
        under it), and _complete_device finishes + ships the lot."""
        while True:
            with self._backlog_lock:
                if (not self._alive or not self._backlog
                        or (self.max_inflight_groups is not None
                            and self._inflight_groups
                            >= self.max_inflight_groups)):
                    return
                req = self._backlog.popleft()
                self._inflight_groups += 1
                self._inflight_sigs += len(req.signatures)
                arrived = self._arrival.pop(req.verification_id, None) \
                    if req.trace else None
            rt = None
            ctx = None
            if req.trace:
                now_wall = time.time()
                rt = {"spans": [], "t0": time.perf_counter()}
                if arrived is not None:
                    rt["spans"].append(make_span_dict(
                        "worker.backlog_wait", tuple(req.trace), arrived,
                        now_wall - arrived, **self._span_tags()))
                rt["dispatch"] = make_span_dict(
                    "worker.device_dispatch", tuple(req.trace), now_wall,
                    0.0, n_sigs=len(req.signatures), **self._span_tags())
                ctx = (rt["dispatch"]["trace_id"],
                       rt["dispatch"]["span_id"])
            try:
                group_future = self.batcher.submit_group(req.signatures,
                                                         ctx=ctx)
            except Exception as e:
                with self._backlog_lock:
                    self._inflight_groups -= 1
                    self._inflight_sigs -= len(req.signatures)
                self._reply(req, str(e))
                continue
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self._pool_workers,
                    thread_name_prefix="verifier-worker")
            try:
                self._pool.submit(self._complete_device, req, group_future,
                                  rt)
            except RuntimeError:
                # stopped while this request was decoded on the pump
                # thread: a crashed worker drops it (the node requeues
                # what it charged us), and the pump survives
                if self._alive:
                    raise
                return

    def _on_steal(self, steal: StealRequest) -> None:
        """Hand the backlog's TAIL back to the node (the feeder eats the
        head — LIFO stealing keeps the oldest work local where its scheme
        affinity already warmed the batcher). At most half the backlog goes;
        an empty return still acks the steal."""
        taken: list[VerificationRequest] = []
        now_wall = time.time()
        with self._backlog_lock:
            limit = min(steal.max_items, (len(self._backlog) + 1) // 2)
            for _ in range(limit):
                taken.append(self._backlog.pop())
            arrivals = {r.verification_id:
                        self._arrival.pop(r.verification_id, now_wall)
                        for r in taken if r.trace}
        taken.reverse()
        try:
            self.network_service.send(
                TopicSession(TOPIC_VERIFIER_REQUESTS),
                serialize(WorkReturned(self.network_service.my_address,
                                       tuple(taken))),
                self.queue_address)
        except Exception:
            # the node link died mid-steal: keep the work — our requests are
            # still charged to us, so the node's detach path re-deals them
            with self._backlog_lock:
                self._backlog.extendleft(reversed(taken))
                for vid, t in arrivals.items():
                    self._arrival[vid] = t
            log.warning("returning stolen work to %s failed",
                        self.queue_address, exc_info=True)
            return
        # the stolen requests never get a reply from US — their parked-time
        # spans ride the next load report instead, tagged with the steal's
        # own trace id as a cross-link
        for r in taken:
            if not r.trace:
                continue
            t_arr = arrivals.get(r.verification_id, now_wall)
            self._span_outbox.append(make_span_dict(
                "worker.stolen", tuple(r.trace), t_arr, now_wall - t_arr,
                thief=steal.thief_address,
                steal_trace=steal.trace[0] if steal.trace else None,
                **self._span_tags()))

    def _verify_host(self, req: VerificationRequest) -> str | None:
        if req.transaction is None:
            return None   # pure signature group (verify_signatures)
        try:
            req.transaction.verify()
            return None
        except Exception as e:
            return str(e)

    def _complete_device(self, req: VerificationRequest,
                         group_future, rt=None) -> None:
        error = None
        try:
            verdicts = group_future.result()
            if rt is not None:
                self._finish_dispatch_span(rt)
            for (key, _sig, _content), ok in zip(req.signatures, verdicts):
                if not ok:
                    error = (f"Signature by {key.to_string_short()} did not "
                             f"verify")
                    break
            if error is None:
                if rt is not None:
                    h_wall, h0 = time.time(), time.perf_counter()
                    error = self._verify_host(req)
                    rt["spans"].append(make_span_dict(
                        "worker.host_verify", tuple(req.trace), h_wall,
                        time.perf_counter() - h0, **self._span_tags()))
                else:
                    error = self._verify_host(req)
        except Exception as e:
            error = str(e)
            if rt is not None:
                self._finish_dispatch_span(rt, error=error)
        self._reply(req, error,
                    spans=tuple(rt["spans"]) if rt is not None else ())
        with self._backlog_lock:
            self._inflight_groups -= 1
            self._inflight_sigs -= len(req.signatures)
            self.processed_sig_count += len(req.signatures)
            # busy-time marker: the fleet bench's scaling-efficiency metric
            # is mean(last_completion - t0) / makespan across workers
            self.last_completion_t = time.monotonic()
        self._feed()
        with self._backlog_lock:
            idle = not self._backlog and self._inflight_groups == 0
        if idle and self._report_enabled and self._alive:
            # immediate idle ping: the router learns this worker drained
            # without waiting out the report interval — the steal trigger
            try:
                self.send_load_report()
            except Exception:
                log.warning("idle load report failed", exc_info=True)

    def _finish_dispatch_span(self, rt: dict, error: str | None = None
                              ) -> None:
        """Close the device-dispatch span (duration = submit→result) and
        tag it with any breaker that was open when the group resolved — the
        breaker-reroute marker for host-fallback diagnosis."""
        disp = rt.pop("dispatch", None)
        if disp is None:
            return
        disp["duration_s"] = time.perf_counter() - rt["t0"]
        if error is not None:
            disp["tags"]["error"] = error
        try:
            status = getattr(self._batcher, "breaker_status", None)
            if status is not None:
                rerouted = sorted(n for n, st in status().items()
                                  if st.get("state") != "closed")
                if rerouted:
                    disp["tags"]["breaker_rerouted"] = rerouted
        except Exception:
            pass
        rt["spans"].append(disp)

    def _reply(self, req: VerificationRequest, error: str | None,
               spans: tuple = ()) -> None:
        if not self._alive:
            return   # killed mid-verify: the node requeues our outstanding work
        # a "drop" rule here models a worker crashing BETWEEN finishing the
        # verify and sending the response — the node must redeliver
        if fault_point(
                "oop.reply",
                detail=f"{self.network_service.my_address}"
                       f"->{req.response_address}") == DROP:
            return
        with self._count_lock:   # replies run on the completion pool's threads
            self.verified_count += 1
        self.network_service.send(
            TopicSession(TOPIC_VERIFIER_RESPONSES),
            serialize(VerificationResponse(req.verification_id, error,
                                           _pack_obs(list(spans)))),
            req.response_address)

    def stop(self, announce: bool = True) -> None:
        """Graceful stop announces Goodbye; a crash (announce=False) relies on
        the node detaching the worker when it notices (detach_worker)."""
        self._alive = False
        self.network_service.remove_message_handler(self._registration)
        if announce:
            self.network_service.send(
                TopicSession(TOPIC_VERIFIER_REQUESTS),
                serialize(WorkerGoodbye(self.network_service.my_address)),
                self.queue_address)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._batcher is not None:
            self._batcher.close()
