"""Cross-transaction signature batching onto the port's CUDA kernels.

Port of corda_tpu/verifier/batcher.py. Many flows/transactions submit
(key, signature, content) checks concurrently; a planner thread drains them,
buckets by scheme, and runs ONE batched kernel per device-scheme bucket.

Pipeline shape (continuous batching): the planner cuts every dispatchable
batch the per-scheme in-flight windows allow and never blocks on one —
batch N+1's host prep starts on the prep pool the moment a window slot
frees, while batch N still executes on the card. Device waits + future
resolution run on a separate finish pool; each in-flight slot releases at
resolution, re-waking the planner. Backpressure is per scheme
(MAX_IN_FLIGHT windows), and bulk admission can be capped (``max_pending``)
so producers block instead of the queue growing without bound.

Latency/throughput trade, per latency class: ``bulk`` submissions coalesce
toward ``max_batch`` (cut at power-of-two bucket-ladder rungs) with
``max_latency_s`` as the deadline; ``interactive`` submissions flush into
small buckets on the much shorter ``interactive_latency_s`` deadline, with
one priority in-flight slot so bulk pressure cannot starve them.

Differences from the JAX batcher: ``device`` is a ``torch.device`` (default
``"cuda"``, which raises when CUDA is absent) and every launch runs on a
CUDA stream the batcher owns, and the three kernels are built when a CUDA
batcher is made; a kernel that does not build or launch (``KernelError``)
fails the batch's futures instead of falling back to the host, while the
host fallback and breakers still answer every other dispatch failure;
``mesh=`` takes a ``corda_tpu_torch.parallel.Mesh`` (an ordered list of
devices, one CUDA stream a shard) and shards every device batch over it,
resolving it synchronously as the reference does; and with
CORDA_TPU_PROFILE_DIR set, each
device dispatch is a ``torch.profiler.record_function`` range of a profile
exported as a Chrome trace into that directory on ``close()``.
"""
from __future__ import annotations

import hashlib
import logging
import os
import threading
import time as _time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

import torch

from ..core.crypto import ecmath
from ..core.crypto.keys import (
    PublicKey, sec1_decompress_cached, sec1_pub_row_cached)
from ..core.crypto.schemes import (
    ECDSA_SECP256K1_SHA256, ECDSA_SECP256R1_SHA256, EDDSA_ED25519_SHA512)
from ..core.crypto.signatures import Crypto
from ..device import DEFAULT_DEVICE, resolve_device
from ..observability import get_profiler, get_tracer, jlog
from .._build import KernelError
from ..ops import ed25519 as ed_ops
from ..ops import scalarprep as sp
from ..ops import weierstrass as wc_ops
from ..utils.faults import fault_point
from ..utils.metrics import MetricRegistry

_log = logging.getLogger(__name__)

_ED = EDDSA_ED25519_SHA512.scheme_number_id
_K1 = ECDSA_SECP256K1_SHA256.scheme_number_id
_R1 = ECDSA_SECP256R1_SHA256.scheme_number_id

#: Schemes with a device kernel, by scheme number (the reference's three
#: buckets: kernels B2, B3 and B4); every other scheme's checks go to the
#: "host" queue at enqueue time.
_BUCKETS = {_ED: "ed25519", _K1: "secp256k1", _R1: "secp256r1"}
_DEVICE_SCHEMES = tuple(_BUCKETS.values())

#: Admission-control latency classes: ``interactive`` submissions flush on
#: a short deadline into small buckets (a lone tx's signatures must not
#: wait behind a coalescing megabatch); ``bulk`` coalesces toward
#: full-occupancy megabatches on the ``max_latency_s`` deadline.
INTERACTIVE = "interactive"
BULK = "bulk"


class _SchemeQueue:
    """One scheme's pending work, split by latency class. ``t_first`` /
    ``t_last`` (per class) drive the deadline and stall-tick flush
    decisions in the planner — t_first is stamped on the empty→nonempty
    transition (the deadline anchor), t_last on every enqueue (a stalled
    class flushes early instead of paying the whole linger)."""

    __slots__ = ("interactive", "bulk", "t_first", "t_last")

    def __init__(self):
        self.interactive: list[_Pending] = []
        self.bulk: list[_Pending] = []
        self.t_first: dict[str, float] = {}
        self.t_last: dict[str, float] = {}

    def add(self, latency_class: str, pendings, now: float) -> None:
        lst = self.interactive if latency_class == INTERACTIVE else self.bulk
        if not lst:
            self.t_first[latency_class] = now
        self.t_last[latency_class] = now
        lst.extend(pendings)

    def drain_all(self) -> list:
        items = self.interactive + self.bulk
        self.interactive = []
        self.bulk = []
        return items

    def __len__(self) -> int:
        return len(self.interactive) + len(self.bulk)


def _tid(bctx) -> str | None:
    """Exemplar trace id for the flush's histogram samples (None when the
    batch is untraced — the histogram just skips the exemplar)."""
    return getattr(bctx, "trace_id", None)


class _Group:
    """Shared accumulator for submit_group: ONE future resolves to the
    verdict list (per-item Future objects measured ~25µs each end-to-end —
    real money at 32k-item service batches)."""

    __slots__ = ("future", "results", "remaining", "lock")

    def __init__(self, n: int):
        self.future = Future()
        self.results = [False] * n
        self.remaining = n
        self.lock = threading.Lock()


@dataclass
class _Pending:
    key: PublicKey
    signature: bytes
    content: bytes
    future: Future | None = None
    group: "_Group | None" = None
    index: int = 0
    # tracing (observability.tracing): the submitter's SpanContext, carried
    # across the dispatcher/prep/finish threads; t_enq is the wall-clock
    # enqueue time for the retroactive enqueue-wait span. Both stay at
    # their defaults when tracing is off — zero cost.
    ctx: object = None
    t_enq: float = 0.0


class _null_ctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class DeviceCircuitBreaker:
    """Per-scheme breaker over the device dispatch path.

    N *consecutive* device-batch failures trip CLOSED → OPEN: further
    batches of that scheme route straight to the host verify path (their
    futures still resolve — degradation, never loss). After
    ``cooldown_s`` the next batch is admitted as a HALF_OPEN probe:
    exactly one batch tries the device while the rest keep to host. A
    probe success closes the breaker; a probe failure re-opens it and
    restarts the cooldown. State and trip counts surface as registry
    gauges (``Breaker.State.<scheme>``, ``Breaker.Trips``), ``/readyz``
    degraded status, and ``breaker.*`` structured log events."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, scheme: str, threshold: int = 3,
                 cooldown_s: float = 5.0, clock=_time.monotonic,
                 on_trip=None):
        self.scheme = scheme
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock           # injectable: chaos tests step time
        self.on_trip = on_trip       # marks the registry trip meters
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.trips = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._lock = threading.Lock()

    def state_code(self) -> int:
        return self._STATE_CODE[self.state]

    def allow(self) -> bool:
        """May the next batch try the device? OPEN past its cooldown
        admits exactly one half-open probe; everything else while not
        CLOSED routes to host."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN and \
                    self.clock() - self._opened_at >= self.cooldown_s:
                self.state = self.HALF_OPEN
                self._probe_inflight = True
                jlog(_log, "breaker.half_open", scheme=self.scheme)
                return True
            if self.state == self.HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            reopened = self.state != self.CLOSED
            self.state = self.CLOSED
            self.consecutive_failures = 0
            self._probe_inflight = False
        if reopened:
            jlog(_log, "breaker.close", scheme=self.scheme)

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if self.state == self.HALF_OPEN:
                # the probe failed: re-open and restart the cooldown
                self.state = self.OPEN
                self._opened_at = self.clock()
                self._probe_inflight = False
                jlog(_log, "breaker.reopen", scheme=self.scheme,
                     consecutive_failures=self.consecutive_failures)
                return
            if self.state == self.CLOSED and \
                    self.consecutive_failures >= self.threshold:
                self.state = self.OPEN
                self._opened_at = self.clock()
                self.trips += 1
                jlog(_log, "breaker.open", scheme=self.scheme,
                     consecutive_failures=self.consecutive_failures,
                     trips=self.trips)
                if self.on_trip is not None:
                    self.on_trip(self.scheme)

    def status(self) -> dict:
        return {"state": self.state, "trips": self.trips,
                "consecutive_failures": self.consecutive_failures}


class SignatureBatcher:
    """Accepts individual signature checks, returns Future[bool] verdicts,
    dispatches device-batched kernels per scheme from a background thread.

    Batch-size policy: the cap and the host crossover keep the JAX
    package's defaults (32k and 192, chosen there for its TPU; the port's
    own H100 numbers are in PERF.md) and the drain adapts to load — kernels
    pad to power-of-two buckets so the set of launched shapes stays small.
    Batches *below* ``host_crossover`` route to the host verify path
    instead, which keeps a lone submit off the device launch path. Below the
    crossover the dispatcher also skips the linger wait, so a lone submit
    is not taxed ``max_latency_s`` for a batch that was never coming."""

    #: Prep-pool width: one worker per device scheme, so a mixed drain preps
    #: ed25519 + k1 + r1 concurrently. The heavy prep (sm_*_prep, hashing,
    #: numpy packing) releases the GIL in C, so the workers genuinely
    #: overlap; same width for the finish pool (device waits are
    #: GIL-releasing too).
    PREP_WORKERS = 3

    #: Default bucket-ladder floor: below this the kernels' pow2 padding
    #: already keeps the shape set small, and the host crossover eats most
    #: sub-floor batches anyway.
    LADDER_FLOOR = 256

    def __init__(self, max_batch: int = 32768, max_latency_s: float = 0.005,
                 metrics: MetricRegistry | None = None, use_device: bool = True,
                 host_crossover: int = 192, mesh=None,
                 device=None,
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 5.0,
                 breaker_clock=_time.monotonic,
                 interactive_latency_s: float = 0.002,
                 interactive_batch: int = 1024,
                 bucket_ladder=None, max_pending: int | None = None):
        self.max_batch = max_batch
        self.max_latency_s = max_latency_s
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.use_device = use_device
        self.host_crossover = host_crossover
        # latency classes (admission control): interactive flushes on its
        # own short deadline in small buckets with one priority in-flight
        # slot; bulk coalesces toward max_batch on max_latency_s
        self.interactive_latency_s = interactive_latency_s
        self.interactive_batch = interactive_batch
        # bulk admission cap: enqueues block while this many bulk items are
        # queued (interactive is always admitted) — backpressure lands on
        # the bulk producers instead of growing the queue without bound
        self.max_pending = max_pending
        # degradation-ladder state (verifier/controller.py): each rung is
        # reversible, saving whatever it overrides so revert is exact
        self._shed_active = False
        self._saved_max_pending: int | None = None
        self._ladder_shrunk = False
        self._saved_ladders: tuple | None = None
        self._force_host_interactive = False
        # shape-bucketed batch sizes: bulk drains are cut at power-of-two
        # ladder rungs so launches see a fixed shape set across
        # varying arrival rates. None → default ladder for every scheme; a
        # sequence → that ladder for every scheme; a dict → per-scheme
        # (see ladder_from_occupancy for tuning from flight-recorder stats)
        self._default_ladder = self._pow2_ladder(self.LADDER_FLOOR, max_batch)
        if bucket_ladder is None:
            self.bucket_ladder: dict[str, tuple] = {}
        elif isinstance(bucket_ladder, dict):
            self.bucket_ladder = {k: tuple(v) for k, v in bucket_ladder.items()}
        else:
            self._default_ladder = tuple(bucket_ladder)
            self.bucket_ladder = {}
        # a parallel.Mesh shards every device batch over its devices (one
        # stream a shard, owned by the mesh) — one node's batcher drives
        # every card; mutually exclusive with device=, which pins one
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both")
        self.mesh = mesh
        # the device every launch of this batcher runs on (default "cuda";
        # raises when CUDA is absent — pass device="cpu" for the plain
        # PyTorch path; with a mesh, its first device). Single-device CUDA
        # launches go to a stream the batcher owns.
        if mesh is not None:
            self.device = mesh.devices[0]
            self._stream = None
        else:
            self.device = resolve_device(
                device if device is not None else DEFAULT_DEVICE)
            self._stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        on_card = (any(d.type == "cuda" for d in mesh.devices)
                   if mesh is not None else self.device.type == "cuda")
        if self.use_device and on_card:
            # build (or load) the three kernels now: a missing compiler or
            # a refused source raises BuildError here, not at the first batch
            ed_ops.load_kernel()
            wc_ops.load_kernels()
        self._lock = threading.Condition()
        self._queues: dict[str, _SchemeQueue] = {
            name: _SchemeQueue() for name in (*_DEVICE_SCHEMES, "host")}
        # per-scheme in-flight batch counts (prep start → resolution): the
        # planner stops cutting plans for a scheme at its window, and each
        # plan carries an idempotent release that decrements + re-wakes the
        # planner — continuous dispatch, no drain barrier.
        self._inflight_n: dict[str, int] = {name: 0 for name in self._queues}
        self._closed = False
        self._prep_pool: ThreadPoolExecutor | None = None
        self._finish_pool: ThreadPoolExecutor | None = None
        self._pool_lock = threading.Lock()
        self._prep_active = 0
        # CORDA_TPU_PROFILE_DIR: one torch.profiler session over the
        # batcher's life, covering every thread (the dispatches run on the
        # prep pool), exported by close()
        self._profile_dir = os.environ.get("CORDA_TPU_PROFILE_DIR")
        self._profiler = None
        self._batch_seq = 0
        self._profile_lock = threading.Lock()
        if self._profile_dir is not None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=acts,
                experimental_config=torch.profiler._ExperimentalConfig(
                    profile_all_threads=True))
            self._profiler.start()
        for name in self._queues:
            # per-scheme observability: queue depth (pending drain) and
            # in-flight window occupancy (batches between prep + resolve)
            self.metrics.gauge(f"SigBatcher.{name}.QueueDepth",
                               lambda n=name: len(self._queues[n]))
            self.metrics.gauge(f"SigBatcher.{name}.InFlight",
                               lambda n=name: self._inflight_n[n])
        # device circuit breakers, one per device scheme: N consecutive
        # dispatch failures degrade that scheme to host verification (the
        # futures still resolve); a half-open probe restores it. Created
        # even with use_device=False so the gauge families are always
        # present — they just never trip.
        self.metrics.meter("Breaker.Trips")
        self._breakers: dict[str, DeviceCircuitBreaker] = {}
        for name in _DEVICE_SCHEMES:
            self._breakers[name] = DeviceCircuitBreaker(
                name, threshold=breaker_threshold,
                cooldown_s=breaker_cooldown_s, clock=breaker_clock,
                on_trip=self._on_breaker_trip)
            self.metrics.gauge(
                f"Breaker.State.{name}",
                lambda n=name: self._breakers[n].state_code())
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sig-batcher")
        self._thread.start()

    def _on_breaker_trip(self, scheme: str) -> None:
        self.metrics.meter("Breaker.Trips").mark()
        self.metrics.meter(f"Breaker.Trips.{scheme}").mark()

    def breaker_status(self) -> dict:
        """Per-scheme breaker state for /readyz and bench assertions."""
        return {name: b.status() for name, b in self._breakers.items()}

    def queue_depths(self) -> dict:
        """Per-scheme pending depth (signatures queued, not yet planned) —
        the load snapshot the OOP worker ships to the node's router in its
        WorkerLoadReport (same numbers as the SigBatcher.<name>.QueueDepth
        gauges, one lock round)."""
        with self._lock:
            return {name: len(q) for name, q in self._queues.items()}

    # -- bucket ladder -------------------------------------------------------
    @staticmethod
    def _pow2_ladder(floor: int, cap: int) -> tuple:
        """Power-of-two rungs from ``floor`` up to ``cap`` (cap included
        even when it is not a power of two — it is the one extra shape the
        megabatch path already compiles)."""
        if cap <= floor:
            return (cap,)
        rungs = []
        r = floor
        while r <= cap:
            rungs.append(r)
            r *= 2
        if rungs[-1] != cap:
            rungs.append(cap)
        return tuple(rungs)

    def _ladder_for(self, bucket: str) -> tuple:
        return self.bucket_ladder.get(bucket, self._default_ladder)

    def _ladder_cut(self, bucket: str, depth: int) -> int:
        """Bulk drain size for ``depth`` queued items: the largest ladder
        rung that fits, so steady-state flushes recur on a fixed shape set.
        Sub-floor tails dispatch at raw depth — the kernels pad those to
        power-of-two buckets, so the launched shape set stays bounded
        either way."""
        cut = 0
        for rung in self._ladder_for(bucket):
            if rung <= depth:
                cut = rung
        if cut == 0:
            cut = depth
        return min(cut, self.max_batch, depth)

    # -- degradation ladder hooks (verifier/controller.py) -------------------
    def shed_bulk(self, on: bool, cap: int | None = None) -> None:
        """Controller rung 1: clamp bulk admission hard. Bulk producers
        block at a small cap (default ``interactive_batch``) so offered
        throughput load backs off while interactive traffic — always
        admitted — keeps its latency. Reversal restores the configured
        ``max_pending`` exactly (including None = uncapped)."""
        with self._lock:
            if on and not self._shed_active:
                self._shed_active = True
                self._saved_max_pending = self.max_pending
                self.max_pending = (cap if cap is not None
                                    else self.interactive_batch)
            elif not on and self._shed_active:
                self._shed_active = False
                self.max_pending = self._saved_max_pending
                self._saved_max_pending = None
            self._lock.notify_all()

    def shrink_ladder(self, on: bool) -> None:
        """Controller rung 2: collapse the bulk batch ladder to its floor
        so drains cut small, low-latency batches — queueing delay behind a
        coalescing megabatch is what burns the latency SLO under stress.
        The pre-shrink ladders (default + per-scheme) are restored on
        reversal."""
        with self._lock:
            if on and not self._ladder_shrunk:
                self._ladder_shrunk = True
                self._saved_ladders = (self._default_ladder,
                                       self.bucket_ladder)
                self._default_ladder = (min(self.LADDER_FLOOR,
                                            self.max_batch),)
                self.bucket_ladder = {}
            elif not on and self._ladder_shrunk:
                self._ladder_shrunk = False
                self._default_ladder, self.bucket_ladder = \
                    self._saved_ladders
                self._saved_ladders = None
            self._lock.notify_all()

    def route_interactive_host(self, on: bool) -> None:
        """Controller rung 3 (last resort): route interactive-class
        submissions to the host bucket — a few host-verified signatures
        beat queueing behind a saturated device path. Bulk keeps the
        device."""
        self._force_host_interactive = bool(on)

    def degradation_status(self) -> dict:
        """Which rungs are applied (fleet_status / readyz diagnostics)."""
        return {"bulk_shed": self._shed_active,
                "ladder_shrunk": self._ladder_shrunk,
                "interactive_host": self._force_host_interactive,
                "max_pending": self.max_pending}

    @classmethod
    def ladder_from_occupancy(cls, profiler=None, max_batch: int = 32768,
                              min_floor: int | None = None) -> dict:
        """Per-scheme bucket ladders tuned from the flight recorder's
        occupancy stats: the floor doubles toward each scheme's observed
        mean live batch (one rung of headroom below it), so a scheme that
        sustains megabatches skips the tiny rungs while a trickle-fed one
        keeps them. Feed the result to ``SignatureBatcher(bucket_ladder=)``
        on the next (re)start."""
        if profiler is None:
            profiler = get_profiler()
        floor0 = min_floor if min_floor is not None else cls.LADDER_FLOOR
        ladders = {}
        for scheme, mean_live in profiler.occupancy_mean_live().items():
            floor = floor0
            while floor * 4 <= mean_live and floor * 2 <= max_batch:
                floor *= 2
            ladders[scheme] = cls._pow2_ladder(floor, max_batch)
        return ladders

    # -- client side ---------------------------------------------------------
    def submit(self, key: PublicKey, signature: bytes, content: bytes,
               ctx=None, latency_class: str = INTERACTIVE) -> Future:
        """Future resolves to bool (valid/invalid); malformed input → False,
        matching the batch kernels' precheck semantics. Single submits
        default to the interactive latency class: a lone check flushes on
        the short deadline instead of lingering behind a coalescing
        megabatch."""
        return self.submit_many([(key, signature, content)], ctx=ctx,
                                latency_class=latency_class)[0]

    def submit_many(self, checks, ctx=None,
                    latency_class: str = BULK) -> list[Future]:
        """Bulk submission: one lock round for a whole transaction's (or
        ledger's) signature set — the per-item lock churn matters at the
        32k-batch scale the service path runs. ``ctx`` is the submitter's
        SpanContext: the flushed batch's spans join that trace."""
        pendings = [_Pending(key, sig, content, future=Future())
                    for key, sig, content in checks]
        self._stamp_trace(pendings, ctx)
        self._enqueue(pendings, latency_class)
        return [p.future for p in pendings]

    def submit_group(self, checks, ctx=None,
                     latency_class: str = BULK) -> Future:
        """Submit a set of checks resolved by ONE future of verdict bools
        (in submission order) — the bulk interface for callers that consume
        whole batches (the service's verify_signed, the OOP worker, service
        benchmarks). ``latency_class="interactive"`` puts the group on the
        short-deadline path (service.verify_signed uses it: one tx's few
        signatures are latency-bound, not throughput-bound)."""
        group = _Group(len(checks))
        pendings = [_Pending(key, sig, content, group=group, index=i)
                    for i, (key, sig, content) in enumerate(checks)]
        self._stamp_trace(pendings, ctx)
        self._enqueue(pendings, latency_class)
        if not pendings:
            group.future.set_result([])
        return group.future

    @staticmethod
    def _stamp_trace(pendings, ctx) -> None:
        if ctx is None:     # tracing off, or an untraced caller
            return
        now = _time.time()
        for p in pendings:
            p.ctx = ctx
            p.t_enq = now

    def _enqueue(self, pendings: list[_Pending],
                 latency_class: str = BULK) -> None:
        # bucket lookups happen OUTSIDE the condition lock: a 32k-item
        # submission must not hold the dispatcher up for the whole scan
        force_host = (self._force_host_interactive
                      and latency_class == INTERACTIVE)
        routed: dict[str, list[_Pending]] = {}
        for p in pendings:
            bucket = ("host" if not self.use_device or force_host
                      else _BUCKETS.get(p.key.scheme.scheme_number_id, "host"))
            routed.setdefault(bucket, []).append(p)
        with self._lock:
            if self._closed:
                raise RuntimeError("SignatureBatcher is closed")
            if self.max_pending is not None and latency_class == BULK:
                # admission control: bulk producers block at the cap
                # (interactive is always admitted — its whole point is
                # bounded latency under bulk pressure). The planner's
                # drains notify this wait as depth comes down.
                blocked_t0 = _time.time()
                blocked = False
                # the cap is re-read each wake: the controller's shed rung
                # may lift it to None (uncapped) while producers wait here
                while (not self._closed and self.max_pending is not None
                       and sum(len(q.bulk) for q in self._queues.values())
                       >= self.max_pending):
                    blocked = True
                    self._lock.wait(timeout=0.1)
                if self._closed:
                    raise RuntimeError("SignatureBatcher is closed")
                if blocked:
                    # wait-state span: admission blocked at the bulk cap.
                    # One span per submission, parented to the (shared)
                    # caller context stamped on the wave's pendings.
                    ctx = next((p.ctx for p in pendings
                                if p.ctx is not None), None)
                    if ctx is not None:
                        now = _time.time()
                        get_tracer().record(
                            "wait.verifier_admission", parent=ctx,
                            start_s=blocked_t0, duration_s=now - blocked_t0,
                            wait_kind="verifier.admission",
                            n_sigs=len(pendings))
            now = _time.monotonic()
            for bucket, ps in routed.items():
                self._queues[bucket].add(latency_class, ps, now)
            self.metrics.counter("SigBatcher.InFlight").inc(len(pendings))
            self._lock.notify_all()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        # the planner drains its queues AND waits out every in-flight plan
        # before exiting; the pool shutdowns then reap the workers — prep
        # first (prep tasks submit finish tasks), then finish.
        self._thread.join(timeout=60)
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=True)
        if self._finish_pool is not None:
            self._finish_pool.shutdown(wait=True)
        if self._profiler is not None:
            prof, self._profiler = self._profiler, None
            prof.stop()
            os.makedirs(self._profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self._profile_dir, f"sig-batcher-{os.getpid()}-"
                f"{id(self):x}.json"))

    # -- dispatcher (continuous-batching planner) ----------------------------
    def _run(self) -> None:
        # The planner thread never blocks on a batch: each pass cuts every
        # plan the in-flight windows allow (interactive first, then bulk at
        # ladder rungs), hands them to the prep pool, and goes back to
        # sleep until the nearest class deadline or the next enqueue /
        # release notification. Batch N+1's host prep therefore starts the
        # moment a window slot frees — while batch N still executes on
        # device — instead of after a drain barrier.
        while True:
            with self._lock:
                now = _time.monotonic()
                plans, wake = self._plan_locked(now)
                if not plans:
                    if (self._closed
                            and not any(self._queues.values())
                            and not any(self._inflight_n.values())):
                        break
                    timeout = None if wake is None else max(0.0, wake - now)
                    self._lock.wait(timeout=timeout)
                    continue
            for bucket, items, reason, release in plans:
                self._submit_flush(bucket, items, reason, release)

    def _plan_locked(self, now: float):
        """Cut every dispatchable plan from the queues (CALLER HOLDS THE
        LOCK). Returns (plans, wake): plans are (bucket, items, reason,
        release) tuples ready for the prep pool; wake is the earliest
        future deadline among the classes that are not ready yet (None
        when nothing is waiting on time)."""
        plans = []
        wake = None
        for name, q in self._queues.items():
            if not (q.interactive or q.bulk):
                continue
            window = self.MAX_IN_FLIGHT if name != "host" \
                else self.MAX_IN_FLIGHT + 1
            if name == "host" or len(q) < self.host_crossover:
                # host route (below the crossover both classes merge — the
                # host loop has no shape or occupancy stake, and waiting
                # would add pure latency: the p50@1 case)
                if self._inflight_n[name] < self.MAX_IN_FLIGHT + 1:
                    reason = "close" if self._closed else (
                        "host" if name == "host" else "small_batch")
                    plans.append(self._make_plan(name, q.drain_all(), reason))
                continue
            # interactive: short deadline, small buckets, ONE priority slot
            # past the bulk window so bulk pressure cannot starve it
            if q.interactive:
                ready, reason, deadline = self._class_ready(
                    len(q.interactive), q.t_first[INTERACTIVE],
                    q.t_last[INTERACTIVE], now,
                    self.interactive_batch, self.interactive_latency_s)
                if ready:
                    while (q.interactive and self._inflight_n[name]
                           < self.MAX_IN_FLIGHT + 1):
                        cut = min(len(q.interactive), self.interactive_batch)
                        items = q.interactive[:cut]
                        del q.interactive[:cut]
                        plans.append(self._make_plan(name, items, reason))
                elif wake is None or deadline < wake:
                    wake = deadline
            # bulk: coalesce toward max_batch, cut at ladder rungs so the
            # launches re-see the same shapes across arrival rates
            if q.bulk:
                ready, reason, deadline = self._class_ready(
                    len(q.bulk), q.t_first[BULK], q.t_last[BULK], now,
                    self.max_batch, self.max_latency_s)
                if ready:
                    while q.bulk and self._inflight_n[name] < window:
                        cut = self._ladder_cut(name, len(q.bulk))
                        items = q.bulk[:cut]
                        del q.bulk[:cut]
                        plans.append(self._make_plan(name, items, reason))
                elif wake is None or deadline < wake:
                    wake = deadline
        if plans:
            # queue depth dropped: re-admit blocked bulk producers
            self._lock.notify_all()
        return plans, wake

    def _class_ready(self, depth: int, t_first: float, t_last: float,
                     now: float, cap: int, latency: float):
        """(ready, reason, deadline) for one latency class: flush at the
        cap, at the class deadline (t_first + latency), or one stall tick
        after the last arrival — an atomic burst stops paying the whole
        linger while a trickling burst keeps coalescing."""
        if self._closed:
            return True, "close", None
        if depth >= cap:
            return True, "max_batch", None
        hard = t_first + latency
        stall = t_last + latency / 5
        if now >= hard:
            return True, "deadline", None
        if now >= stall:
            return True, "stalled", None
        return False, None, min(hard, stall)

    def _make_plan(self, bucket: str, items: list[_Pending], reason: str):
        """Claim an in-flight slot for one cut batch (CALLER HOLDS THE
        LOCK) and build its idempotent release — the continuous-batching
        seam: the slot frees (and the planner re-wakes) the moment the
        batch RESOLVES, from whichever pool thread got there, never from a
        planner-side blocking wait."""
        self._inflight_n[bucket] += 1
        released = [False]

        def release(_f=None):
            with self._lock:
                if released[0]:
                    return
                released[0] = True
                self._inflight_n[bucket] -= 1
                self._lock.notify_all()

        return bucket, items, reason, release

    def _submit_flush(self, bucket: str, items: list[_Pending],
                      reason: str, release) -> None:
        """Hand one planned batch to the prep pool. Never blocks: window
        accounting already happened in the planner, so the only wait left
        anywhere is pool scheduling."""
        if self._prep_pool is None:
            self._prep_pool = ThreadPoolExecutor(
                max_workers=self.PREP_WORKERS,
                thread_name_prefix="sig-batcher-prep")
        try:
            self._prep_pool.submit(
                self._flush_slot, bucket, items, reason, release)
        except RuntimeError:
            # pool already shut down (close() raced a long drain): flush
            # inline so no queued caller's future is dropped
            inner = self._flush_slot(bucket, items, reason, release)
            if inner is not None:
                inner.result()

    def _flush_slot(self, bucket: str, items: list[_Pending], reason: str,
                    release):
        """_flush under slot accounting: the in-flight slot releases when
        the batch fully resolves (inline for host routes, at the finish
        future for pipelined device batches), and a prep/finish crash
        fails the batch's futures instead of leaking them — zero lost
        futures even through a breaker trip mid-pipeline."""
        try:
            inner = self._flush(bucket, items, reason)
        except BaseException as exc:
            _log.exception("signature batch prep/finish failed")
            self.metrics.meter("SigBatcher.BatchFailure").mark()
            self._fail_items(items, exc)
            release()
            return None
        if inner is None:
            release()
        else:
            inner.add_done_callback(release)
        return inner

    def _fail_items(self, items: list[_Pending], exc: BaseException) -> None:
        """Resolve a crashed batch's futures with the failure. Futures that
        already resolved (the crash hit after _resolve) are left alone."""
        groups = {}
        for p in items:
            if p.group is not None:
                groups[id(p.group)] = p.group
            else:
                try:
                    p.future.set_exception(exc)
                except Exception:
                    pass
        for g in groups.values():
            try:
                g.future.set_exception(exc)
            except Exception:
                pass
        self.metrics.counter("SigBatcher.InFlight").dec(len(items))

    def _flush(self, bucket: str, items: list[_Pending], reason: str):
        """Route one drained bucket: host loop below the crossover, device
        kernels above. RUNS ON A PREP-POOL WORKER, so a mixed drain's
        buckets prep and dispatch concurrently. Returns the finish-stage
        Future for pipelined device batches (None when the batch resolved
        inline). Records the per-flush histogram + trace spans."""
        gauge = self.metrics.settable_gauge("SigBatcher.PrepActive")
        with self._pool_lock:
            self._prep_active += 1
            gauge.set(self._prep_active)
        try:
            self.metrics.histogram("verifier_batch_size").update(len(items))
            tracer = get_tracer()
            bctx = self._trace_flush(tracer, bucket, items, reason) \
                if tracer.enabled else None
            jlog(_log, "batcher.flush", ctx=bctx, bucket=bucket,
                 batch_size=len(items), flush_reason=reason)
            if bucket == "host" or len(items) < self.host_crossover:
                if bucket != "host":
                    self.metrics.meter("SigBatcher.HostRouted").mark(
                        len(items))
                t0 = _time.perf_counter()
                with tracer.span("batcher.dispatch", parent=bctx,
                                 bucket=bucket, batch_size=len(items),
                                 route="host"):
                    verdicts = self._run_host(items)
                self.metrics.histogram("verifier_dispatch_seconds").update(
                    _time.perf_counter() - t0, trace_id=_tid(bctx))
                self._resolve("host", items, verdicts, bctx)
                return None
            breaker = self._breakers[bucket]
            if not breaker.allow():
                # breaker open: degrade THIS scheme to host verification —
                # every future still resolves, the device just isn't tried.
                # Occupancy stats still update (a host batch is 100% live —
                # no padding), so degraded mode keeps the per-scheme
                # QueueDepth/InFlight gauges and the flight recorder's
                # occupancy surface fresh instead of frozen at the last
                # device batch.
                self.metrics.meter("SigBatcher.BreakerRouted").mark(
                    len(items))
                get_profiler().record_occupancy(bucket, len(items),
                                                len(items))
                t0 = _time.perf_counter()
                with tracer.span("batcher.dispatch", parent=bctx,
                                 bucket=bucket, batch_size=len(items),
                                 route="breaker_open"):
                    verdicts = self._run_host(items)
                self.metrics.histogram("verifier_dispatch_seconds").update(
                    _time.perf_counter() - t0, trace_id=_tid(bctx))
                self._resolve(bucket, items, verdicts, bctx)
                return None
            return self._dispatch_device(bucket, items, reason, bctx)
        finally:
            with self._pool_lock:
                self._prep_active -= 1
                gauge.set(self._prep_active)

    #: Per-flush cap on retroactive enqueue-wait spans: a fully-traced 32k
    #: batch must not turn one flush into 32k ring inserts.
    MAX_WAIT_SPANS = 64

    def _trace_flush(self, tracer, bucket, items, reason):
        """Record the flush span (+ capped per-item enqueue-wait spans) and
        return its context — the parent for dispatch/wait/resolve spans.
        A mixed batch carries many traces; the flush span joins the FIRST
        traced submitter's trace and tags how many others rode along."""
        now = _time.time()
        first_ctx = None
        traced = 0
        for p in items:
            if p.ctx is None:
                continue
            traced += 1
            if first_ctx is None:
                first_ctx = p.ctx
            if traced <= self.MAX_WAIT_SPANS:
                tracer.record("batcher.enqueue_wait", parent=p.ctx,
                              start_s=p.t_enq,
                              duration_s=max(0.0, now - p.t_enq),
                              bucket=bucket)
        return tracer.record("batcher.flush", parent=first_ctx, start_s=now,
                             bucket=bucket, batch_size=len(items),
                             flush_reason=reason, n_traced=traced)

    #: Max device batches in flight PER SCHEME: the one just launched plus
    #: two awaiting their results (the JAX package's depth; not yet tuned on
    #: the H100). Extra device residency is a few batches' wire buffers.
    MAX_IN_FLIGHT = 3

    def _profile_step(self, bucket: str):
        """A ``torch.profiler.record_function`` range for one device
        dispatch (None when profiling is off). The sequence counter needs a
        lock because dispatches run concurrently on the prep pool."""
        if self._profiler is None:
            return None
        with self._profile_lock:
            self._batch_seq += 1
            seq = self._batch_seq
        return torch.profiler.record_function(f"verify-{bucket}-{seq}")

    def _device_ctx(self):
        """Device + stream context for a launch: this batcher's own CUDA
        stream on its device (nothing on the CPU)."""
        if self._stream is None:
            return _null_ctx()
        return torch.cuda.stream(self._stream)

    def _dispatch_device(self, bucket: str, items: list[_Pending],
                         reason: str = "full", bctx=None):
        """Kernel prep + async launch for one scheme bucket; returns the
        finish-stage Future (None when resolved here). The try below covers
        ONLY kernel prep/dispatch: a failure there falls back to host
        verdicts, but a failure inside _resolve must propagate — re-running
        _resolve on the same items would double-resolve group members
        (remaining underflow, double set_result). A KernelError (the kernel
        does not build or its launch is refused) is no transient fault: it
        propagates, failing the batch's futures, and leaves the breaker as
        it was, so the card's work never moves to the host unseen. With a
        mesh the sharded helpers resolve the batch here, synchronously."""
        profile_ctx = self._profile_step(bucket)
        tracer = get_tracer()
        dspan = tracer.span("batcher.dispatch", parent=bctx, bucket=bucket,
                            batch_size=len(items), route="device",
                            flush_reason=reason)
        t_prep = _time.perf_counter()
        mesh_verdicts = None
        breaker = self._breakers[bucket]
        try:
            with self.metrics.timer(f"SigBatcher.{bucket}.Prep"), \
                    (profile_ctx or _null_ctx()), self._device_ctx():
                # chaos seam: a "raise" rule here exercises exactly the
                # fallback + breaker path a real kernel failure would
                fault_point("batcher.device_dispatch", detail=bucket)
                if self.mesh is not None:
                    # the sharded helpers resolve the batch synchronously
                    if bucket == "ed25519":
                        mesh_verdicts = self._run_mesh_ed25519(items)
                    else:
                        mesh_verdicts = self._run_mesh_ecdsa(bucket, items)
                # host prep HERE — overlaps other schemes' preps and the
                # finish pool's device waits
                elif bucket == "ed25519":
                    pending, finish = self._start_ed25519(items)
                else:
                    pending, finish = self._start_ecdsa(bucket, items)
        except KernelError:
            dspan.finish()
            raise
        except Exception:
            # batch-level failure (kernel/compile/transfer): fall back to
            # per-item host verification so one malformed member — or a
            # transient device error — cannot fail unrelated transactions'
            # futures
            self.metrics.meter("SigBatcher.BatchFailure").mark()
            breaker.record_failure()
            dspan.set_tag("fallback", "host")
            dspan.finish()
            self._resolve(bucket, items, self._run_host(items), bctx)
            return None
        if self.mesh is not None:
            breaker.record_success()
            self._mark_device(items)
            self.metrics.histogram("verifier_dispatch_seconds").update(
                _time.perf_counter() - t_prep, trace_id=_tid(bctx))
            dspan.set_tag("mesh", True)
            dspan.finish()
            self._resolve(bucket, items, mesh_verdicts, bctx)
            return None
        t_end = _time.perf_counter()
        # feed the flight recorder's pipeline view: this prep busy interval
        # intersected against the finish pool's device-wait intervals
        get_profiler().overlap.add_prep(t_prep, t_end)
        self.metrics.histogram("verifier_prep_seconds").update(
            t_end - t_prep, trace_id=_tid(bctx))
        dspan.finish()
        # pipelined: the finish pool blocks on the device result (a
        # GIL-releasing wait) and resolves the futures; this prep worker is
        # immediately free for the next batch
        return self._submit_finish(bucket, items, pending, finish, bctx)

    def _submit_finish(self, bucket, items, pending, finish, bctx):
        if self._finish_pool is None:
            with self._pool_lock:        # prep workers race the first batch
                if self._finish_pool is None:
                    self._finish_pool = ThreadPoolExecutor(
                        max_workers=self.PREP_WORKERS,
                        thread_name_prefix="sig-batcher-finish")
        try:
            return self._finish_pool.submit(
                self._finish_one, bucket, items, pending, finish, bctx)
        except RuntimeError:
            # pool already shut down (close() raced a long drain)
            self._finish_one(bucket, items, pending, finish, bctx)
            return None

    def _finish_one(self, bucket, items, pending, finish, bctx=None) -> None:
        # bctx crossed from the prep thread via the executor args —
        # the explicit-propagation seam the tracer tests pin down
        wspan = get_tracer().span("batcher.device_wait", parent=bctx,
                                  bucket=bucket, batch_size=len(items))
        t0 = _time.perf_counter()
        try:
            with wspan, self.metrics.timer(f"SigBatcher.{bucket}.Duration"):
                verdicts = finish(pending)
            t_end = _time.perf_counter()
            self._breakers[bucket].record_success()
            self._mark_device(items)
            get_profiler().overlap.add_device(t0, t_end)
            self.metrics.histogram("verifier_dispatch_seconds").update(
                t_end - t0, trace_id=_tid(bctx))
        except KernelError as exc:
            # the kernel faulted on the card: fail the futures, no fallback
            _log.exception("signature batch failed on the card")
            self.metrics.meter("SigBatcher.BatchFailure").mark()
            self._fail_items(items, exc)
            return
        except Exception:
            self.metrics.meter("SigBatcher.BatchFailure").mark()
            self._breakers[bucket].record_failure()
            verdicts = self._run_host(items)
        self._resolve(bucket, items, verdicts, bctx)

    def _mark_device(self, items) -> None:
        self.metrics.meter("SigBatcher.DeviceBatches").mark()
        self.metrics.meter("SigBatcher.DeviceChecked").mark(len(items))

    def _resolve(self, bucket: str, items: list[_Pending], verdicts,
                 bctx=None) -> None:
        tracer = get_tracer()
        t_wall = _time.time() if tracer.enabled else 0.0
        t0 = _time.perf_counter()
        # Group fan-in, batched: each result slot is written by exactly one
        # flush (disjoint indices), so the writes need no lock — only the
        # shared `remaining` count does, and that is taken ONCE per group
        # per flush (it was once per ITEM; a 32k single-group flush paid
        # 32k acquires).
        group_counts: dict[int, list] = {}
        for p, ok in zip(items, verdicts):
            if p.group is not None:
                g = p.group
                g.results[p.index] = bool(ok)
                entry = group_counts.get(id(g))
                if entry is None:
                    group_counts[id(g)] = [g, 1]
                else:
                    entry[1] += 1
            else:
                try:
                    p.future.set_result(bool(ok))
                except Exception:
                    pass   # caller cancelled its future; verdict dropped
        done_groups = []
        for g, n_done in group_counts.values():
            with g.lock:
                g.remaining -= n_done
                if g.remaining == 0:
                    done_groups.append(g)
        for g in done_groups:
            try:
                g.future.set_result(g.results)
            except Exception:
                pass
        self.metrics.meter("SigBatcher.Checked").mark(len(items))
        self.metrics.counter("SigBatcher.InFlight").dec(len(items))
        dt = _time.perf_counter() - t0
        self.metrics.histogram("verifier_finish_seconds").update(
            dt, trace_id=_tid(bctx))
        if tracer.enabled:
            tracer.record("batcher.resolve", parent=bctx, start_s=t_wall,
                          duration_s=dt, bucket=bucket,
                          batch_size=len(items))

    @staticmethod
    def _run_host(items: list[_Pending]) -> list[bool]:
        verdicts = []
        for p in items:
            try:
                verdicts.append(Crypto.is_valid(p.key, p.signature, p.content))
            except Exception:
                verdicts.append(False)
        return verdicts

    def _start_ed25519(self, items: list[_Pending]):
        pending = ed_ops.verify_batch_async(
            [(p.key.encoded, p.signature, p.content) for p in items],
            device=self.device)
        return pending, ed_ops.finish_batch

    @staticmethod
    def _ecdsa_kernel_items(curve, items: list[_Pending]):
        kitems = []
        for p in items:
            # per-item isolation: ANY malformed member becomes a False
            # verdict for that member alone, never a batch failure
            try:
                point = sec1_decompress_cached(curve, p.key.encoded)
                r, s = ecmath.ecdsa_sig_from_der(p.signature)
            except Exception:
                point, r, s = None, 0, 0  # fails the range precheck → False
            kitems.append((point, p.content, r, s))
        return kitems

    @staticmethod
    def _ecdsa_words(curve, items: list[_Pending]):
        """Cached + vectorized ECDSA kernel prep: per-signer pub rows from
        keys.sec1_pub_row_cached, ONE batched DER parse
        (scalarprep.ecdsa_sigs_to_words), digests packed straight into the
        native preps' LE u64 word rows. Per-item isolation is preserved:
        any malformed member gets r := 0, which the native range precheck
        rejects into a False verdict for that member alone."""
        r_words, s_words, ok = sp.ecdsa_sigs_to_words(
            [p.signature for p in items])
        pub_words = np.zeros((len(items), 8), dtype=np.uint64)
        for i, p in enumerate(items):
            row = sec1_pub_row_cached(curve, p.key.encoded)
            if row is None:
                ok[i] = False
            else:
                pub_words[i] = row
        r_words[~ok] = 0     # force the range precheck to reject
        e_words = sp.digests_to_words(
            [hashlib.sha256(p.content).digest() for p in items], 4)
        return e_words, r_words, s_words, pub_words

    def _run_mesh_ed25519(self, items: list[_Pending]):
        from ..parallel import sharded_verify_batch_ed25519
        return sharded_verify_batch_ed25519(
            self.mesh, [(p.key.encoded, p.signature, p.content)
                        for p in items])

    def _run_mesh_ecdsa(self, bucket: str, items: list[_Pending]):
        from ..parallel import (sharded_verify_batch_secp256k1,
                                sharded_verify_batch_secp256k1_words,
                                sharded_verify_batch_secp256r1_words)
        curve = ecmath.SECP256K1 if bucket == "secp256k1" else ecmath.SECP256R1
        words = wc_ops.words_prep_available(curve)
        if bucket == "secp256k1":
            if words:
                return sharded_verify_batch_secp256k1_words(
                    self.mesh, *self._ecdsa_words(curve, items))
            return sharded_verify_batch_secp256k1(
                self.mesh, self._ecdsa_kernel_items(curve, items))
        if words:
            return sharded_verify_batch_secp256r1_words(
                self.mesh, *self._ecdsa_words(curve, items))
        # no item-form r1 mesh entry (as in the reference): without the
        # native prep, the first device verifies the batch whole
        return wc_ops.verify_batch(curve,
                                   self._ecdsa_kernel_items(curve, items),
                                   device=self.device)

    def _start_ecdsa(self, bucket: str, items: list[_Pending]):
        curve = ecmath.SECP256K1 if bucket == "secp256k1" else ecmath.SECP256R1
        if wc_ops.words_prep_available(curve):
            pending = wc_ops.verify_batch_async_words(
                curve, *self._ecdsa_words(curve, items), device=self.device)
        else:
            pending = wc_ops.verify_batch_async(
                curve, self._ecdsa_kernel_items(curve, items),
                device=self.device)
        return pending, wc_ops.finish_batch
