"""Flight recorder: kernel build + launch profiling for the device kernels.

Port of corda_tpu.observability.profiling. The JAX recorder probed each
jitted function's compile cache; PyTorch runs eagerly and the port's CUDA
kernels are built once per process at first use, so here:

- **build accounting** — a profiled kernel wrapper exposes ``build_count()``
  (how many times its kernel library was built in this process). A growth
  across a call means THIS call paid the build: the call's wall time is
  booked under ``compiles``/``compile_s`` (the snapshot keys stay the JAX
  package's) and a ``kernel.compile`` span lands in the trace ring.
- **launches + device wall time** — per-kernel launch counts
  (``dispatches``) and wall-time totals, split into the launch half (async
  enqueue) and the device wait (the CUDA event wait in ``finish_batch``),
  attributed back to the kernel through the pending handle.
- **batch occupancy** — live items vs padded capacity per scheme.
- **prep/device overlap** — interval bookkeeping fed by the
  SignatureBatcher: how much of the device busy time had host prep running
  concurrently.

The profiler is a process-global singleton with explicit accessors
(``get_profiler``), always on; ``snapshot()`` is the /debug/profile
payload, with the JAX package's keys.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from ..utils.metrics import Histogram, MetricRegistry
from .tracing import get_tracer


class OverlapTracker:
    """Sliding-window interval bookkeeping for prep/device concurrency.

    ``add_prep``/``add_device`` record (start, end) monotonic-clock busy
    intervals; ``overlap_s`` is the total time at least one prep interval
    intersected at least one device interval, and ``overlap_pct`` expresses
    it against the device busy time — 0% means the host prepped only while
    the device idled (no pipelining), 100% means every device second had
    prep running alongside. Windows are bounded so a long-lived node's
    tracker reflects recent behaviour, not its whole life."""

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._prep: deque = deque(maxlen=window)
        self._device: deque = deque(maxlen=window)

    def add_prep(self, start_s: float, end_s: float) -> None:
        if end_s > start_s:
            with self._lock:
                self._prep.append((start_s, end_s))

    def add_device(self, start_s: float, end_s: float) -> None:
        if end_s > start_s:
            with self._lock:
                self._device.append((start_s, end_s))

    @staticmethod
    def _merge(intervals: list) -> list:
        merged: list = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def snapshot(self) -> dict:
        with self._lock:
            prep = list(self._prep)
            device = list(self._device)
        prep_m = self._merge(prep)
        dev_m = self._merge(device)
        overlap = 0.0
        i = j = 0
        while i < len(prep_m) and j < len(dev_m):
            lo = max(prep_m[i][0], dev_m[j][0])
            hi = min(prep_m[i][1], dev_m[j][1])
            if hi > lo:
                overlap += hi - lo
            if prep_m[i][1] < dev_m[j][1]:
                i += 1
            else:
                j += 1
        prep_s = sum(e - s for s, e in prep_m)
        dev_s = sum(e - s for s, e in dev_m)
        return {"prep_busy_s": prep_s, "device_busy_s": dev_s,
                "overlap_s": overlap,
                "overlap_pct": 100.0 * overlap / dev_s if dev_s > 0 else 0.0}

    def overlap_pct(self) -> float:
        return self.snapshot()["overlap_pct"]


class _KernelStats:
    __slots__ = ("dispatches", "dispatch_s", "compiles", "compile_s",
                 "cache_hits", "device_waits", "device_wait_s")

    def __init__(self):
        self.dispatches = 0
        self.dispatch_s = 0.0
        self.compiles = 0
        self.compile_s = 0.0
        self.cache_hits = 0
        self.device_waits = 0
        self.device_wait_s = 0.0

    def as_dict(self) -> dict:
        return {"dispatches": self.dispatches,
                "dispatch_s": self.dispatch_s,
                "compiles": self.compiles,
                "compile_s": self.compile_s,
                "cache_hits": self.cache_hits,
                "device_waits": self.device_waits,
                "device_wait_s": self.device_wait_s}


#: Cap on the pending-handle → kernel-name attribution table: entries are
#: popped on finish, so growth only happens when dispatches are abandoned.
_MAX_PENDING = 256


class KernelProfiler:
    """Process-wide kernel flight recorder (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._kernels: dict[str, _KernelStats] = {}
        # scheme -> [live_total, capacity_total, last_pct, batches]
        self._occupancy: dict[str, list] = {}
        # id(device value) -> kernel name, for finish-time attribution
        self._pending: OrderedDict = OrderedDict()
        self._warm_compiles = 0
        self.overlap = OverlapTracker()
        # shared histograms — publish() mirrors these into registries, so
        # one process-wide distribution feeds every /metrics surface
        self.dispatch_hist = Histogram()
        self.device_wait_hist = Histogram()
        self.compile_hist = Histogram()
        self.occupancy_hist = Histogram()

    # -- kernel dispatch ----------------------------------------------------
    def call(self, name: str, fn, *args, live: int | None = None,
             capacity: int | None = None, scheme: str | None = None,
             **kwargs):
        """Invoke ``fn(*args, **kwargs)`` under the recorder.

        ``fn`` is a kernel wrapper with a ``build_count()`` attribute. The
        call's wall time is booked as build time when ``build_count()`` grew
        across it, as a warm launch otherwise. ``live``/``capacity``/
        ``scheme`` record batch occupancy for the padded device batch."""
        before = fn.build_count()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        compiled = fn.build_count() > before
        with self._lock:
            st = self._kernels.get(name)
            if st is None:
                st = self._kernels[name] = _KernelStats()
            st.dispatches += 1
            st.dispatch_s += dt
            if compiled:
                st.compiles += 1
                st.compile_s += dt
            else:
                st.cache_hits += 1
        if compiled:
            self.compile_hist.update(dt)
            tracer = get_tracer()
            if tracer.enabled:
                tracer.record("kernel.compile", duration_s=dt, kernel=name,
                              batch_capacity=capacity)
        else:
            self.dispatch_hist.update(dt)
        if live is not None and capacity:
            self.record_occupancy(scheme or name, live, capacity)
        self.note_pending(out, name)
        return out

    # -- occupancy ----------------------------------------------------------
    def record_occupancy(self, scheme: str, live: int, capacity: int) -> None:
        """``live`` real items were padded to a ``capacity``-row device
        batch; the gap is pure padding waste."""
        if capacity <= 0:
            return
        pct = 100.0 * live / capacity
        with self._lock:
            row = self._occupancy.setdefault(scheme, [0, 0, 0.0, 0])
            row[0] += live
            row[1] += capacity
            row[2] = pct
            row[3] += 1
        self.occupancy_hist.update(pct)

    def occupancy_mean_live(self) -> dict:
        """Mean live items per device batch, per scheme — the signal the
        batcher's bucket-ladder tuner reads (SignatureBatcher
        .ladder_from_occupancy): sustained small batches pull the ladder
        floor down, sustained megabatches push it up."""
        with self._lock:
            return {scheme: row[0] / row[3]
                    for scheme, row in self._occupancy.items() if row[3]}

    # -- device-wait attribution --------------------------------------------
    def note_pending(self, handle, name: str) -> None:
        """Remember which kernel produced an async pending value so
        ``device_wait``/``pending_name`` can attribute the finish-time
        force back to it."""
        if handle is None:
            return
        with self._lock:
            self._pending[id(handle)] = name
            while len(self._pending) > _MAX_PENDING:
                self._pending.popitem(last=False)

    def pending_name(self, handle, default: str = "unknown") -> str:
        with self._lock:
            return self._pending.pop(id(handle), default)

    def device_wait(self, name: str, seconds: float) -> None:
        with self._lock:
            st = self._kernels.get(name)
            if st is None:
                st = self._kernels[name] = _KernelStats()
            st.device_waits += 1
            st.device_wait_s += seconds
        self.device_wait_hist.update(seconds)

    # -- warmup boundary ----------------------------------------------------
    def mark_warm(self) -> None:
        """Stamp the current build count as the warmup boundary. Any
        kernel build after this is a steady-state miss — a bench smoke gate
        asserts compiles_since_warm() == 0 after the warm phase."""
        with self._lock:
            self._warm_compiles = sum(s.compiles
                                      for s in self._kernels.values())

    def compiles_since_warm(self) -> int:
        with self._lock:
            total = sum(s.compiles for s in self._kernels.values())
            return max(0, total - self._warm_compiles)

    # -- aggregate views ----------------------------------------------------
    def compile_totals(self) -> dict:
        with self._lock:
            return {
                "compile_s_total": sum(s.compile_s
                                       for s in self._kernels.values()),
                "compiles": sum(s.compiles for s in self._kernels.values()),
                "compile_cache_hits": sum(s.cache_hits
                                          for s in self._kernels.values()),
            }

    def occupancy_pct_per_scheme(self) -> dict:
        with self._lock:
            return {scheme: round(100.0 * live / cap, 2)
                    for scheme, (live, cap, *_rest)
                    in self._occupancy.items() if cap}

    def snapshot(self) -> dict:
        """The /debug/profile payload: everything the recorder knows."""
        with self._lock:
            kernels = {n: s.as_dict() for n, s in self._kernels.items()}
            occupancy = {
                scheme: {"live_total": live, "capacity_total": cap,
                         "occupancy_pct":
                             round(100.0 * live / cap, 2) if cap else 0.0,
                         "last_batch_pct": round(last, 2),
                         "batches": batches}
                for scheme, (live, cap, last, batches)
                in self._occupancy.items()}
        return {
            "kernels": kernels,
            "occupancy": occupancy,
            "overlap": self.overlap.snapshot(),
            **self.compile_totals(),
            "dispatch_seconds": self.dispatch_hist.snapshot_fields(),
            "device_wait_seconds": self.device_wait_hist.snapshot_fields(),
            "compile_seconds": self.compile_hist.snapshot_fields(),
            "occupancy_pct": self.occupancy_hist.snapshot_fields(),
        }

    def publish(self, registry: MetricRegistry) -> None:
        """Mirror the recorder into a MetricRegistry: live gauges reading
        the shared singleton, plus the shared histograms installed by
        reference — publishing into N registries (node monitoring, bench's
        private one) shows ONE process-wide distribution in each."""
        registry.gauge("Profiler.CompileSecondsTotal",
                       lambda: self.compile_totals()["compile_s_total"])
        registry.gauge("Profiler.Compiles",
                       lambda: self.compile_totals()["compiles"])
        registry.gauge("Profiler.CompileCacheHits",
                       lambda: self.compile_totals()["compile_cache_hits"])
        registry.gauge("Profiler.PrepOverlapPct",
                       lambda: round(self.overlap.overlap_pct(), 2))

        def occupancy_gauge(scheme):
            def read():
                return self.occupancy_pct_per_scheme().get(scheme, 0.0)
            return read

        for scheme in ("ed25519", "secp256k1", "secp256r1"):
            registry.gauge(f"Profiler.{scheme}.OccupancyPct",
                           occupancy_gauge(scheme))
        registry.register("kernel_dispatch_seconds", self.dispatch_hist)
        registry.register("kernel_device_wait_seconds", self.device_wait_hist)
        registry.register("kernel_compile_seconds", self.compile_hist)
        registry.register("kernel_batch_occupancy_pct", self.occupancy_hist)

    def reset(self) -> None:
        """Fresh counters (bench runs, tests). Histograms are replaced, so
        registries that held the old ones keep a frozen final view — call
        publish() again to re-share."""
        with self._lock:
            self._kernels.clear()
            self._occupancy.clear()
            self._pending.clear()
            self._warm_compiles = 0
        self.overlap = OverlapTracker()
        self.dispatch_hist = Histogram()
        self.device_wait_hist = Histogram()
        self.compile_hist = Histogram()
        self.occupancy_hist = Histogram()


# ---------------------------------------------------------------------------
# Process-global profiler seam (the tracer pattern, but always-on)
# ---------------------------------------------------------------------------

_PROFILER = KernelProfiler()


def get_profiler() -> KernelProfiler:
    """The process flight recorder — call sites fetch it per operation so
    tests can swap it out with set_profiler()."""
    return _PROFILER


def set_profiler(profiler: KernelProfiler) -> None:
    global _PROFILER
    _PROFILER = profiler
