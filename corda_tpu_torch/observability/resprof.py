"""Resource accounting plane + subsystem CPU profiler (soak observatory).

Two instruments the multi-minute soak mode (observability/soak.py)
stands on, both cheap enough to run continuously:

**Resource accounting** — every bounded/growing structure in the process
(raft logs per group, CoordinatorLog bytes, the span ring, RequestLog
timelines, vault state sets, staging pools, the time-series rings
themselves, checkpoint stores, reservation maps, process RSS) registers
a zero-arg **size probe** with a :class:`ResourceRegistry`. A periodic
``sample()`` reads every probe into the retained time-series plane
(``Resource.<name>`` series) and feeds the same :class:`GrowthWatch`
that used to watch only its two hard-coded hazards — so any registered
structure gets doubling warnings for free. Cumulative counters (span
drops, timeline evictions) register as **rate probes**: each sample also
records a ``Resource.<name>.Rate`` series of the windowed per-second
delta, so a soak distinguishes "dropped 1k at startup" from "dropping
50/s steadily".

**Leak detection** — :func:`leak_verdict` runs a robust linear-trend fit
(Theil–Sen: the median of pairwise slopes, immune to the step changes a
chaos window injects) over a series' retained ring rows and returns a
per-structure verdict:

- ``bounded`` — no sustained growth over the recent half of the window
  (a transient step that then plateaus is bounded, not leaking);
- ``growing`` — sustained growth on a structure *declared*
  grows-by-design (``kind="grows"``: raft logs before compaction, the
  CoordinatorLog, vault state accrual under load) — reported with its
  slope and projected doubling time so the growth is budgetable;
- ``leaking`` — sustained growth on a structure declared **bounded**
  (``kind="bounded"``): a span ring, request log, staging pool,
  checkpoint store or reservation map that grows under steady load has
  lost its bound, full stop.

**Subsystem CPU profiler** — :class:`SubsystemProfiler` is a wall-clock
sampling profiler over ``sys._current_frames()``: every interval it
classifies each thread's stack into the component taxonomy the repo
already blames by (raft pump, group-commit cutter, batcher
dispatch/prep, flow scheduler, serialization, network, observability
overhead itself) and counts busy samples per component. Samples whose
innermost frames sit in a known blocking call (``time.sleep``,
``Event.wait``, lock acquires, queue gets, selector polls — detected by
stdlib wait frames plus a ``linecache`` peek at the source line, since C
blocking calls leave the *caller's* frame on top) count as idle and drop
out of the denominator, so ``shares_pct`` sums to 100% of *busy* sampled
time — the measured basis for the ROADMAP's native-raft decision
("where does interpreter CPU actually go on the commit path?").
"""
from __future__ import annotations

import linecache
import os
import sys
import threading
import time

__all__ = [
    "COMMIT_PATH_COMPONENTS", "CPU_COMPONENTS", "ResourceRegistry",
    "SubsystemProfiler", "classify_stack", "get_resources", "leak_verdict",
    "process_rss_bytes", "set_resources", "theil_sen_slope",
]


def _num(v):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


# ---------------------------------------------------------------------------
# Resource accounting plane
# ---------------------------------------------------------------------------

def process_rss_bytes() -> float:
    """Resident set size of this process in bytes. Linux reads
    ``/proc/self/statm`` (resident pages × page size); elsewhere falls
    back to ``resource.getrusage`` max-RSS (a high-water mark — still a
    usable leak signal). 0.0 when neither source exists."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        pass
    try:
        import resource
        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # linux reports KiB, macOS bytes; either way it is monotone
        return float(rss_kb) * (1.0 if rss_kb > 1 << 30 else 1024.0)
    except Exception:
        return 0.0


class ResourceRegistry:
    """Process-wide registry of structure-size probes.

    ``register(name, probe, kind, rate)`` attaches a zero-arg callable
    returning the structure's current size (entries, bytes — any
    monotone-comparable number). ``kind`` declares the structure's
    design contract — ``"bounded"`` (growth is a leak) or ``"grows"``
    (growth is expected until compaction/GC; the verdict caps at
    ``growing``). ``rate=True`` marks a cumulative counter whose
    windowed per-second delta should be recorded as a companion
    ``Resource.<name>.Rate`` series.

    ``sample(store, watch)`` is the periodic tick: defensive (a probe
    that raises contributes nothing this tick), O(#probes), and feeds
    both the retained time-series plane and the growth watchdog."""

    def __init__(self):
        self._lock = threading.Lock()
        self._probes: dict = {}      # name -> (probe, kind, rate, bound)
        self._last: dict = {}        # name -> last sampled value
        self._rate_prev: dict = {}   # name -> (t, cumulative value)

    def register(self, name: str, probe, kind: str = "bounded",
                 rate: bool = False, bound: float | None = None) -> None:
        """``bound`` is the structure's declared capacity when it has one
        (a ring's maxlen, a log's entry cap): growth BELOW the bound is
        the structure filling as designed, not leaking — without it a
        bounded ring reads ``leaking`` for exactly as long as it takes to
        reach capacity the first time."""
        if kind not in ("bounded", "grows"):
            raise ValueError(f"kind must be 'bounded' or 'grows', got {kind!r}")
        if not callable(probe):
            raise ValueError("probe must be callable")
        with self._lock:
            self._probes[name] = (probe, kind, rate, bound)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)
            self._last.pop(name, None)
            self._rate_prev.pop(name, None)

    def names(self) -> list:
        with self._lock:
            return sorted(self._probes)

    def kinds(self) -> dict:
        with self._lock:
            return {n: kind for n, (_p, kind, _r, _b) in self._probes.items()}

    def bounds(self) -> dict:
        """{name: declared capacity} for probes registered with one."""
        with self._lock:
            return {n: b for n, (_p, _k, _r, b) in self._probes.items()
                    if b is not None}

    def sample(self, store=None, watch=None, t: float | None = None) -> dict:
        """Read every probe once; record ``Resource.<name>`` (and
        ``.Rate`` for cumulative probes) into ``store``, feed ``watch``
        (every registered structure gets doubling warnings for free),
        and return {series name: value} for what was sampled."""
        t = time.time() if t is None else t
        with self._lock:
            probes = list(self._probes.items())
        values: dict = {}
        for name, (probe, _kind, rate, _bound) in probes:
            try:
                v = _num(probe())
            except Exception:
                v = None            # a broken probe must not stall sampling
            if v is None:
                continue
            series = f"Resource.{name}"
            values[series] = v
            with self._lock:
                self._last[name] = v
                if rate:
                    prev = self._rate_prev.get(name)
                    self._rate_prev[name] = (t, v)
                    if prev is not None and t > prev[0]:
                        values[f"{series}.Rate"] = \
                            max(0.0, v - prev[1]) / (t - prev[0])
        if store is not None:
            store.record_many(values, t=t)
        if watch is not None:
            watch.observe_many({k: v for k, v in values.items()
                                if not k.endswith(".Rate")})
        return values

    def sizes(self) -> dict:
        """{name: last sampled value} — the /debug/soak live view."""
        with self._lock:
            return dict(self._last)


# ---------------------------------------------------------------------------
# Leak detector
# ---------------------------------------------------------------------------

def theil_sen_slope(points) -> float:
    """Median of pairwise slopes over [(t, v), ...] — the robust trend
    estimator: a single chaos-window step or outlier bucket moves the
    median far less than a least-squares fit. O(n²) pairs, fine for ring
    snapshots (≤ 240 rows)."""
    slopes = []
    pts = [(t, v) for t, v in points]
    for i in range(len(pts)):
        t0, v0 = pts[i]
        for j in range(i + 1, len(pts)):
            t1, v1 = pts[j]
            if t1 != t0:
                slopes.append((v1 - v0) / (t1 - t0))
    if not slopes:
        return 0.0
    slopes.sort()
    n = len(slopes)
    mid = n // 2
    return slopes[mid] if n % 2 else (slopes[mid - 1] + slopes[mid]) / 2.0


def leak_verdict(rows, kind: str = "bounded", min_points: int = 5,
                 rel_slope_per_s: float = 1e-4,
                 abs_slope_per_s: float = 0.05,
                 bound: float | None = None,
                 final_level: float | None = None) -> dict:
    """Classify one series' retained ring rows (``[t, n, min, max, mean,
    last]``, oldest first) as ``bounded | growing | leaking``.

    The fit runs over the **recent half** of the window (at least
    ``min_points``), so a structure that stepped up once and then
    plateaued — the signature of a chaos window or a warmup phase — reads
    bounded, while only *sustained* recent growth trips the verdict.
    Growth counts as sustained when the Theil–Sen slope exceeds both an
    absolute floor (``abs_slope_per_s`` units/s — sampling noise on tiny
    structures) and a relative one (``rel_slope_per_s`` × the median
    level — 0.01%/s ≈ doubling in under ~2 h). ``kind="grows"`` caps the
    verdict at ``growing`` (growth is that structure's contract);
    ``kind="bounded"`` escalates it to ``leaking``. When the structure's
    capacity is declared (``bound``), growth while still under it is the
    structure FILLING as designed — reported ``bounded`` with
    ``filling=True`` and the slope, never ``leaking`` (a fresh span ring
    would otherwise read as a leak for exactly as long as it takes to
    first reach capacity). ``final_level`` is the structure's live size
    at quiescence when the caller has one (a soak samples once more after
    the workload drains): a leak by definition persists after drain, so
    growth whose final level fell back to ≤ half the fitted level was
    in-flight backlog, not a leak — reported ``bounded`` with
    ``drained=True`` (checkpoint stores and reservation maps oscillate
    with load and would otherwise flake on short windows). Fewer than
    ``min_points`` rows is honest ignorance: ``bounded`` with the point
    count reported."""
    pts = []
    for row in rows or ():
        if not isinstance(row, (list, tuple)) or len(row) < 6:
            continue
        t, mean = _num(row[0]), _num(row[4])
        if t is not None and mean is not None:
            pts.append((t, mean))
    pts.sort()
    out = {"verdict": "bounded", "points": len(pts),
           "slope_per_s": 0.0, "doubling_s": None, "level": 0.0}
    if len(pts) < min_points:
        return out
    tail = pts[max(len(pts) // 2, len(pts) - 240):]
    if len(tail) < min_points:
        tail = pts[-min_points:]
    levels = sorted(v for _t, v in tail)
    level = levels[len(levels) // 2]
    slope = theil_sen_slope(tail)
    out["level"] = round(level, 4)
    out["slope_per_s"] = round(slope, 6)
    threshold = max(abs_slope_per_s, rel_slope_per_s * max(abs(level), 1.0))
    if slope <= threshold:
        return out
    out["doubling_s"] = round(level / slope, 1) if level > 0 else 0.0
    if final_level is not None and final_level <= 0.5 * max(level, 1.0):
        out["drained"] = True        # did not survive quiescence: backlog
        return out
    if kind == "bounded" and bound is not None and level < 0.98 * bound:
        out["filling"] = True        # under its declared cap: fill, not leak
        return out
    out["verdict"] = "growing" if kind == "grows" else "leaking"
    return out


# ---------------------------------------------------------------------------
# Subsystem CPU profiler
# ---------------------------------------------------------------------------

#: The component taxonomy — the same subsystem vocabulary critpath and
#: the stage histograms blame by, now as CPU-share buckets. ``other`` is
#: everything unmatched (driver loops, flow bodies, crypto math) so the
#: shares always sum to 100% of busy samples.
CPU_COMPONENTS = ("raft_pump", "commit_cutter", "batcher_dispatch",
                  "batcher_prep", "flow_scheduler", "serialization",
                  "network", "observability", "other")

#: Components on the notarised-commit path — ``top_commit_path`` names
#: the biggest of these, the headline for the native-raft decision.
COMMIT_PATH_COMPONENTS = ("raft_pump", "commit_cutter", "batcher_dispatch",
                          "batcher_prep", "flow_scheduler", "serialization",
                          "network")

#: thread-name prefixes → component (checked before any frame rule: a
#: pump thread is pump work no matter which helper it is inside)
_THREAD_RULES = (
    ("ledger-raft-pump", "raft_pump"),
    ("sweep-pump", "raft_pump"),
    ("group-commit-tick", "commit_cutter"),
    ("sig-batcher-prep", "batcher_prep"),
    ("sig-batcher-finish", "batcher_prep"),
    ("sig-batcher", "batcher_dispatch"),
    ("tcp-messaging", "network"),
    ("fleet-pump", "network"),
    ("soak-cpu-profiler", "observability"),
    ("soak-sampler", "observability"),
)

#: path fragments → component, innermost frame wins (os.sep-normalized)
_FRAME_RULES = (
    ("observability/", "observability"),
    ("tools/webserver", "observability"),
    ("consensus/raft", "raft_pump"),          # raft.py, raftcore.py, raft_*
    ("consensus/commit_pipeline", "commit_cutter"),
    ("consensus/sharded_uniqueness", "commit_cutter"),
    ("consensus/provider", "commit_cutter"),
    ("verifier/batcher", "batcher_dispatch"),
    ("verifier/", "batcher_dispatch"),
    ("ops/", "batcher_prep"),
    ("core/serialization/", "serialization"),
    ("node/statemachine", "flow_scheduler"),
    ("flows/", "flow_scheduler"),
    ("network/", "network"),
    ("testing/mock", "network"),
)

#: stdlib wait frames: a sample whose innermost frames sit here is a
#: thread parked in the interpreter's own blocking machinery
_WAIT_FUNCS = frozenset({
    "wait", "wait_for", "_wait_for_tstate_lock", "acquire", "get", "select",
    "poll", "result", "join", "accept", "recv", "readinto", "serve_forever",
})
_WAIT_FILES = ("threading.py", "queue.py", "selectors.py", "socketserver.py",
               "concurrent/futures/", "socket.py", "ssl.py")

#: source-line substrings marking a C-level block the frame stack cannot
#: show (time.sleep leaves the CALLER's frame innermost)
_WAIT_LINE_MARKERS = ("sleep(", ".wait(", ".acquire(", ".join(",
                      ".select(", ".get(", ".result(")


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def is_wait_frame(filename: str, funcname: str, lineno: int = 0) -> bool:
    """True when this (innermost) frame is blocking, not burning CPU."""
    fn = _norm(filename)
    if funcname in _WAIT_FUNCS and any(w in fn for w in _WAIT_FILES):
        return True
    if lineno:
        line = linecache.getline(filename, lineno)
        if line and any(m in line for m in _WAIT_LINE_MARKERS):
            return True
    return False


def classify_stack(thread_name: str, frames) -> str:
    """Map one thread sample to its component. ``frames`` is
    [(filename, funcname), ...] innermost first. Thread-name rules win
    (a dedicated subsystem thread is that subsystem's time regardless of
    the helper it is inside); otherwise the innermost frame matching a
    path rule decides; unmatched work is ``other``."""
    name = thread_name or ""
    for prefix, comp in _THREAD_RULES:
        if name.startswith(prefix):
            return comp
    for filename, _func in frames:
        fn = _norm(filename)
        for frag, comp in _FRAME_RULES:
            if frag in fn:
                return comp
    return "other"


class SubsystemProfiler:
    """Wall-clock sampling profiler: every ``interval_s`` it snapshots
    ``sys._current_frames()``, drops threads parked in a blocking call
    (see :func:`is_wait_frame`), and attributes each busy thread's stack
    to a :data:`CPU_COMPONENTS` bucket. ``snapshot()["shares_pct"]``
    sums to 100.0 of busy samples (0 when nothing was busy yet)."""

    def __init__(self, interval_s: float = 0.02):
        self.interval_s = max(0.001, interval_s)
        self._lock = threading.Lock()
        self._busy: dict = {c: 0 for c in CPU_COMPONENTS}
        self.samples = 0        # thread-samples taken (busy + idle)
        self.idle_samples = 0
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- sampling ------------------------------------------------------------
    def sample_once(self, current_frames=None, thread_names=None) -> None:
        """One sampling tick. Injectable ``current_frames`` (id →
        frame-like with f_code/f_back) and ``thread_names`` (id → name)
        keep the unit tests off real thread timing."""
        if current_frames is None:
            current_frames = sys._current_frames()
        if thread_names is None:
            thread_names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        busy: dict = {}
        n_samples = n_idle = 0
        for tid, frame in current_frames.items():
            if tid == me:
                continue            # never profile the profiler's own loop
            frames = []
            f = frame
            while f is not None and len(frames) < 25:
                frames.append((f.f_code.co_filename, f.f_code.co_name,
                               f.f_lineno))
                f = f.f_back
            if not frames:
                continue
            n_samples += 1
            innermost = frames[0]
            if is_wait_frame(*innermost):
                n_idle += 1
                continue
            comp = classify_stack(thread_names.get(tid, ""),
                                  [(fn, fu) for fn, fu, _ln in frames])
            busy[comp] = busy.get(comp, 0) + 1
        with self._lock:
            self.ticks += 1
            self.samples += n_samples
            self.idle_samples += n_idle
            for comp, n in busy.items():
                self._busy[comp] = self._busy.get(comp, 0) + n

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                pass                # profiling must never take the node down

    def start(self) -> "SubsystemProfiler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="soak-cpu-profiler")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)

    # -- reading -------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            busy = dict(self._busy)
            samples, idle = self.samples, self.idle_samples
            ticks = self.ticks
        total_busy = sum(busy.values())
        shares = {c: (round(100.0 * n / total_busy, 2) if total_busy else 0.0)
                  for c, n in busy.items()}
        top = max(COMMIT_PATH_COMPONENTS,
                  key=lambda c: shares.get(c, 0.0)) if total_busy else None
        return {
            "ticks": ticks,
            "samples": samples,
            "busy_samples": total_busy,
            "idle_samples": idle,
            "busy_frac": round(total_busy / samples, 4) if samples else 0.0,
            "shares_pct": shares,
            "share_sum_pct": round(sum(shares.values()), 2),
            "top_commit_path": top,
        }


# ---------------------------------------------------------------------------
# process-global registry seam (same shape as get_tracer/get_timeseries)
# ---------------------------------------------------------------------------

_global_lock = threading.Lock()
_global_registry: ResourceRegistry | None = None


def get_resources() -> ResourceRegistry:
    """The process-global resource registry (created on first use)."""
    global _global_registry
    with _global_lock:
        if _global_registry is None:
            _global_registry = ResourceRegistry()
        return _global_registry


def set_resources(registry: ResourceRegistry | None
                  ) -> "ResourceRegistry | None":
    """Swap the process-global registry (tests/harness); returns the old
    one so callers can restore it."""
    global _global_registry
    with _global_lock:
        prev, _global_registry = _global_registry, registry
        return prev
