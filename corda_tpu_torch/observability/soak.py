"""Soak observatory: drift-gated endurance runs over the ledger harness.

Every measurement plane so far observes seconds-to-minutes; the
production failure modes ROADMAP item 5 names — raft logs and
CoordinatorLogs growing unboundedly, span-ring/timeline eviction under
sustained churn, SLO budgets over multi-window horizons — only appear at
tens-of-minutes timescales. The soak mode runs the real open-loop ledger
scenario (observability/ledger_harness.py) for ``minutes`` at a steady
offered rate with **chaos windows recurring on a schedule** (not the
one-shot three-window script), and layers four soak-only instruments on
top via the harness's observer hook:

- **resource accounting** (resprof.ResourceRegistry): every
  bounded/growing structure in the topology registers a size probe —
  raft logs per group, CoordinatorLog bytes, the span ring + its drop
  counter (windowed rate), vault state sets, the staging pool,
  checkpoint stores, reservation maps, the time-series rings themselves,
  process RSS — sampled every second into the retained time-series plane
  and fed through the leak detector at the end: per-structure verdict
  ``bounded | growing | leaking`` with slope and projected doubling time;
- **subsystem CPU attribution** (resprof.SubsystemProfiler): wall-clock
  stack sampling mapped to the component taxonomy, so the artifact says
  where interpreter CPU went on the commit path (the ROADMAP's
  native-raft decision input);
- **phase segmentation**: per-minute committed-rate / tail-latency /
  error-budget rows (``soak_phases``), the series the drift gates fit;
- **mid-run invariant re-checks**: every ``invariant_check_s`` the
  exactly-once property is re-verified over everything committed so far
  (no replica may attribute a consumed ref to the wrong transaction) —
  a soak that only checks invariants at the end can run broken for 29
  of its 30 minutes.

**Drift gates**: robust (Theil–Sen) slopes over the per-phase committed
rate and e2e p99, expressed as %-of-mean per minute against declared
bounds, plus the leak verdicts and the invariant re-checks, become
BENCH-INVALID probes in ``bench.py --soak`` and the ``SOAK_REQUIRED`` /
``guard_soak`` gate in tools/benchguard.py. ``tools/scenario.py --soak
MINUTES`` runs the same thing interactively and exits 1 on any breach.

Surfaces: ``soak_report()`` behind ``/debug/soak`` + the rpc op, the
``Resource.*`` series on ``/api/timeseries``, and soak sections in
``consensus_stat`` / ``fleetstat``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from .resprof import (ResourceRegistry, SubsystemProfiler, leak_verdict,
                      process_rss_bytes, set_resources, theil_sen_slope)

__all__ = [
    "SoakConfig", "SoakObserver", "run_soak", "soak_report",
    "soak_drift_fields", "verdict_rows", "get_cpu_profiler",
    "set_cpu_profiler",
]


def _pctl(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


@dataclass
class SoakConfig:
    """Knobs for one endurance run. The default is the measured shape —
    a ≥10-minute sharded-notary soak with recurring chaos; ``smoke()``
    is the ~20 s injected-everything tier-1 shape that asserts the same
    artifact schema without the wall clock."""

    minutes: float = 10.0
    parties: int = 6
    coins_per_party: int = 3
    #: steady offered load, held WELL below the flows-scenario capacity
    #: so a throughput drift reads as degradation, not saturation noise
    rate_tx_per_sec: float = 6.0
    node_concurrency: int = 2
    shards: int = 2
    cross_shard_pct: float = 0.25
    settle_fraction: float = 0.10
    seed: int = 7
    #: recurring chaos: one window (cycling partition → leader-kill →
    #: append-drop) every period, each ``chaos_window_s`` wide
    chaos: bool = True
    chaos_period_s: float = 75.0
    chaos_window_s: float = 2.5
    chaos_append_drop_p: float = 0.15
    #: bounded-state consensus (ISSUE 20): arm raft snapshot compaction
    #: and CoordinatorLog GC so the endurance run's log structures
    #: sawtooth instead of growing monotonically. With these set the
    #: RaftLog/CoordinatorLog probes are declared ``bounded`` with the
    #: 2×-threshold sawtooth cap as their bound — sustained growth past
    #: it is a LEAK verdict, which the soak gate fails on.
    raft_snapshot_entries: int | None = 64
    coordlog_compact_bytes: int | None = 65536
    #: phase (segment) length for the per-minute artifact series
    phase_s: float = 60.0
    #: resource-probe sampling cadence into the retained plane
    sample_interval_s: float = 1.0
    #: mid-run exactly-once re-check cadence
    invariant_check_s: float = 60.0
    cpu_sample_interval_s: float = 0.02
    provider_timeout_s: float = 5.0
    #: declared drift gates, %-of-mean per minute over the phase series:
    #: committed rate may not trend below the floor, e2e p99 not above
    #: the ceiling. Full runs enforce them; smoke records them only.
    throughput_gate_pct_per_min: float = -3.0
    p99_gate_pct_per_min: float = 6.0
    mode: str = "soak"
    #: the device of the ledger scenario's nodes and shared verifier
    #: ("cuda", raising without CUDA; tests pass "cpu")
    device: str = "cuda"

    @staticmethod
    def smoke(seed: int = 7) -> "SoakConfig":
        """Tier-1 shape: ~20 s of real load, everything else accelerated
        (5 s phases, 6 s chaos period, 4 s invariant cadence) so the
        artifact carries the full schema — phases, verdicts, CPU shares,
        drift slopes, re-checks — without the endurance wall clock."""
        return SoakConfig(
            minutes=0.35, parties=3, coins_per_party=2,
            rate_tx_per_sec=6.0, shards=2, cross_shard_pct=0.25,
            settle_fraction=0.0, seed=seed,
            chaos_period_s=6.0, chaos_window_s=0.8,
            phase_s=5.0, sample_interval_s=0.4, invariant_check_s=4.0,
            cpu_sample_interval_s=0.01,
            raft_snapshot_entries=8, coordlog_compact_bytes=4096,
            mode="soak-smoke")


class _RecurringChaos:
    """Chaos that recurs for as long as the run does: every
    ``period_s`` one window arms, cycling partition-follower →
    leader-kill → append-drop, each ``window_s`` wide. Same fault rules
    as the one-shot ledger schedule; annotations carry the cycle index
    so a drift in phase 7 reads against the window that caused it."""

    KINDS = ("partition_follower", "leader_kill", "append_drop")

    def __init__(self, cfg: SoakConfig, raft_nodes):
        self.cfg = cfg
        self.raft_nodes = raft_nodes
        self.cycle = 0
        self._active = None        # {"kind", "end_s", "detail", "start_s"}
        self.annotations: list[dict] = []
        #: first window waits one full period — phase 0 measures the
        #: undisturbed baseline the drift fit anchors on
        self._next_start = cfg.chaos_period_s

    def _rules(self, kind: str):
        from ..consensus.raft import LEADER
        from ..utils.faults import FaultRule
        if kind == "append_drop":
            return ([FaultRule("raft.append", "drop",
                               probability=self.cfg.chaos_append_drop_p)],
                    f"p={self.cfg.chaos_append_drop_p}")
        leaders = [rn.node_id for rn in self.raft_nodes
                   if getattr(rn, "role", None) == LEADER]
        followers = [rn.node_id for rn in self.raft_nodes
                     if rn.node_id not in leaders]
        if kind == "leader_kill" and leaders:
            target = leaders[0]
        else:
            target = (followers or [self.raft_nodes[-1].node_id])[0]
        return ([FaultRule("net.send", "drop", detail=f"{target}->*"),
                 FaultRule("net.send", "drop", detail=f"*->{target}")],
                target)

    def tick(self, now_s: float) -> None:
        from ..utils import faults
        if self._active is not None:
            if now_s >= self._active["end_s"]:
                inj = faults.active()
                faults.disarm()
                self._active["faults_fired"] = len(inj.log) if inj else 0
                self._active["end_s"] = round(now_s, 3)
                self.annotations.append(self._active)
                self._active = None
            return
        if now_s < self._next_start:
            return
        kind = self.KINDS[self.cycle % len(self.KINDS)]
        rules, detail = self._rules(kind)
        inj = faults.FaultInjector(seed=self.cfg.seed + self.cycle)
        for r in rules:
            inj.add(r)
        faults.arm(inj)
        self._active = {"kind": kind, "cycle": self.cycle,
                        "start_s": round(now_s, 3),
                        "end_s": now_s + self.cfg.chaos_window_s,
                        "detail": detail}
        self.cycle += 1
        self._next_start += self.cfg.chaos_period_s

    def close(self, now_s: float) -> None:
        from ..utils import faults
        if self._active is not None:
            inj = faults.active()
            faults.disarm()
            self._active["faults_fired"] = len(inj.log) if inj else 0
            self._active["end_s"] = round(now_s, 3)
            self.annotations.append(self._active)
            self._active = None


def verdict_rows(rings: list) -> list:
    """Pick the ring a leak fit should run over: the coarsest resolution
    holding at least 5 points (the 60 s ring on a real soak), falling
    back to the best-populated finer ring on short/smoke runs."""
    best: list = []
    for ring in rings or ():
        points = ring.get("points") if isinstance(ring, dict) else None
        if not isinstance(points, list):
            continue
        if len(points) >= 5:
            best = points          # rings come finest-first: keep coarsest
        elif not best and len(points) > len(best):
            best = points
    if not best:
        for ring in rings or ():
            points = ring.get("points") if isinstance(ring, dict) else None
            if isinstance(points, list) and len(points) > len(best):
                best = points
    return best


def soak_drift_fields(phases: list, throughput_gate: float,
                      p99_gate: float) -> dict:
    """Theil–Sen slopes over the per-phase committed rate and e2e p99,
    normalized to %-of-mean per minute, checked against the declared
    gates. Fewer than 3 complete phases is honest zero drift (a smoke
    run's 4×5 s phases still exercise the fit)."""
    rate_pts = [(p["t_s"], p["committed_tx_per_sec"]) for p in phases
                if isinstance(p.get("committed_tx_per_sec"), (int, float))]
    p99_pts = [(p["t_s"], p["e2e_ms_p99"]) for p in phases
               if isinstance(p.get("e2e_ms_p99"), (int, float))
               and p.get("e2e_ms_p99", 0) > 0]

    def pct_per_min(pts) -> float:
        if len(pts) < 3:
            return 0.0
        mean = sum(v for _t, v in pts) / len(pts)
        if mean <= 0:
            return 0.0
        return round(theil_sen_slope(pts) / mean * 100.0 * 60.0, 3)

    tp = pct_per_min(rate_pts)
    p99 = pct_per_min(p99_pts)
    return {
        "soak_throughput_slope_pct_per_min": tp,
        "soak_p99_slope_pct_per_min": p99,
        "soak_throughput_gate_pct_per_min": throughput_gate,
        "soak_p99_gate_pct_per_min": p99_gate,
        "soak_drift_ok": tp >= throughput_gate and p99 <= p99_gate,
    }


class SoakObserver:
    """The harness hook object (``LedgerScenarioConfig.observer``):
    ``on_start(ctx)`` registers the topology's resource probes and
    starts the CPU profiler, ``on_tick(now_rel)`` runs on every driver
    iteration (same thread as the workload bookkeeping — no locking
    against ``latencies``/``final_counts`` needed), ``finalize(report)``
    computes the verdicts/drift/CPU fields into the artifact, and
    ``close()`` is the finally-block teardown."""

    def __init__(self, cfg: SoakConfig):
        self.cfg = cfg
        self.resources = ResourceRegistry()
        self.profiler = SubsystemProfiler(
            interval_s=cfg.cpu_sample_interval_s)
        self.chaos: _RecurringChaos | None = None
        self.phases: list[dict] = []
        self.invariant_checks: list[dict] = []
        self._ctx: dict = {}
        self._prev_resources = None
        self._prev_profiler = None
        self._last_sample = 0.0
        self._last_invariant = 0.0
        self._phase_start = 0.0
        self._phase_committed = 0
        self._phase_lat_base = 0
        self._started_monotonic = 0.0

    # -- harness hooks -------------------------------------------------------
    def on_start(self, ctx: dict) -> None:
        self._ctx = ctx
        cfg = self.cfg
        if cfg.chaos:
            self.chaos = _RecurringChaos(cfg, ctx["raft_nodes"])
        self._register_probes(ctx)
        self._prev_resources = set_resources(self.resources)
        self._prev_profiler = set_cpu_profiler(self.profiler)
        self.profiler.start()
        self._started_monotonic = time.monotonic()
        # t=0 baseline sample so every probe's series exists immediately
        self.resources.sample(store=ctx.get("ts_store"),
                              watch=ctx.get("growth"))

    def on_tick(self, now_rel: float) -> None:
        if self.chaos is not None:
            self.chaos.tick(now_rel)
        if now_rel - self._last_sample >= self.cfg.sample_interval_s:
            self._last_sample = now_rel
            try:
                self.resources.sample(store=self._ctx.get("ts_store"),
                                      watch=self._ctx.get("growth"))
            except Exception:
                pass               # observability must never stall the run
        if now_rel - self._phase_start >= self.cfg.phase_s:
            self._seal_phase(now_rel)
        if now_rel - self._last_invariant >= self.cfg.invariant_check_s:
            self._last_invariant = now_rel
            self.invariant_checks.append(self._check_invariants(now_rel))

    def on_drain(self, end_rel: float) -> None:
        """Workload drained: stop recurring chaos and seal the partial
        phase so ``soak_phases`` accounts for every committed op."""
        if self.chaos is not None:
            self.chaos.close(end_rel)
        if end_rel - self._phase_start > 0.5:
            self._seal_phase(end_rel)
        self.invariant_checks.append(self._check_invariants(end_rel))

    def close(self) -> None:
        self.profiler.stop()
        set_resources(self._prev_resources)
        set_cpu_profiler(self._prev_profiler)

    # -- probes --------------------------------------------------------------
    def _register_probes(self, ctx: dict) -> None:
        """Wire every structure the topology owns into the accounting
        plane. Probes are defensive closures over live objects; a probe
        whose surface is absent simply never registers."""
        reg = self.resources
        cfg = ctx.get("cfg")
        # bounded-state consensus (ISSUE 20): with compaction armed the
        # raft log's contract flips from "grows until GC" to a bounded
        # sawtooth — declare it so, with 2× the snapshot threshold as
        # the cap, and the leak gate enforces the invariant the whole
        # soak long. Without compaction the honest declaration stays
        # "grows" (the pre-r06 unbounded-log hazard, named in ROADMAP).
        snap_thr = getattr(cfg, "raft_snapshot_entries", None)
        for label, nodes in (ctx.get("raft_groups") or {}).items():
            def probe(nodes=nodes):
                return max((len(getattr(rn.state, "log", ()))
                            for rn in nodes), default=0)
            if snap_thr:
                reg.register(f"RaftLog.{label}", probe, kind="bounded",
                             bound=2.0 * snap_thr)
            else:
                reg.register(f"RaftLog.{label}", probe, kind="grows")
        sharded = ctx.get("sharded")
        if sharded is not None:
            log = getattr(sharded, "log", None)
            if log is not None:
                probe = lambda log=log: getattr(log, "bytes_appended", 0)
                gc_thr = getattr(cfg, "coordlog_compact_bytes", None)
                if gc_thr:
                    reg.register("CoordinatorLog.Bytes", probe,
                                 kind="bounded", bound=2.0 * gc_thr)
                else:
                    reg.register("CoordinatorLog.Bytes", probe,
                                 kind="grows")
        from .tracing import get_tracer
        ring = getattr(get_tracer(), "ring", None)
        if ring is not None:
            reg.register("Tracing.SpanRing", lambda r=ring: len(r),
                         kind="bounded",
                         bound=getattr(ring, "capacity", None))
            reg.register("Tracing.SpansDropped",
                         lambda r=ring: getattr(r, "dropped", 0),
                         kind="grows", rate=True)
        verifier = ctx.get("verifier")
        rlog = getattr(verifier, "request_log", None)
        if rlog is not None:
            reg.register("Requests.Timelines", lambda rl=rlog: len(rl),
                         kind="bounded",
                         bound=getattr(rlog, "capacity", None))
            reg.register("Requests.TimelineEvictions",
                         lambda rl=rlog: getattr(rl, "dropped", 0),
                         kind="grows", rate=True)
        network = ctx.get("network")
        if network is not None:
            def vault_states(net=network):
                total = 0
                for node in getattr(net, "nodes", ()):
                    vault = getattr(node.services, "vault", None)
                    total += len(getattr(vault, "_unconsumed", ())) \
                        + len(getattr(vault, "_consumed", ()))
                return total
            reg.register("Vault.States", vault_states, kind="grows")

            def checkpoints(net=network):
                total = 0
                for node in getattr(net, "nodes", ()):
                    smm = getattr(node, "smm", None)
                    store = getattr(smm, "checkpoints", None)
                    total += len(getattr(store, "_checkpoints", ()))
                return total
            reg.register("Checkpoints.Stored", checkpoints, kind="bounded")
        machines = ctx.get("machines")
        if machines:
            reg.register(
                "Shard.ReservedRefs",
                lambda ms=machines: sum(len(getattr(m, "_reserved", ()))
                                        for m in ms),
                kind="bounded")
        try:
            from ..ops.staging import get_staging_pool
            pool = get_staging_pool()
            reg.register(
                "Staging.Buffers",
                lambda p=pool: sum(len(v)
                                   for v in getattr(p, "_free", {}).values())
                + len(getattr(p, "_attached", ())),
                kind="bounded")
        except Exception:
            pass
        store = ctx.get("ts_store")
        if store is not None:
            def ts_buckets(s=store):
                total = 0
                for series in getattr(s, "_series", {}).values():
                    for ring_ in series.rings:
                        total += len(ring_.closed)
                return total
            # bounded by construction at sum(ring capacities) × series,
            # but it FILLS over the first coarsest-horizon: grows
            reg.register("Timeseries.Buckets", ts_buckets, kind="grows")
        reg.register("Process.RSSBytes", process_rss_bytes, kind="grows")

    # -- phase segmentation --------------------------------------------------
    def _seal_phase(self, now_rel: float) -> None:
        ctx = self._ctx
        committed = ctx["final_counts"]["committed"]
        latencies = ctx["latencies"]
        window = sorted(latencies[self._phase_lat_base:])
        dt = max(1e-9, now_rel - self._phase_start)
        status = None
        slo = ctx.get("slo")
        if slo is not None:
            try:
                status = slo.status()
            except Exception:
                status = None
        budgets = [o.get("error_budget_pct")
                   for o in (status or {}).get("objectives", {}).values()
                   if isinstance(o, dict)]
        budgets = [b for b in budgets
                   if isinstance(b, (int, float)) and not isinstance(b, bool)]
        self.phases.append({
            "phase": len(self.phases),
            "t_s": round(self._phase_start, 3),
            "duration_s": round(dt, 3),
            "committed": committed - self._phase_committed,
            "committed_tx_per_sec":
                round((committed - self._phase_committed) / dt, 3),
            "e2e_ms_p50": round(_pctl(window, 0.50) * 1000, 3),
            "e2e_ms_p99": round(_pctl(window, 0.99) * 1000, 3),
            "slo_error_budget_pct":
                round(min(budgets), 3) if budgets else 100.0,
        })
        self._phase_start = now_rel
        self._phase_committed = committed
        self._phase_lat_base = len(latencies)

    # -- mid-run invariants --------------------------------------------------
    def _check_invariants(self, now_rel: float) -> dict:
        """Exactly-once over everything committed SO FAR: a replica that
        has applied a consumed ref must attribute it to the transaction
        that committed it (absence is fine mid-run — followers lag), and
        the reservation maps carry only in-flight work. Runs on the
        driver thread, so the committed list is stable underneath it."""
        from ..consensus.sharded_uniqueness import shard_of
        ctx = self._ctx
        shard_machines = ctx["shard_machines"]
        n_shards = len(shard_machines)
        conflicts = 0
        checked = 0
        for tx_id, refs in list(ctx["committed_notarised"]):
            for ref in refs:
                for m in shard_machines[shard_of(ref, n_shards)]:
                    details = getattr(m, "_map", {}).get(ref)
                    checked += 1
                    if details is not None and details.consuming_tx != tx_id:
                        conflicts += 1
        reserved = sum(len(getattr(m, "_reserved", ()))
                       for m in ctx.get("machines", ()))
        return {"t_s": round(now_rel, 3), "checked": checked,
                "conflicts": conflicts, "reserved_inflight": reserved,
                "ok": conflicts == 0}

    # -- artifact ------------------------------------------------------------
    def finalize(self, report: dict) -> None:
        cfg = self.cfg
        ctx = self._ctx
        store = ctx.get("ts_store")
        kinds = self.resources.kinds()
        bounds = self.resources.bounds()
        # one closing read AFTER the workload drained: it lands the
        # quiescent level in the retained series, carries the final
        # windowed ``.Rate`` values, and lets the verdict distinguish
        # in-flight backlog (drains to ~0) from a real leak (persists)
        last = self.resources.sample(store=store)
        verdicts: dict = {}
        if store is not None:
            snap = store.snapshot()
            for name, kind in sorted(kinds.items()):
                rings = snap["series"].get(f"Resource.{name}")
                verdicts[name] = leak_verdict(
                    verdict_rows(rings or []), kind=kind,
                    bound=bounds.get(name),
                    final_level=last.get(f"Resource.{name}"))
        leaking = sorted(n for n, v in verdicts.items()
                         if v["verdict"] == "leaking")
        cpu = self.profiler.snapshot()
        report["soak"] = True
        report["soak_minutes"] = cfg.minutes
        report["soak_phase_s"] = cfg.phase_s
        report["soak_phases"] = self.phases
        report["soak_chaos_cycles"] = \
            self.chaos.cycle if self.chaos is not None else 0
        report["soak_chaos_windows"] = \
            self.chaos.annotations if self.chaos is not None else []
        report["soak_resources"] = {
            n: round(v, 2) for n, v in sorted(
                self.resources.sizes().items())}
        report["soak_leak_verdicts"] = verdicts
        report["soak_leaking"] = leaking
        report["soak_leak_ok"] = not leaking
        report["soak_invariant_checks"] = self.invariant_checks
        report["soak_invariant_recheck_count"] = len(self.invariant_checks)
        report["soak_invariant_ok"] = bool(self.invariant_checks) and all(
            c["ok"] for c in self.invariant_checks)
        report["soak_cpu_shares_pct"] = cpu["shares_pct"]
        report["soak_cpu_share_sum_pct"] = cpu["share_sum_pct"]
        report["soak_cpu_samples"] = cpu["samples"]
        report["soak_cpu_busy_frac"] = cpu["busy_frac"]
        report["soak_cpu_top_commit_path"] = cpu["top_commit_path"] or ""
        # windowed churn rates (satellite: cumulative-only counters are
        # useless on a soak) — the most recent sampled Resource.*.Rate
        report["soak_spans_dropped_rate_per_s"] = round(
            last.get("Resource.Tracing.SpansDropped.Rate", 0.0), 3)
        report["soak_timeline_evictions_rate_per_s"] = round(
            last.get("Resource.Requests.TimelineEvictions.Rate", 0.0), 3)
        report.update(soak_drift_fields(
            self.phases[:-1] if len(self.phases) > 3 else self.phases,
            cfg.throughput_gate_pct_per_min, cfg.p99_gate_pct_per_min))
        report["mode"] = cfg.mode


def run_soak(cfg: SoakConfig | None = None) -> dict:
    """Build the endurance-shaped ledger scenario and run it under a
    :class:`SoakObserver`. The workload length IS the soak length:
    ``minutes × 60 × rate`` operations on the open-loop schedule."""
    from .ledger_harness import LedgerScenarioConfig, run_ledger_scenario

    cfg = cfg if cfg is not None else SoakConfig()
    operations = max(8, int(cfg.minutes * 60.0 * cfg.rate_tx_per_sec))
    lcfg = LedgerScenarioConfig(
        parties=cfg.parties, operations=operations,
        coins_per_party=cfg.coins_per_party,
        rate_tx_per_sec=cfg.rate_tx_per_sec,
        node_concurrency=cfg.node_concurrency,
        seed=cfg.seed, chaos=False,       # the observer drives recurrence
        settle_fraction=cfg.settle_fraction,
        shards=cfg.shards, cross_shard_pct=cfg.cross_shard_pct,
        raft_snapshot_entries=cfg.raft_snapshot_entries,
        coordlog_compact_bytes=cfg.coordlog_compact_bytes,
        provider_timeout_s=cfg.provider_timeout_s,
        max_duration_s=cfg.minutes * 60.0 + 120.0,
        mode=cfg.mode, observer=SoakObserver(cfg), device=cfg.device)
    return run_ledger_scenario(lcfg)


# ---------------------------------------------------------------------------
# live surface: /debug/soak + rpc soak_report
# ---------------------------------------------------------------------------

_prof_lock = threading.Lock()
_active_profiler: SubsystemProfiler | None = None


def get_cpu_profiler() -> "SubsystemProfiler | None":
    with _prof_lock:
        return _active_profiler


def set_cpu_profiler(profiler: "SubsystemProfiler | None"
                     ) -> "SubsystemProfiler | None":
    global _active_profiler
    with _prof_lock:
        prev, _active_profiler = _active_profiler, profiler
        return prev


def soak_report() -> dict:
    """The /debug/soak payload: every registered structure's live size,
    declared kind, and leak verdict over the retained ``Resource.*``
    series, plus the CPU-attribution snapshot when a profiler is
    running. Well-formed and empty on a node with no probes — scraping
    any node is safe."""
    from .resprof import get_resources
    from .timeseries import get_timeseries
    reg = get_resources()
    kinds = reg.kinds()
    sizes = reg.sizes()
    bounds = reg.bounds()
    snap = get_timeseries().snapshot(
        names=[f"Resource.{n}" for n in kinds]) if kinds else {"series": {}}
    resources = {}
    for name in sorted(kinds):
        rings = snap["series"].get(f"Resource.{name}")
        resources[name] = {
            "size": sizes.get(name),
            "kind": kinds[name],
            **leak_verdict(verdict_rows(rings or []), kind=kinds[name],
                           bound=bounds.get(name)),
        }
    prof = get_cpu_profiler()
    return {"resources": resources,
            "leaking": sorted(n for n, r in resources.items()
                              if r["verdict"] == "leaking"),
            "cpu": prof.snapshot() if prof is not None else None}
