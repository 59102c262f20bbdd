"""Consensus observatory: raft introspection pooling, shard heat rollup,
growth watchdogs, and the Raft.* metric families.

critpath blames ``raft.commit``/``raft.leaderless`` as the dominant tail
component (LEDGER_r03/r04) but nothing inside the consensus tier says
*why* — election churn vs per-append fsync vs replication RTT vs apply.
The raft nodes now self-attribute every committed entry
(``RaftNode.stats()`` / ``attribution_samples()``); this module is the
read side: it pools those per-node surfaces into one per-group report
(``raft_report`` → /debug/raft and fleetstat), flattens them into the
``ledger_raft_*`` bench artifact fields (benchguard-locked, with the
attribution-sum validity probe), installs the labeled ``Raft.*`` metric
families on a registry, feeds the retained time-series plane
(timeseries.py), and watches the two known growth hazards
(``Raft.LogEntries``, ``CoordinatorLog.Bytes``) for doubling within a
run. With compaction landed (ISSUE 20) those gauges are expected to
sawtooth: the watchdog resets its doubling baseline after each observed
shrink (``consensus.growth.compacted``) so a legitimate post-compaction
climb is measured from the new floor instead of warning spuriously.

Everything here is defensive: a node whose ``stats()`` is missing or
malformed contributes nothing rather than an exception — mixed
python/native fleets report whatever each implementation can attribute,
absent fields stay absent (never fabricated zeros).
"""
from __future__ import annotations

import logging
import math

from .slog import jlog

log = logging.getLogger("corda_tpu_torch.consensus_obs")

__all__ = [
    "ATTRIBUTION_COMPONENTS", "GrowthWatch", "install_raft_collector",
    "ledger_raft_fields", "pool_attribution", "pooled_percentiles",
    "raft_report", "sample_timeseries",
]

#: Per-entry commit attribution components, pipeline order. Their sum
#: telescopes to submit→apply-end by construction (contiguous perf_counter
#: clocks in RaftNode._record_attribution) — the conservation property the
#: bench validity probe locks against raft_commit_seconds.
ATTRIBUTION_COMPONENTS = ("append_wait", "fsync", "replicate", "apply")


def _num(v):
    """float(v) for real numbers, else None (bools excluded)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v) if math.isfinite(v) else None


def _pctl(sorted_samples, q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sample list."""
    if not sorted_samples:
        return 0.0
    rank = min(len(sorted_samples) - 1,
               max(0, int(math.ceil(q * len(sorted_samples))) - 1))
    return sorted_samples[rank]


def pool_attribution(nodes) -> dict:
    """Merge ``attribution_samples()`` across raft nodes (samples live on
    whichever node was leader when an entry committed, so a group's
    distribution is the union over its replicas). Nodes without the
    surface (native core) contribute nothing. Returns
    {component: [seconds, ...]} including "total"."""
    pooled: dict = {}
    for node in nodes:
        fn = getattr(node, "attribution_samples", None)
        if not callable(fn):
            continue
        try:
            samples = fn()
        except Exception:
            continue
        if not isinstance(samples, dict):
            continue
        for comp, values in samples.items():
            good = [v for v in (_num(x) for x in values) if v is not None]
            if good:
                pooled.setdefault(comp, []).extend(good)
    return pooled


def pooled_percentiles(pooled: dict) -> dict:
    """{component: {"n", "p50_ms", "p99_ms", "mean_ms"}} over pooled
    attribution samples; components with no samples are absent."""
    out = {}
    for comp, values in pooled.items():
        if not values:
            continue
        ordered = sorted(values)
        out[comp] = {
            "n": len(ordered),
            "p50_ms": _pctl(ordered, 0.50) * 1000.0,
            "p99_ms": _pctl(ordered, 0.99) * 1000.0,
            "mean_ms": sum(ordered) / len(ordered) * 1000.0,
        }
    return out


def _is_leader(stats: dict) -> bool:
    """Role match tolerant of case (raft.py uses "leader", an external
    payload may carry "LEADER")."""
    return str(stats.get("role", "")).lower() == "leader"


def _node_stats(node) -> dict | None:
    """One node's ``stats()``, or None when absent/malformed."""
    fn = getattr(node, "stats", None)
    if not callable(fn):
        return None
    try:
        stats = fn()
    except Exception:
        return None
    return stats if isinstance(stats, dict) else None


def raft_report(groups: dict, sharded=None) -> dict:
    """The /debug/raft payload. ``groups`` maps a group label (e.g. "s0")
    to its list of raft nodes (python or native, mixed is fine)::

        {"groups": {label: {"nodes": [stats...], "leader": stats|None,
                            "log_entries": int, "elections_total": int,
                            "attribution": {...}}},
         "shards": heat_stats()|None}

    Per group, ``leader`` is the stats dict of the node reporting
    role == "LEADER" (None during an election), ``log_entries`` is the
    max over replicas, and ``attribution`` pools every replica's exact
    samples (absent when no node can attribute — native parity rule).
    """
    out_groups = {}
    for label, nodes in sorted((groups or {}).items()):
        node_stats = [s for s in (_node_stats(n) for n in nodes)
                      if s is not None]
        leader = next((s for s in node_stats if _is_leader(s)), None)
        entry: dict = {
            "nodes": node_stats,
            "leader": leader,
            "log_entries": max(
                [v for v in (_num(s.get("log_entries"))
                             for s in node_stats) if v is not None],
                default=0),
            "elections_total": int(sum(
                v for v in (_num(s.get("elections_total"))
                            for s in node_stats) if v is not None)),
            # compaction surfaces (ISSUE 20): typed-default ints — a
            # native-only group reports zeros here (its per-NODE stats
            # stay honestly absent; the group rollup is an artifact
            # surface, so it keeps the always-present discipline)
            "snapshot_index": int(max(
                [v for v in (_num(s.get("snapshot_index"))
                             for s in node_stats) if v is not None],
                default=0)),
            "snapshots_taken": int(sum(
                v for v in (_num(s.get("snapshots_taken"))
                            for s in node_stats) if v is not None)),
            "installs_sent": int(sum(
                v for v in (_num(s.get("installs_sent"))
                            for s in node_stats) if v is not None)),
            "installs_received": int(sum(
                v for v in (_num(s.get("installs_received"))
                            for s in node_stats) if v is not None)),
            "snapshot_bytes": int(max(
                [v for v in (_num(s.get("snapshot_bytes"))
                             for s in node_stats) if v is not None],
                default=0)),
        }
        attribution = pooled_percentiles(pool_attribution(nodes))
        if attribution:
            entry["attribution"] = attribution
        out_groups[label] = entry
    report = {"groups": out_groups}
    if sharded is not None:
        try:
            report["shards"] = sharded.heat_stats()
        except Exception:
            report["shards"] = None
    return report


# -- Raft.* metric families ---------------------------------------------------

def install_raft_collector(metrics, groups_fn) -> None:
    """Register a collector on ``metrics`` emitting labeled ``Raft.*``
    gauge families per consensus group. ``groups_fn`` is a zero-arg
    callable returning the same {label: [nodes]} map raft_report takes
    (a callable so group membership may change under resharding). Fields
    a node cannot attribute are simply absent from the snapshot."""

    def collect() -> dict:
        out: dict = {}

        def emit(family: str, label: str, value) -> None:
            v = _num(value)
            if v is None:
                return
            # gauge_fn: the value-only gauge shape — prometheus_text
            # renders a plain ``_value`` sample (a full "gauge" snapshot
            # carries a high-water ``max`` field these collectors don't)
            out[f'{family}{{group="{label}"}}'] = {
                "type": "gauge_fn", "family": family,
                "labels": {"group": label}, "value": v}

        for label, nodes in (groups_fn() or {}).items():
            node_stats = [s for s in (_node_stats(n) for n in nodes)
                          if s is not None]
            if not node_stats:
                continue
            leader = next((s for s in node_stats if _is_leader(s)), None)
            emit("Raft.LogEntries", label,
                 max([v for v in (_num(s.get("log_entries"))
                                  for s in node_stats) if v is not None],
                     default=0))
            emit("Raft.Elections", label,
                 sum(v for v in (_num(s.get("elections_total"))
                                 for s in node_stats) if v is not None))
            # compaction family (ISSUE 20): absent-not-zero — emitted only
            # when at least one replica actually reports the field (the
            # native core does not)
            snap_idx = [v for v in (_num(s.get("snapshot_index"))
                                    for s in node_stats) if v is not None]
            if snap_idx:
                emit("Raft.SnapshotIndex", label, max(snap_idx))
            snaps = [v for v in (_num(s.get("snapshots_taken"))
                                 for s in node_stats) if v is not None]
            if snaps:
                emit("Raft.SnapshotsTaken", label, sum(snaps))
            installs = [v for v in (_num(s.get("installs_sent"))
                                    for s in node_stats) if v is not None]
            if installs:
                emit("Raft.InstallsSent", label, sum(installs))
            snap_bytes = [v for v in (_num(s.get("snapshot_bytes"))
                                      for s in node_stats) if v is not None]
            if snap_bytes:
                emit("Raft.SnapshotBytes", label, max(snap_bytes))
            if leader is not None:
                emit("Raft.CommitIndex", label, leader.get("commit_index"))
                emit("Raft.Term", label, leader.get("term"))
                emit("Raft.LeaderTenureSeconds", label,
                     leader.get("leader_tenure_s"))
                lag = leader.get("peer_lag")
                if isinstance(lag, dict) and lag:
                    vals = [v for v in (_num(x) for x in lag.values())
                            if v is not None]
                    if vals:
                        emit("Raft.ReplLagMax", label, max(vals))
                attrib = leader.get("attribution")
                if isinstance(attrib, dict):
                    fsync = attrib.get("fsync")
                    if isinstance(fsync, dict):
                        emit("Raft.FsyncP99Ms", label,
                             fsync.get("p99_ms"))
                    repl = attrib.get("replicate")
                    if isinstance(repl, dict):
                        emit("Raft.ReplicateP99Ms", label,
                             repl.get("p99_ms"))
        return out

    metrics.add_collector(collect)


# -- growth watchdogs ---------------------------------------------------------

class GrowthWatch:
    """Doubling detector for monotone soak gauges (Raft.LogEntries,
    CoordinatorLog.Bytes). The first observation of a series (above a
    noise floor) is its baseline; every time the value reaches 2× the
    last warned level it emits ONE jlog WARNING and re-arms at the new
    level — so a log growing without bound warns at 2×, 4×, 8×… instead
    of spamming every sample."""

    def __init__(self, logger=None, floor: float = 1024.0):
        self.floor = floor
        self.warnings = 0        # doubling warnings fired this run
        self.compactions = 0     # baseline resets after observed shrinks
        self._log = logger if logger is not None else log
        self._armed: dict = {}   # name -> level the next warning fires at 2×

    def observe(self, name: str, value) -> bool:
        """Feed one sample; returns True when a doubling warning fired.

        A sample well BELOW the armed level means the gauge was compacted
        (raft log truncation / CoordinatorLog GC): the doubling baseline
        resets to the post-compaction floor so the next legitimate 2× is
        measured from there — without this, a sawtoothing log would warn
        on every recovery climb (the ISSUE 20 false-alarm fix). The 0.9
        factor is hysteresis: leader churn can wobble a max-over-replicas
        gauge a few percent without any compaction happening."""
        v = _num(value)
        if v is None:
            return False
        level = self._armed.get(name)
        if level is not None and v < 0.9 * level:
            self.compactions += 1
            if v < self.floor:
                self._armed.pop(name, None)
            else:
                self._armed[name] = v
            jlog(self._log, "consensus.growth.compacted",
                 level=logging.INFO, gauge=name, value=v, previous=level,
                 reclaimed=round(level - v, 2))
            return False
        if v < self.floor:
            return False
        if level is None:
            self._armed[name] = v
            return False
        if v < 2.0 * level:
            return False
        self._armed[name] = v
        self.warnings += 1
        jlog(self._log, "consensus.growth.doubled",
             level=logging.WARNING, gauge=name, value=v, previous=level,
             factor=round(v / level, 2))
        return True

    def observe_many(self, values: dict) -> int:
        return sum(1 for name, v in (values or {}).items()
                   if self.observe(name, v))


# -- time-series + bench artifact flattening ----------------------------------

def sample_timeseries(store, groups: dict, sharded=None,
                      watch: GrowthWatch | None = None,
                      t: float | None = None, resources=None) -> dict:
    """One periodic sampling tick: record the soak-relevant consensus
    gauges into the retained time-series plane and (optionally) feed the
    growth watchdog. Returns {series name: value} for what was recorded.

    ``resources`` is an optional :class:`~.resprof.ResourceRegistry`:
    when given, every structure registered with the resource accounting
    plane is sampled in the same tick (``Resource.*`` series) and fed
    through the SAME watchdog — any registered probe gets doubling
    warnings for free, while the two historical hazards below keep their
    exact jlog series names (`Raft.LogEntries{...}`/`CoordinatorLog.Bytes`)
    so existing log pipelines stay byte-compatible."""
    values: dict = {}
    for label, nodes in (groups or {}).items():
        node_stats = [s for s in (_node_stats(n) for n in nodes)
                      if s is not None]
        if not node_stats:
            continue
        entries = max([v for v in (_num(s.get("log_entries"))
                                   for s in node_stats) if v is not None],
                      default=0)
        values[f'Raft.LogEntries{{group="{label}"}}'] = entries
        elections = sum(v for v in (_num(s.get("elections_total"))
                                    for s in node_stats) if v is not None)
        values[f'Raft.Elections{{group="{label}"}}'] = elections
    if sharded is not None:
        try:
            heat = sharded.heat_stats()
        except Exception:
            heat = None
        if isinstance(heat, dict):
            values["Shard.SkewIndex"] = heat.get("skew_index", 0.0)
            values["CoordinatorLog.Bytes"] = \
                heat.get("coordinator_log_bytes", 0)
    if store is not None:
        store.record_many(values, t=t)
    if watch is not None:
        watch.observe_many({k: v for k, v in values.items()
                            if k.startswith("Raft.LogEntries")
                            or k == "CoordinatorLog.Bytes"})
    if resources is not None:
        try:
            values.update(resources.sample(store=store, watch=watch, t=t))
        except Exception:
            pass   # a broken probe must not stall the consensus sampler
    return values


def ledger_raft_fields(groups: dict, round_samples=None) -> dict:
    """Flat ``ledger_raft_*`` artifact fields (benchguard-locked; always
    present with typed defaults — the group_commit_fields discipline).
    ``round_samples`` is the pooled list of exact per-batch consensus
    round durations (GroupCommitter.round_samples() across committers),
    the measured side of the attribution-sum validity probe."""
    pooled: dict = {}
    for nodes in (groups or {}).values():
        for comp, values in pool_attribution(nodes).items():
            pooled.setdefault(comp, []).extend(values)
    pct = pooled_percentiles(pooled)
    out: dict = {}
    for comp in ATTRIBUTION_COMPONENTS:
        stats = pct.get(comp) or {}
        out[f"ledger_raft_{comp}_ms_p50"] = round(
            float(stats.get("p50_ms", 0.0)), 4)
        out[f"ledger_raft_{comp}_ms_p99"] = round(
            float(stats.get("p99_ms", 0.0)), 4)
    total = pct.get("total") or {}
    out["ledger_raft_attrib_samples"] = int(total.get("n", 0))
    out["ledger_raft_attrib_sum_ms_p50"] = round(
        float(total.get("p50_ms", 0.0)), 4)
    rounds = [v for v in (_num(x) for x in (round_samples or ()))
              if v is not None]
    out["ledger_raft_round_ms_p50"] = round(
        _pctl(sorted(rounds), 0.50) * 1000.0, 4) if rounds else 0.0
    out["ledger_raft_elections_total"] = int(sum(
        v for g in (groups or {}).values()
        for v in (_num((_node_stats(n) or {}).get("elections_total"))
                  for n in g) if v is not None))
    # compaction rollup (ISSUE 20): typed-default ints over every replica
    # of every group — zeros on a native fleet (absent per-node stats),
    # real counts on compacting python replicas
    all_stats = [s for g in (groups or {}).values()
                 for s in (_node_stats(n) for n in g) if s is not None]

    def _agg(field, fn):
        vals = [v for v in (_num(s.get(field)) for s in all_stats)
                if v is not None]
        return int(fn(vals)) if vals else 0

    out["ledger_raft_snapshot_index"] = _agg("snapshot_index", max)
    out["ledger_raft_snapshots_taken"] = _agg("snapshots_taken", sum)
    out["ledger_raft_installs_sent"] = _agg("installs_sent", sum)
    out["ledger_raft_installs_received"] = _agg("installs_received", sum)
    out["ledger_raft_snapshot_bytes"] = _agg("snapshot_bytes", max)
    return out
