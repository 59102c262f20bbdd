"""End-to-end ledger scenario harness (ISSUE 10 tentpole).

Drives simulated parties through the real finance flows — cash
**issuance** (a bank node funds each party), **payments**
(CashPaymentFlow, notarised) and **settlement** (commercial-paper issue
followed by the SellerFlow DvP swap, notarised) — against a Raft notary
cluster with the port's verifier service on the commit path, and measures
what the whole ledger actually delivers: committed transactions per
second and end-to-end latency per transaction.

Open loop, coordinated-omission safe
------------------------------------
The workload generator assigns every operation an *intended* send time
on a fixed-rate schedule (``i / rate``) before the run starts. Latency
is measured from that intended time, not from when the driver finally
got around to launching the flow — so a stall in the system (a raft
election, a partition, a blocked notary) shows up as the tail latency
it really caused instead of silently pausing the load (the classic
coordinated-omission trap). Operations whose initiating node is busy
queue FIFO per node and keep their intended timestamps.

Topology (one process, MockNetwork)
-----------------------------------
- 1 validating notary node whose uniqueness provider is the leader of a
  3-replica Raft ``DistributedImmutableMap`` cluster (pure-Python
  replicas so the ``raft.submit`` spans stitch into the trace tree);
  replicas ride the in-memory bus and a background thread pumps their
  ticks, exactly the ``samples.notary_demo.run_raft_demo`` pattern.
- 1 bank node issuing cash, N party nodes trading it.
- ONE shared ``TpuTransactionVerifierService`` installed on every node
  and ONE shared ``MetricRegistry`` as every hub's ``monitoring``, so
  the commit-path stage histograms (``flow_run_seconds`` …
  ``vault_update_seconds``) aggregate across the fleet.
- An ``SLOTracker`` receives every operation outcome; its status is
  wired onto the notary hub (``/readyz`` surfaces it as
  ``degraded.slo``) and its gauges ride the shared registry.

Chaos
-----
``chaos=True`` schedules three windows over the run and arms the
process fault injector for each: a follower partition (drop
``net.send`` both directions), a leader kill (partition whoever leads
at window start — commits stall until the remaining replicas elect),
and a probabilistic ``raft.append`` drop window. Windows are annotated
in the report so a latency spike can be read against the fault that
caused it. Whatever happens, the invariant checked at the end is
exactly-once: every *accepted* transaction's inputs are consumed by
exactly that transaction on every replica, and the replicas agree.

The report feeds ``bench.py --ledger`` → ``LEDGER_r0*.json`` →
``tools/benchguard.py``.
"""
from __future__ import annotations

import logging
import os
import random
import tempfile
import threading
import time
from dataclasses import dataclass, field

from .critpath import ledger_critpath_fields
from .slo import DEFAULT_OBJECTIVES, SLOTracker
from .stages import (group_commit_fields, ledger_shard_fields,
                     ledger_stage_percentiles)

#: the span tree one committed, notarised transaction leaves behind when
#: every stage is instrumented and stitched (ISSUE 10 acceptance: these
#: appear under ONE trace id on /traces)
COMMIT_PATH_SPANS = ("flow.run", "tx.verify", "notary.uniqueness",
                     "raft.commit", "vault.update")


def connected_commit_traces(traces: dict,
                            required=COMMIT_PATH_SPANS) -> list[str]:
    """Trace ids whose span set covers the whole commit path — the
    stitching check. ``traces`` is ``Tracer.traces()`` output."""
    out = []
    for tid, spans in traces.items():
        names = {s.get("name") for s in spans}
        if all(r in names for r in required):
            out.append(tid)
    return out


@dataclass
class LedgerScenarioConfig:
    """Knobs for one scenario run. The defaults are the CPU smoke shape
    (small, chaos off, finishes in seconds under tier-1); ``full()`` is
    the measured configuration bench.py runs on real hardware."""

    parties: int = 3
    operations: int = 18          # issue ops included (coins × parties)
    coins_per_party: int = 3      # separate coins so concurrent spends
                                  # don't contend on one soft lock
    rate_tx_per_sec: float = 8.0
    #: flows in flight per node (FlowScheduler bound): >1 is what keeps
    #: the GroupCommitter's batches full — a node launches its next op
    #: while earlier ones are parked at verify/notary-wait. Kept below
    #: coins_per_party so concurrent spends on one node can always find
    #: an unlocked coin.
    node_concurrency: int = 2
    raft_replicas: int = 3
    seed: int = 7
    chaos: bool = False
    chaos_partition_s: float = 2.0
    chaos_append_drop_p: float = 0.15
    settle_fraction: float = 0.15  # of post-issuance ops; rest are payments
    issue_dollars: int = 100_000
    pay_dollars: int = 10
    paper_dollars: int = 55
    price_dollars: int = 50
    provider_timeout_s: float = 5.0
    slo_objectives: tuple = DEFAULT_OBJECTIVES
    slo_windows_s: tuple = (5.0, 30.0)
    max_duration_s: float = 120.0
    trace_capacity: int = 16384
    mode: str = "smoke"
    #: optional callable(verifier) applied to the shared verifier service
    #: right after construction — tests use it to force degraded routes
    #: (e.g. trip the device breakers so commits host-verify)
    on_verifier: object = None
    #: hostile hot-state shape (ROADMAP item 6): when set, every payment
    #: targets THIS party index — one exchange-like vault absorbing all
    #: traffic — instead of the uniform random counterparty mix.
    hot_party: int | None = None
    #: after the workload drains, replay this many already-consumed input
    #: refs straight at the uniqueness provider as deliberate double
    #: spends; the artifact records the rejection rate (1.0 or the
    #: notary's safety broke).
    double_spend_replays: int = 0
    #: notary shards (ISSUE 15): >1 partitions the uniqueness domain
    #: across this many raft groups behind a ShardedUniquenessProvider.
    shards: int = 1
    #: fraction of payments forced multi-input ("big" pays spending two
    #: coins), so their input refs straddle shards with probability
    #: (shards-1)/shards — the cross-shard 2PC traffic mix.
    cross_shard_pct: float = 0.0
    #: raft log compaction (ISSUE 20): snapshot the applied state machine
    #: every N applied entries and truncate the covered log prefix. None
    #: leaves replica logs unbounded (the pre-r06 shape). When chaos is
    #: also on, replicas get durable storage and the schedule gains a
    #: replica_restart window (kill + revive from snapshot + suffix).
    raft_snapshot_entries: int | None = None
    #: CoordinatorLog GC threshold in bytes (sharded runs): completed 2PC
    #: entries are compacted away once the log footprint crosses this.
    coordlog_compact_bytes: int | None = None
    #: byzantine satellite (ISSUE 20): inject this many hostile
    #: submissions mid-load — replayed already-consumed refs, mis-signed
    #: transactions, malformed tx bytes — and record the rejection rate.
    byzantine_ops: int = 0
    #: optional run observer (ISSUE 19 soak mode): an object offering any
    #: of ``on_start(ctx)`` (topology dict, after the schedulers exist),
    #: ``on_tick(now_rel)`` (every driver iteration, driver thread),
    #: ``on_drain(end_rel)`` (workload drained, before invariants),
    #: ``finalize(report)`` (mutate the report before return) and
    #: ``close()`` (finally-block teardown). All calls are best-effort —
    #: a raising observer never kills the run.
    observer: object = None
    #: the device of the nodes' hubs and of the shared verifier's batcher
    #: ("cuda", the card, raising without CUDA; tests pass "cpu")
    device: str = "cuda"

    @staticmethod
    def full(seed: int = 7, chaos: bool = True) -> "LedgerScenarioConfig":
        return LedgerScenarioConfig(
            parties=24, operations=720, rate_tx_per_sec=120.0,
            coins_per_party=6, node_concurrency=4,
            seed=seed, chaos=chaos, max_duration_s=300.0,
            raft_snapshot_entries=16, coordlog_compact_bytes=65536,
            trace_capacity=65536, mode="full")

    @staticmethod
    def sharded(shards: int = 2, cross_shard_pct: float = 0.35,
                seed: int = 7, full: bool = False) -> "LedgerScenarioConfig":
        """Sharded-notary preset (tools/scenario.py --shards): N raft
        groups, a payment mix with a configurable cross-shard fraction,
        and enough post-issuance traffic that nonzero cross-shard commits
        are guaranteed for the gate."""
        if full:
            cfg = LedgerScenarioConfig.full(seed=seed, chaos=True)
            cfg.shards, cfg.cross_shard_pct = shards, cross_shard_pct
            cfg.mode = "sharded"
            return cfg
        return LedgerScenarioConfig(
            parties=4, operations=40, rate_tx_per_sec=10.0,
            coins_per_party=3, shards=shards,
            cross_shard_pct=cross_shard_pct, seed=seed,
            mode="sharded-smoke")

    @staticmethod
    def byzantine(seed: int = 7, full: bool = False
                  ) -> "LedgerScenarioConfig":
        """The hostile-client preset (ISSUE 20): a sharded topology under
        load, with replayed, mis-signed, and malformed transactions
        injected mid-run. The gate: 100% rejection, the committed-tx/s
        floor held, and zero reservation leaks on the shards."""
        if full:
            cfg = LedgerScenarioConfig.full(seed=seed, chaos=True)
            cfg.shards, cfg.cross_shard_pct = 2, 0.25
            cfg.byzantine_ops = 24
            cfg.mode = "byzantine"
            return cfg
        return LedgerScenarioConfig(
            parties=4, operations=40, rate_tx_per_sec=10.0,
            coins_per_party=3, shards=2, cross_shard_pct=0.25,
            byzantine_ops=9, seed=seed, mode="byzantine-smoke")

    @staticmethod
    def hot_state(seed: int = 7, full: bool = False
                  ) -> "LedgerScenarioConfig":
        """The hostile preset: many parties racing to pay ONE exchange-like
        party, then a burst of deliberate double-spend replays against the
        refs the run consumed. Settles are off — pure payment pressure on
        the hot vault — and the artifact carries the rejection rate and
        the throughput floor benchguard locks."""
        if full:
            return LedgerScenarioConfig(
                parties=16, operations=480, rate_tx_per_sec=80.0,
                coins_per_party=4, node_concurrency=4,
                settle_fraction=0.0, hot_party=0, double_spend_replays=48,
                seed=seed, max_duration_s=300.0, trace_capacity=65536,
                mode="hot-state")
        return LedgerScenarioConfig(
            parties=6, operations=42, rate_tx_per_sec=12.0,
            coins_per_party=2, settle_fraction=0.0,
            hot_party=0, double_spend_replays=8,
            seed=seed, mode="hot-state-smoke")


@dataclass
class _Op:
    """One workload operation: a single flow, or the two-leg settle."""
    kind: str                     # issue | pay | settle
    seq: int
    intended_s: float             # offset from run start (open-loop clock)
    initiator: int                # node index into the driver's node list
    counterparty: int | None = None
    big: bool = False             # multi-coin pay (cross-shard pressure)
    step: int = 0                 # settle: 0 = CP self-issue, 1 = DvP
    future: object | None = None  # FlowScheduler proxy for the current leg
    launch_rel: float | None = None  # when the current leg actually started
    paper_ref: object | None = None
    done: bool = False
    ok: bool = False
    error: str | None = None
    latency_s: float | None = None
    committed: list = field(default_factory=list)  # (tx_id, input_refs)


def _build_ops(cfg: LedgerScenarioConfig) -> list[_Op]:
    """Deterministic workload: fund every party first, then a seeded mix
    of payments and settlements at the configured offered rate."""
    rng = random.Random(cfg.seed)
    ops: list[_Op] = []
    for _ in range(cfg.coins_per_party):
        for i in range(cfg.parties):
            ops.append(_Op("issue", len(ops),
                           len(ops) / cfg.rate_tx_per_sec, initiator=i))
    while len(ops) < cfg.operations:
        if cfg.hot_party is not None:
            # hostile hot-state shape: every spender races against the
            # one exchange-like party's vault
            other = cfg.hot_party
            seller = rng.randrange(cfg.parties - 1)
            if seller >= other:
                seller += 1
        else:
            seller = rng.randrange(cfg.parties)
            other = rng.randrange(cfg.parties - 1)
            if other >= seller:
                other += 1
        kind = "settle" if rng.random() < cfg.settle_fraction else "pay"
        # "big" pays gather two coins (issue amount + pay amount exceeds
        # any single coin) so the tx has multi-shard input refs; the
        # short-circuit keeps the rng stream identical when the knob is
        # off, preserving pre-shard workloads byte-for-byte.
        big = bool(cfg.cross_shard_pct) and kind == "pay" and \
            rng.random() < cfg.cross_shard_pct
        ops.append(_Op(kind, len(ops), len(ops) / cfg.rate_tx_per_sec,
                       initiator=seller, counterparty=other, big=big))
    return ops


def _dollars(n: int):
    from ..core.contracts.amount import Amount, USD
    return Amount(n * 100, USD)


def _build_paper_issue(node, notary_party, face):
    """CP self-issue transaction (trader_demo.issue_paper): the contract
    requires an issue time window, so this leg notarises too."""
    import datetime

    from ..core.contracts.amount import Amount
    from ..core.contracts.structures import (Issued, PartyAndReference,
                                             TimeWindow)
    from ..core.serialization.codec import exact_epoch_micros
    from ..core.transactions.builder import TransactionBuilder
    from ..finance.commercial_paper import CommercialPaper

    me = node.party
    now = datetime.datetime.now(datetime.timezone.utc)
    maturity = exact_epoch_micros(now + datetime.timedelta(days=30))
    builder = TransactionBuilder(notary=notary_party)
    issued = Amount(face.quantity,
                    Issued(PartyAndReference(me, b"\x01"), face.token))
    CommercialPaper.generate_issue(
        builder, PartyAndReference(me, b"\x01"), issued, maturity,
        notary_party)
    builder.set_time_window(TimeWindow.with_tolerance(
        now, datetime.timedelta(seconds=30)))
    builder.sign_with(node.services.key_management.key_pair(me.owning_key))
    return builder.to_signed_transaction(check_sufficient_signatures=False)


class _ChaosSchedule:
    """Time-windowed fault schedule over the process injector. Windows
    are sequential (partition → leader kill → append drops); each is
    armed at its start and disarmed at its end, and annotated with what
    actually fired."""

    def __init__(self, cfg: LedgerScenarioConfig, raft_nodes, expect_s,
                 restart=None):
        self.cfg = cfg
        self.raft_nodes = raft_nodes
        # windows must land INSIDE the offered-load interval or they would
        # never arm (the driver exits once the workload drains)
        w = max(0.25, min(cfg.chaos_partition_s, 0.2 * expect_s))
        self.width_s = w
        self.windows = [
            {"kind": "partition_follower", "start_s": 0.20 * expect_s,
             "end_s": 0.20 * expect_s + w},
            {"kind": "leader_kill", "start_s": 0.50 * expect_s,
             "end_s": 0.50 * expect_s + w},
            {"kind": "append_drop", "start_s": 0.75 * expect_s,
             "end_s": 0.75 * expect_s + w},
        ]
        #: crash-restart window (ISSUE 20): only scheduled when the
        #: harness hands kill/revive hooks over — i.e. replicas carry
        #: durable storage to restart FROM. Keeps the historical
        #: three-window shape byte-identical for non-compacting runs.
        self.restart = restart
        self.restarts = 0
        if restart is not None:
            self.windows.insert(1, {
                "kind": "replica_restart", "start_s": 0.35 * expect_s,
                "end_s": 0.35 * expect_s + w})
        self._active = None
        self.annotations: list[dict] = []

    def _partition_rules(self, name: str):
        from ..utils.faults import FaultRule
        return [FaultRule("net.send", "drop", detail=f"{name}->*"),
                FaultRule("net.send", "drop", detail=f"*->{name}")]

    def _pick_target(self, kind: str) -> str:
        from ..consensus.raft import LEADER
        leaders = [rn.node_id for rn in self.raft_nodes
                   if rn is not None and rn.role == LEADER]
        followers = [rn.node_id for rn in self.raft_nodes
                     if rn is not None and rn.node_id not in leaders]
        if kind == "leader_kill" and leaders:
            return leaders[0]
        return (followers or [self.raft_nodes[-1].node_id])[0]

    def _pick_restart_target(self) -> str | None:
        """A follower that is NOT a workload entry point — killing a shard
        entry provider would sever the notary, which is a different fault
        (leader_kill covers it) than the crash-restart this window tests."""
        from ..consensus.raft import LEADER
        excluded = self.restart.get("excluded", set())
        cands = [rn.node_id for rn in self.raft_nodes
                 if rn is not None and rn.role != LEADER
                 and rn.node_id not in excluded]
        return cands[0] if cands else None

    def _end_window(self, win, now_s: float) -> None:
        from ..utils import faults
        inj = faults.active()
        faults.disarm()
        if win["kind"] == "replica_restart" and win.get("detail"):
            try:
                self.restart["revive"](win["detail"])
                self.restarts += 1
            except Exception:
                logging.getLogger("corda_tpu_torch.ledger").exception(
                    "replica revive failed: %s", win.get("detail"))
        self.annotations.append({
            "kind": win["kind"], "start_s": round(win["start_s"], 3),
            "end_s": round(now_s, 3), "detail": win.get("detail"),
            "faults_fired": len(inj.log) if inj else 0})
        self._active = None

    def tick(self, now_s: float) -> None:
        from ..utils import faults
        if self._active is not None:
            if now_s >= self._active["end_s"]:
                self._end_window(self._active, now_s)
            return
        for win in self.windows:
            # arm even when the driver arrives late (a stall in an earlier
            # window can push the clock past this one's slot) — the window
            # then runs for its full width from now
            if win["start_s"] <= now_s:
                win["end_s"] = max(win["end_s"], now_s + self.width_s)
                if win["kind"] == "append_drop":
                    rules = [faults.FaultRule(
                        "raft.append", "drop",
                        probability=self.cfg.chaos_append_drop_p)]
                    win["detail"] = (
                        f"p={self.cfg.chaos_append_drop_p}")
                elif win["kind"] == "replica_restart":
                    target = self._pick_restart_target()
                    if target is None:
                        self.windows.remove(win)
                        return          # nobody eligible: skip the window
                    win["detail"] = target
                    try:
                        self.restart["kill"](target)
                    except Exception:
                        logging.getLogger("corda_tpu_torch.ledger").exception(
                            "replica kill failed: %s", target)
                        self.windows.remove(win)
                        return
                    # the dead replica is also partitioned for the window:
                    # its bus endpoint has no handler, so drop traffic at
                    # the send seam instead of queueing into the void
                    rules = self._partition_rules(target)
                else:
                    target = self._pick_target(win["kind"])
                    rules = self._partition_rules(target)
                    win["detail"] = target
                inj = faults.FaultInjector(seed=self.cfg.seed)
                for r in rules:
                    inj.add(r)
                faults.arm(inj)
                self._active = win
                self.windows.remove(win)
                return

    def close(self, now_s: float) -> None:
        if self._active is not None:
            self._end_window(self._active, now_s)


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def run_ledger_scenario(cfg: LedgerScenarioConfig | None = None) -> dict:
    """Build the topology, drive the open-loop workload, verify
    exactly-once, and return the LEDGER artifact fields."""
    from ..consensus.raft import LEADER
    from ..consensus.raft_uniqueness import (DistributedImmutableMap,
                                             RaftUniquenessProvider)
    from ..finance import CashIssueFlow, CashPaymentFlow
    from ..finance.trade import SellerFlow
    from ..node.notary import ValidatingNotaryService
    from ..node.services import ServiceInfo
    from ..observability import enable_tracing, get_tracer, set_tracer
    from ..testing import MockNetwork
    from ..utils import faults
    from ..utils.metrics import MetricRegistry
    from ..verifier.service import TpuTransactionVerifierService

    cfg = cfg if cfg is not None else LedgerScenarioConfig()
    prior_tracer = get_tracer()
    enable_tracing(cfg.trace_capacity)

    registry = MetricRegistry()
    slo = SLOTracker(objectives=cfg.slo_objectives,
                     windows_s=cfg.slo_windows_s)
    slo.publish(registry)

    network = MockNetwork(device=cfg.device)
    notary = network.create_node(
        "O=Raft Notary, L=Zurich, C=CH",
        advertised_services=(ServiceInfo(
            ValidatingNotaryService.type_id),))
    bank = network.create_node("O=Scenario Bank, L=London, C=GB")
    parties = [network.create_node(f"O=Party {i}, L=Oslo, C=NO")
               for i in range(cfg.parties)]
    network.start_nodes()

    # one verifier service + one registry for the whole fleet
    verifier = TpuTransactionVerifierService(metrics=registry,
                                             device=cfg.device)
    if cfg.on_verifier is not None:
        cfg.on_verifier(verifier)
    for node in network.nodes:
        node.services.monitoring = registry
        node.services.verifier_service = verifier
    notary.services.slo_tracker = slo

    # raft cluster(s) as extra bus endpoints + background pump. shards>1
    # builds one independent raft group PER SHARD; shard 0 keeps the
    # historical "raftN" names so single-shard runs are unchanged.
    n_shards = max(1, cfg.shards)
    shard_names = [[f"raft{i}" if n_shards == 1 else f"s{s}r{i}"
                    for i in range(cfg.raft_replicas)]
                   for s in range(n_shards)]
    shard_machines = [[DistributedImmutableMap() for _ in grp]
                      for grp in shard_names]
    # compaction + durable storage (ISSUE 20): chaos runs with a snapshot
    # threshold persist every replica so the replica_restart window can
    # kill one and revive it from snapshot + log suffix
    snap_dir = None
    storage_paths: dict = {}
    if cfg.raft_snapshot_entries and cfg.chaos:
        snap_dir = tempfile.mkdtemp(prefix="ledger-raftsnap-")
        storage_paths = {n: os.path.join(snap_dir, f"{n}.kv")
                         for grp in shard_names for n in grp}
    shard_providers = [[RaftUniquenessProvider.build(
        n, grp, network.bus.create_node(n),
        state_machine=shard_machines[s][i],
        seed=cfg.seed + 31 * s + i, native=False,
        storage_path=storage_paths.get(n),
        snapshot_entries=cfg.raft_snapshot_entries)
        for i, n in enumerate(grp)]
        for s, grp in enumerate(shard_names)]
    names = [n for grp in shard_names for n in grp]
    machines = [m for grp in shard_machines for m in grp]
    providers = [p for grp in shard_providers for p in grp]
    for p in providers:
        p.timeout_s = cfg.provider_timeout_s
    shard_rafts = [[p.raft for p in grp] for grp in shard_providers]
    raft_nodes = [p.raft for p in providers]
    raft_names = set(names)
    stop = threading.Event()

    # consensus observatory (ISSUE 16): Raft.* families on the shared
    # registry, a run-scoped retained time-series plane sampled from the
    # pump, growth watchdogs, and pump-tick utilization.
    from .consensus_obs import (GrowthWatch, install_raft_collector,
                                ledger_raft_fields, sample_timeseries)
    from .timeseries import TimeSeriesStore, set_timeseries
    raft_groups = {f"s{s}": [p.raft for p in grp]
                   for s, grp in enumerate(shard_providers)}
    ts_store = TimeSeriesStore()
    prior_ts = set_timeseries(ts_store)
    growth = GrowthWatch()
    sharded_ref: dict = {"provider": None}   # filled once topology settles
    install_raft_collector(registry, lambda: raft_groups)
    pump_stats = {"busy_s": 0.0, "loops": 0}
    pump_started = time.monotonic()

    def raft_pump():
        last_sample = 0.0
        while not stop.is_set():
            t0 = time.monotonic()
            for rn in raft_nodes:
                if rn is not None:      # None = killed, awaiting revive
                    rn.tick()
            for name in names:
                while network.bus.pump_receive(name) is not None:
                    pass
            t1 = time.monotonic()
            pump_stats["busy_s"] += t1 - t0
            pump_stats["loops"] += 1
            if t1 - last_sample >= 0.25:
                last_sample = t1
                try:
                    sample_timeseries(ts_store, raft_groups,
                                      sharded=sharded_ref["provider"],
                                      watch=growth)
                except Exception:
                    pass   # observability must never stall consensus
            time.sleep(0.002)

    pump_thread = threading.Thread(target=raft_pump, daemon=True,
                                   name="ledger-raft-pump")
    pump_thread.start()

    report: dict = {}
    try:
        deadline = time.monotonic() + 15
        shard_entry = []
        for s, group in enumerate(shard_rafts):
            while not any(rn.role == LEADER for rn in group):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no raft leader elected (shard {s})")
                time.sleep(0.01)
            leader = next(rn for rn in group if rn.role == LEADER)
            shard_entry.append(shard_providers[s][group.index(leader)])
        if n_shards == 1:
            uniq_provider = shard_entry[0]
            uniq_provider.committer_opts = {"label": "s0"}
            notary.install_notary(ValidatingNotaryService,
                                  uniqueness=uniq_provider)
        else:
            from ..consensus.sharded_uniqueness import (
                CoordinatorLog, ShardedNotaryService,
                ShardedUniquenessProvider)
            decision_log = CoordinatorLog(
                compact_threshold_bytes=cfg.coordlog_compact_bytes) \
                if cfg.coordlog_compact_bytes else None
            uniq_provider = ShardedUniquenessProvider(
                shard_entry, timeout_s=cfg.provider_timeout_s,
                metrics=registry, decision_log=decision_log)
            notary.install_notary(ShardedNotaryService,
                                  uniqueness=uniq_provider)
            sharded_ref["provider"] = uniq_provider

        # -- crash-restart hooks (ISSUE 20) -----------------------------------
        # kill: detach the replica from the bus and stop ticking it (its
        # slot in raft_nodes goes None; stats sampling keeps reading the
        # stale object through raft_groups). revive: rebuild the provider
        # on the SAME durable store — it must come back from snapshot +
        # log suffix, not genesis — and swap it into every live view the
        # pump/invariant code walks. Entry providers are never eligible.
        def _locate(name: str):
            for s, grp in enumerate(shard_names):
                if name in grp:
                    return s, grp.index(name)
            raise KeyError(name)

        def _kill_replica(name: str) -> None:
            s, i = _locate(name)
            flat = s * cfg.raft_replicas + i
            old = shard_providers[s][i]
            old.raft.stop()
            old.close()
            if old.raft.storage is not None:
                old.raft.storage.close()
            raft_nodes[flat] = None

        def _revive_replica(name: str) -> None:
            s, i = _locate(name)
            flat = s * cfg.raft_replicas + i
            old = shard_providers[s][i]
            machine = DistributedImmutableMap()
            fresh = RaftUniquenessProvider.build(
                name, shard_names[s], old.raft.messaging,
                state_machine=machine, seed=cfg.seed + 31 * s + i,
                native=False, storage_path=storage_paths.get(name),
                snapshot_entries=cfg.raft_snapshot_entries)
            fresh.timeout_s = cfg.provider_timeout_s
            shard_providers[s][i] = fresh
            shard_machines[s][i] = machine
            providers[flat] = fresh
            machines[flat] = machine
            raft_groups[f"s{s}"][i] = fresh.raft
            raft_nodes[flat] = fresh.raft      # last: pump resumes ticking

        restart_hooks = None
        if cfg.chaos and storage_paths:
            restart_hooks = {
                "kill": _kill_replica, "revive": _revive_replica,
                "excluded": {p.raft.node_id for p in shard_entry}}

        ops = _build_ops(cfg)
        chaos = _ChaosSchedule(cfg, raft_nodes,
                               len(ops) / cfg.rate_tx_per_sec,
                               restart=restart_hooks) \
            if cfg.chaos else None

        # driver node list: parties[i] for i < parties; issue ops run on
        # the bank (funding party ``initiator``). Each node gets a
        # FlowScheduler keeping up to cfg.node_concurrency flows in
        # flight — concurrently suspended flows are what fill the
        # GroupCommitter's batches and the verifier's bulk class.
        from ..node.statemachine import FlowScheduler
        live = [n for n in network.nodes]
        schedulers = {str(n.info.address):
                      FlowScheduler(n.smm, cfg.node_concurrency)
                      for n in live}
        inflight: list[_Op] = []
        latencies: list[float] = []
        kind_e2e: dict[str, list] = {"issue": [], "pay": [], "settle": []}
        kind_flow: dict[str, list] = {"issue": [], "pay": [], "settle": []}
        e2e_hist = registry.histogram("ledger_e2e_seconds")
        committed_notarised: list = []
        final_counts = {"committed": 0, "notarised": 0, "self_issue": 0}
        next_i = 0
        started = time.monotonic()

        observer = cfg.observer
        if observer is not None and hasattr(observer, "on_start"):
            # the soak observer's view of the topology: size probes hang
            # off these live objects, invariant re-checks walk the shard
            # machines, phase seals read the workload bookkeeping (safe —
            # on_tick runs on this same driver thread)
            observer.on_start({
                "cfg": cfg, "network": network, "verifier": verifier,
                "raft_nodes": raft_nodes, "raft_groups": raft_groups,
                "shard_machines": shard_machines, "machines": machines,
                "n_shards": n_shards, "sharded": sharded_ref["provider"],
                "uniq_provider": uniq_provider, "ts_store": ts_store,
                "growth": growth, "slo": slo,
                "committed_notarised": committed_notarised,
                "latencies": latencies, "final_counts": final_counts,
                "started": started})

        def _node_for(op: _Op):
            return bank if op.kind == "issue" else parties[op.initiator]

        def _make_flow(op: _Op, node):
            if op.kind == "issue":
                # issuer ref must be unique PER OP: two issues with the same
                # (ref, amount, owner, notary) build byte-identical txs with
                # the same id, and the vault dedupes them into one coin
                return CashIssueFlow(_dollars(cfg.issue_dollars),
                                     op.seq.to_bytes(4, "big"),
                                     parties[op.initiator].party,
                                     notary.party)
            if op.kind == "pay":
                # big pays exceed any single coin, so generate_spend
                # gathers ≥2 coins — multi-shard inputs → cross-shard 2PC
                amount = cfg.issue_dollars + cfg.pay_dollars if op.big \
                    else cfg.pay_dollars
                return CashPaymentFlow(_dollars(amount),
                                       parties[op.counterparty].party)
            if op.step == 0:         # settle leg 1: CP self-issue
                from ..flows.library import FinalityFlow
                stx = _build_paper_issue(node, notary.party,
                                         _dollars(cfg.paper_dollars))
                return FinalityFlow(stx)
            return SellerFlow(parties[op.counterparty].party,
                              op.paper_ref, _dollars(cfg.price_dollars))

        def _launch(op: _Op):
            node = _node_for(op)
            sched = schedulers[str(node.info.address)]

            def factory(op=op, node=node):
                # runs when the scheduler actually starts this leg — the
                # flow-latency clock (vs intended_s, the e2e clock)
                op.launch_rel = time.monotonic() - started
                return _make_flow(op, node)

            op.future = sched.submit(factory)
            if op not in inflight:
                inflight.append(op)

        def _count_final(final) -> None:
            """Attribute every committed final: a tx needed the notary iff
            it consumes inputs or carries a time window (FinalityFlow's
            needs_notary rule) — the rest are self-issue legs that never
            touch the uniqueness provider, which is exactly the
            committed-vs-notarised gap LEDGER_r01 left unexplained."""
            if not hasattr(final, "tx"):
                return
            final_counts["committed"] += 1
            needs_notary = bool(getattr(final, "inputs", None)) or \
                final.tx.time_window is not None
            if needs_notary:
                final_counts["notarised"] += 1
            else:
                final_counts["self_issue"] += 1

        def _leg_done(op: _Op, now_rel: float) -> None:
            if op.launch_rel is not None:
                kind_flow[op.kind].append(now_rel - op.launch_rel)

        def _finish(op: _Op, now_rel: float, ok: bool, err=None):
            op.done, op.ok = True, ok
            op.latency_s = now_rel - op.intended_s
            op.error = err
            slo.record(ok, op.latency_s)
            if ok:
                latencies.append(op.latency_s)
                kind_e2e[op.kind].append(op.latency_s)
                e2e_hist.update(op.latency_s)

        def _sweep(now_rel: float):
            for op in list(inflight):
                fut = op.future
                if fut is None or not fut.done():
                    continue
                exc = fut.exception()
                if exc is not None:
                    inflight.remove(op)
                    _finish(op, now_rel, False, err=str(exc))
                    continue
                final = fut.result()
                _leg_done(op, now_rel)
                _count_final(final)
                if getattr(final, "inputs", None):
                    op.committed.append((final.id, tuple(final.inputs)))
                    committed_notarised.append((final.id,
                                                tuple(final.inputs)))
                if op.kind == "settle" and op.step == 0:
                    from ..core.contracts.structures import (StateAndRef,
                                                             StateRef)
                    op.paper_ref = StateAndRef(final.tx.outputs[0],
                                               StateRef(final.id, 0))
                    op.step = 1
                    _launch(op)     # leg 2 queues on the same node
                else:
                    inflight.remove(op)
                    _finish(op, now_rel, True)

        # -- byzantine injection (ISSUE 20 satellite) -------------------------
        # hostile submissions fired mid-load from op index 50% onward:
        # replays of already-consumed refs straight at the uniqueness
        # provider, mis-signed transactions and malformed tx bytes at the
        # verifier. Every one must be REJECTED — rejection is the result
        # the artifact records, acceptance is the safety violation.
        byz_counts = {"attempted": 0, "rejected": 0}
        byz_pending: list = []        # (kind, future, original_tx, refs)
        byz_deferred: list = []       # replay slots with no refs yet
        byz_sched: list = []
        byz_rng = random.Random(cfg.seed ^ 0xB12A)
        byz_template: list = []
        if cfg.byzantine_ops:
            _byz_kinds = ("replay", "missign", "malformed")
            byz_sched = [
                (int(len(ops) * (0.5 + 0.4 * k / max(1, cfg.byzantine_ops
                                                     - 1))),
                 _byz_kinds[k % 3], k)
                for k in range(cfg.byzantine_ops)]

        def _byz_replay(k: int) -> bool:
            """Replay a consumed ref set under an attacker tx id. Returns
            False when nothing has committed yet (caller defers)."""
            from ..core.crypto.secure_hash import SecureHash
            if not committed_notarised:
                return False
            tx_id, refs = committed_notarised[
                byz_rng.randrange(len(committed_notarised))]
            attacker = SecureHash.sha256(
                b"byzantine-replay:%d:" % k + tx_id.bytes)
            byz_counts["attempted"] += 1
            submit = getattr(uniq_provider, "commit_async", None)
            if submit is not None:
                try:
                    fut = submit(list(refs), attacker, "byzantine")
                    byz_pending.append(("replay", fut, tx_id, refs))
                except Exception:
                    byz_counts["rejected"] += 1
            else:
                from ..node.notary import UniquenessException
                try:
                    uniq_provider.commit(list(refs), attacker, "byzantine")
                except UniquenessException as e:
                    if all(e.conflicts.get(r) is not None
                           and e.conflicts[r].consuming_tx == tx_id
                           for r in refs):
                        byz_counts["rejected"] += 1
                except Exception:
                    pass   # timeout: neither acceptance nor rejection
            return True

        def _byz_inject(kind: str, k: int) -> None:
            from ..core.crypto.signatures import TransactionSignature
            from ..core.transactions.signed import SignedTransaction
            if kind == "replay":
                if not _byz_replay(k):
                    byz_deferred.append(k)
                return
            byz_counts["attempted"] += 1
            node = parties[k % len(parties)]
            if not byz_template:
                byz_template.append(_build_paper_issue(
                    node, notary.party, _dollars(cfg.paper_dollars)))
            stx = byz_template[0]
            if kind == "missign":
                sig = stx.sigs[0]
                bad = TransactionSignature(
                    bytes([sig.bytes[0] ^ 0xFF]) + sig.bytes[1:], sig.by)
                hostile = SignedTransaction(stx.tx_bits,
                                            [bad, *stx.sigs[1:]])
            else:                      # malformed: undecodable tx bytes
                hostile = SignedTransaction(
                    b"byzantine-garbage:%d:" % k + os.urandom(24),
                    list(stx.sigs))
            try:
                fut = verifier.verify_signed(
                    hostile, node.services,
                    check_sufficient_signatures=False)
                byz_pending.append((kind, fut, None, None))
            except Exception:
                byz_counts["rejected"] += 1   # rejected before submission

        def _byz_resolve() -> None:
            from ..node.notary import UniquenessException
            for k in byz_deferred:       # replays that had to wait for load
                _byz_replay(k)
            byz_deferred.clear()
            import concurrent.futures as _cf
            for kind, fut, tx_id, refs in byz_pending:
                try:
                    fut.result(timeout=cfg.provider_timeout_s)
                except UniquenessException as e:
                    if kind == "replay" and all(
                            e.conflicts.get(r) is not None
                            and e.conflicts[r].consuming_tx == tx_id
                            for r in refs):
                        byz_counts["rejected"] += 1
                except (TimeoutError, _cf.TimeoutError):
                    pass   # still pending: neither acceptance nor rejection
                except Exception:
                    if kind != "replay":
                        byz_counts["rejected"] += 1
            byz_pending.clear()

        hard_stop = started + cfg.max_duration_s
        while next_i < len(ops) or inflight:
            now = time.monotonic()
            now_rel = now - started
            if now > hard_stop:
                break
            if chaos is not None:
                chaos.tick(now_rel)
            if observer is not None and hasattr(observer, "on_tick"):
                try:
                    observer.on_tick(now_rel)
                except Exception:
                    pass   # observability must never stall the workload
            while next_i < len(ops) and ops[next_i].intended_s <= now_rel:
                _launch(ops[next_i])
                next_i += 1
            while byz_sched and next_i >= byz_sched[0][0]:
                _, kind, k = byz_sched.pop(0)
                try:
                    _byz_inject(kind, k)
                except Exception:
                    logging.getLogger("corda_tpu_torch.ledger").exception(
                        "byzantine injection failed: %s", kind)
            for n in live:
                n.smm.drain_external()
            pumped = network.bus.run_network(rounds=256, exclude=raft_names)
            _sweep(time.monotonic() - started)
            if not pumped and not inflight:
                time.sleep(0.001)

        if chaos is not None:
            chaos.close(time.monotonic() - started)
        faults.disarm()              # belt and braces: heal before drain

        # final drain to quiescence, then fail whatever never finished
        try:
            network.run_network(exclude=raft_names, idle_timeout=30.0)
        except TimeoutError:
            pass
        end_rel = time.monotonic() - started
        _sweep(end_rel)
        for op in list(inflight):
            inflight.remove(op)
            _finish(op, end_rel, False, err="unfinished at scenario end")
        duration_s = time.monotonic() - started
        if observer is not None and hasattr(observer, "on_drain"):
            try:
                observer.on_drain(end_rel)
            except Exception:
                pass

        # -- byzantine resolution: every hostile submission must have been
        # rejected by now (deferred replays fire here, against the drained
        # committed set)
        if cfg.byzantine_ops:
            while byz_sched:            # load drained before 90%: fire late
                _, kind, k = byz_sched.pop(0)
                try:
                    _byz_inject(kind, k)
                except Exception:
                    logging.getLogger("corda_tpu_torch.ledger").exception(
                        "byzantine injection failed: %s", kind)
            _byz_resolve()

        # -- deliberate double-spend replays (hot-state preset) ---------------
        ds_attempted = ds_rejected = 0
        if cfg.double_spend_replays and committed_notarised:
            from ..core.crypto.secure_hash import SecureHash
            from ..node.notary import UniquenessException
            provider = uniq_provider
            rng = random.Random(cfg.seed ^ 0xD5)
            for k in range(cfg.double_spend_replays):
                tx_id, refs = committed_notarised[
                    rng.randrange(len(committed_notarised))]
                attacker_tx = SecureHash.sha256(
                    b"double-spend:%d:" % k + tx_id.bytes)
                ds_attempted += 1
                try:
                    provider.commit(list(refs), attacker_tx, "hostile")
                except UniquenessException as e:
                    # safety holds only if the conflict names the ORIGINAL
                    # consumer, not the attacker
                    if all(e.conflicts.get(r) is not None
                           and e.conflicts[r].consuming_tx == tx_id
                           for r in refs):
                        ds_rejected += 1
                except Exception:
                    pass   # a timeout is neither acceptance nor rejection

        # -- in-doubt 2PC recovery (sharded) ----------------------------------
        # A chaos window can kill a cross-shard coordinator between prepare
        # and finalize; resolve from the durable decision record BEFORE the
        # invariant pass, exactly as a restarted coordinator would.
        recovered_in_doubt: list = []
        if n_shards > 1:
            try:
                recovered_in_doubt = uniq_provider.recover_in_doubt()
            except Exception:
                pass

        # -- exactly-once + replica agreement (per shard) ---------------------
        from ..consensus.sharded_uniqueness import shard_of

        def _home(ref):
            """Replicas of the shard that owns this ref's uniqueness."""
            return shard_machines[shard_of(ref, n_shards)]

        exactly_once_ok = True
        for tx_id, refs in committed_notarised:
            for ref in refs:
                for m in _home(ref):
                    details = m._map.get(ref)
                    if details is None or details.consuming_tx != tx_id:
                        exactly_once_ok = False
        agree_deadline = time.monotonic() + 10
        replicas_agree = False
        reserved_leftover = sum(len(m._reserved) for m in machines)
        while time.monotonic() < agree_deadline:
            agree = True
            for group in shard_machines:
                views = [{ref: d.consuming_tx for ref, d in m._map.items()}
                         for m in group]
                if not all(v == views[0] for v in views[1:]):
                    agree = False
                    break
            reserved_leftover = sum(len(m._reserved) for m in machines)
            if agree and reserved_leftover == 0:
                replicas_agree = True
                break
            time.sleep(0.05)        # followers may still be catching up
        if not replicas_agree:
            exactly_once_ok = False
        else:
            # re-check against the converged maps (a follower that lagged
            # during the first pass no longer counts against the invariant)
            exactly_once_ok = all(
                m._map.get(ref) is not None
                and m._map[ref].consuming_tx == tx_id
                for tx_id, refs in committed_notarised
                for ref in refs for m in _home(ref))

        # -- report -----------------------------------------------------------
        traces = get_tracer().traces()
        stitched = connected_commit_traces(traces)
        committed_ops = [o for o in ops if o.ok]
        committed_txs = final_counts["committed"]
        notarised_txs = final_counts["notarised"]
        self_issue_txs = final_counts["self_issue"]
        lat_sorted = sorted(latencies)
        snapshot = registry.snapshot()
        status = slo.status()
        budgets = [o_["error_budget_pct"]
                   for o_ in status["objectives"].values()]
        report = {
            "benchmark": "ledger_scenario",
            "mode": cfg.mode,
            "metric": "committed_tx_per_sec",
            "value": round(committed_txs / duration_s, 3) if duration_s
            else 0.0,
            "unit": "tx/s",
            "committed_tx_per_sec":
                round(committed_txs / duration_s, 3) if duration_s else 0.0,
            "offered_tx_per_sec": cfg.rate_tx_per_sec,
            "parties": cfg.parties,
            "node_concurrency": cfg.node_concurrency,
            "raft_replicas": cfg.raft_replicas,
            "seed": cfg.seed,
            # host fingerprint: benchguard fits floors within a host class
            # only — open-loop rates recorded on a big box are not floors
            # a small one can be held to (benchguard.same_host_class)
            "host_cpus": os.cpu_count() or 1,
            "ops_total": len(ops),
            "ops_committed": len(committed_ops),
            "ops_failed": len(ops) - len(committed_ops),
            # counter reconciliation (ISSUE 11 satellite): every committed
            # final is attributed — it either went through the notary
            # (inputs or a time window: notarised_tx_count) or was a
            # self-issue leg that legitimately skips it. The invariant is
            # committed == notarised + self_issue, pinned by
            # counter_invariant_ok and test_ledger_harness.
            "committed_tx_count": committed_txs,
            "notarised_tx_count": notarised_txs,
            "self_issue_tx_count": self_issue_txs,
            "notarised_input_tx_count": len(committed_notarised),
            "counter_invariant_ok":
                committed_txs == notarised_txs + self_issue_txs,
            "duration_s": round(duration_s, 3),
            "e2e_ms_p50": round(_percentile(lat_sorted, 0.50) * 1000, 3),
            "e2e_ms_p90": round(_percentile(lat_sorted, 0.90) * 1000, 3),
            "e2e_ms_p99": round(_percentile(lat_sorted, 0.99) * 1000, 3),
            "slo_error_budget_pct": min(budgets) if budgets else 100.0,
            "slo": status,
            "chaos_enabled": bool(cfg.chaos),
            "chaos_windows": chaos.annotations if chaos is not None else [],
            "exactly_once_ok": exactly_once_ok,
            "replicas_agree": replicas_agree,
            "stitched_traces": len(stitched),
            # pipelining evidence: the deepest concurrent in-flight flow
            # count any node reached (1 == fully serialized, the old mode)
            "max_concurrent_flows_per_node":
                max((s.high_water for s in schedulers.values()), default=0),
            "flows_launched":
                sum(s.launched for s in schedulers.values()),
            # one stitched trace's spans verbatim, so tests can assert the
            # tree topology; bench.py pops this before writing the artifact
            "trace_sample": traces[stitched[0]] if stitched else [],
        }
        # per-flow-class stage attribution: e2e (intended-send → final,
        # open-loop clock) and flow (actual launch → leg completion) so a
        # blended 7 s p99 is attributable to its scenario kind
        for kind in ("issue", "pay", "settle"):
            e2e_k = sorted(kind_e2e[kind])
            flow_k = sorted(kind_flow[kind])
            for q, qv in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
                report[f"e2e_ms_{q}_{kind}"] = round(
                    _percentile(e2e_k, qv) * 1000, 3)
                report[f"flow_ms_{q}_{kind}"] = round(
                    _percentile(flow_k, qv) * 1000, 3)
        report.update(ledger_stage_percentiles(snapshot))
        report.update(group_commit_fields(snapshot))
        report.update(ledger_shard_fields(snapshot, n_shards))
        report["cross_shard_pct"] = cfg.cross_shard_pct
        report["ledger_shard_reserved_leftover"] = reserved_leftover
        report["ledger_shard_recovered_in_doubt"] = len(recovered_in_doubt)
        # tail forensics: per-flow-class critical-path blame vectors over
        # the stitched span trees (critpath.py). Each p50/p99 vector is
        # the decomposition of that quantile's transaction, so its
        # components sum to that transaction's e2e — the conservation
        # property bench.py probes and benchguard locks.
        report.update(ledger_critpath_fields(traces))
        # consensus observatory (ISSUE 16): pooled per-entry raft
        # attribution (exact samples off every replica — they live on
        # whichever node led when the entry committed), the measured
        # consensus-round distribution they must telescope to (bench.py's
        # attribution-sum validity probe), pump utilization, shard skew,
        # and the retained time-series plane's resolution count.
        ts_store.flush()           # seal every ring so all resolutions show
        round_samples: list = []
        for p_ in shard_entry:
            gc = getattr(p_, "group_committer", None)
            if gc is not None and hasattr(gc, "round_samples"):
                round_samples.extend(gc.round_samples())
        if n_shards > 1:
            round_samples.extend(uniq_provider.round_samples())
        report.update(ledger_raft_fields(raft_groups, round_samples))
        pump_wall = max(1e-9, time.monotonic() - pump_started)
        report["ledger_raft_pump_busy_frac"] = round(
            min(1.0, pump_stats["busy_s"] / pump_wall), 4)
        if n_shards > 1:
            heat = uniq_provider.heat_stats()
            report["ledger_shard_skew_index"] = round(
                heat["skew_index"], 4)
            report["ledger_coordinator_log_bytes"] = int(
                heat["coordinator_log_bytes"])
            report["ledger_coordinator_compactions"] = int(
                heat.get("coordinator_compactions", 0))
        else:
            # one shard is trivially even (max == mean) once it saw load
            report["ledger_shard_skew_index"] = 1.0 if notarised_txs \
                else 0.0
            report["ledger_coordinator_log_bytes"] = 0
            report["ledger_coordinator_compactions"] = 0
        ts_snap = ts_store.snapshot()
        report["ledger_timeseries_resolutions"] = max(
            (sum(1 for ring in series if ring["points"])
             for name, series in ts_snap["series"].items()
             if name.startswith("Raft.LogEntries")), default=0)
        report["ledger_growth_warnings"] = growth.warnings
        report["ledger_growth_compactions"] = growth.compactions
        # bounded-state evidence (ISSUE 20): the armed threshold, the
        # RETAINED-log peak any replica reached over the sampled series
        # (the sawtooth's crest — bench.py's validity probe bounds it at
        # 2× threshold), and how many replicas were crash-restarted
        report["ledger_raft_snapshot_threshold"] = int(
            cfg.raft_snapshot_entries or 0)
        report["ledger_raft_restarts"] = \
            chaos.restarts if chaos is not None else 0
        _peak = 0.0
        for _name, _series in ts_snap["series"].items():
            if _name.startswith("Raft.LogEntries"):
                for _ring in _series:
                    for _row in _ring["points"]:
                        _peak = max(_peak, _row[3])
        report["ledger_raft_log_entries_peak"] = int(_peak)
        # the ISSUE's named headline for the double-spend check, duplicated
        # from the stage percentile so benchguard can floor it directly
        report["notary_uniqueness_p99_ms"] = report.get(
            "ledger_stage_notary_uniqueness_ms_p99", 0.0)
        if cfg.hot_party is not None or cfg.double_spend_replays:
            report["hot_state"] = True
            report["hot_party"] = cfg.hot_party
            report["double_spend_attempts"] = ds_attempted
            report["double_spend_rejected"] = ds_rejected
            report["double_spend_rejection_rate"] = (
                round(ds_rejected / ds_attempted, 4) if ds_attempted
                else 0.0)
        if cfg.byzantine_ops:
            report["byzantine"] = True
            report["byzantine_attempted"] = byz_counts["attempted"]
            report["byzantine_rejected"] = byz_counts["rejected"]
            report["byzantine_rejection_rate"] = (
                round(byz_counts["rejected"] / byz_counts["attempted"], 4)
                if byz_counts["attempted"] else 0.0)
        if observer is not None and hasattr(observer, "finalize"):
            observer.finalize(report)
        return report
    finally:
        faults.disarm()
        obs = cfg.observer
        if obs is not None and hasattr(obs, "close"):
            try:
                obs.close()
            except Exception:
                pass
        if n_shards > 1:
            try:
                # shuts the 2PC coordinator pool down before the per-replica
                # committers (provider.close below is a no-op re-close)
                uniq_provider.close()
            except Exception:
                pass
        for p in providers:
            try:
                p.close()          # stop GroupCommitter tick/flush threads
            except Exception:
                pass
        stop.set()
        pump_thread.join(timeout=5)
        for p in providers:
            try:
                if getattr(p.raft, "storage", None) is not None:
                    p.raft.storage.close()
            except Exception:
                pass
        if snap_dir is not None:
            import shutil
            shutil.rmtree(snap_dir, ignore_errors=True)
        try:
            verifier.shutdown()
        except Exception:
            pass
        set_tracer(prior_tracer)
        set_timeseries(prior_ts)


# ---------------------------------------------------------------------------
# Shard-scaling sweep (ISSUE 15): the measured tx/s-vs-shards curve.
#
# The full-flow scenario above is host-CPU bound (LEDGER_r03 critpath: the
# p50 payment spends ~1.7 s in flow.compute and ~1.8 s in verify against
# 0.004 ms in raft.commit), so it cannot show what sharding buys the NOTARY
# TIER — the flows would bottleneck first at any shard count. The sweep
# therefore saturates the uniqueness tier directly: an open-loop driver
# fires pre-bucketed StateRefs through the REAL ShardedUniquenessProvider
# (per-shard 3-replica raft groups, per-shard GroupCommitters, real 2PC for
# the cross-shard fraction, real chaos windows) with the committers tuned
# small (max_batch 8, one round in flight) so each shard's capacity is
# consensus-round bound — batch/RTT — not host-CPU bound. Consensus waits
# are sleeps that release the GIL, so N shards wait in parallel and the
# curve measures real horizontal scaling, not Python scheduling noise.
# ---------------------------------------------------------------------------

@dataclass
class ShardSweepConfig:
    """One point of the scaling curve. Defaults are the full-measurement
    shape; bench.py --smoke shrinks operations/rate."""

    shards: int = 2
    operations: int = 1600
    rate_tx_per_sec: float = 1500.0   # offered above any point's capacity
    cross_shard_pct: float = 0.06     # fraction running the 2PC
    conflict_pct: float = 0.02        # deliberate double spends (abort path)
    raft_replicas: int = 3
    seed: int = 7
    chaos: bool = False
    chaos_partition_s: float = 2.0
    chaos_append_drop_p: float = 0.15
    timeout_s: float = 30.0
    #: per-attempt consensus bound: a round stranded on a chaos-deposed
    #: leader re-submits after this long instead of serialising its whole
    #: shard pipeline behind timeout_s (provider.consensus_round)
    attempt_timeout_s: float = 1.0
    max_duration_s: float = 120.0
    #: batch 4 / one round in flight / 12 ms pump: per-shard capacity
    #: ~= 4 / (pump RTT) ~= 300 tx/s, far below the one-interpreter
    #: ceiling, so added shards show up as throughput, not GIL contention
    committer_max_batch: int = 4
    committer_max_latency_s: float = 0.002
    committer_inflight: int = 1
    pump_interval_s: float = 0.012
    coordinator_workers: int = 16


class _SweepChaos:
    """Progress-anchored chaos for the sweep: windows arm when the
    RESOLVED fraction crosses 20 % / 50 % / 75 % — not at wall-clock
    offsets — so a 4-shard run that drains 4× faster takes the same
    proportional fault pressure as the 1-shard run and the curve compares
    like with like. Window width is ~8 % of the projected run length
    (floor 0.25 s, ceiling ``chaos_partition_s``), proportional again."""

    def __init__(self, cfg: ShardSweepConfig, raft_nodes):
        self.cfg = cfg
        self.raft_nodes = raft_nodes
        self.pending = [("partition_follower", 0.20), ("leader_kill", 0.50),
                        ("append_drop", 0.75)]
        self._active = None          # (kind, end_monotonic, detail)
        self.annotations: list[dict] = []

    def _rules(self, kind: str):
        from ..consensus.raft import LEADER
        from ..utils.faults import FaultRule
        if kind == "append_drop":
            return ([FaultRule("raft.append", "drop",
                               probability=self.cfg.chaos_append_drop_p)],
                    f"p={self.cfg.chaos_append_drop_p}")
        leaders = [rn.node_id for rn in self.raft_nodes
                   if rn.role == LEADER]
        followers = [rn.node_id for rn in self.raft_nodes
                     if rn.node_id not in leaders]
        if kind == "leader_kill" and leaders:
            target = leaders[0]
        else:
            target = (followers or [self.raft_nodes[-1].node_id])[0]
        return ([FaultRule("net.send", "drop", detail=f"{target}->*"),
                 FaultRule("net.send", "drop", detail=f"*->{target}")],
                target)

    def tick(self, frac: float, elapsed_s: float) -> None:
        from ..utils import faults
        now = time.monotonic()
        if self._active is not None:
            kind, end, detail = self._active
            if now >= end:
                inj = faults.active()
                faults.disarm()
                self.annotations.append({
                    "kind": kind, "at_progress": round(frac, 3),
                    "detail": detail,
                    "faults_fired": len(inj.log) if inj else 0})
                self._active = None
            return
        if not self.pending or frac < self.pending[0][1] or frac <= 0:
            return
        kind, _thr = self.pending.pop(0)
        projected = elapsed_s / max(frac, 1e-6)
        width = max(0.25, min(self.cfg.chaos_partition_s, 0.08 * projected))
        rules, detail = self._rules(kind)
        inj = faults.FaultInjector(seed=self.cfg.seed)
        for r in rules:
            inj.add(r)
        faults.arm(inj)
        self._active = (kind, now + width, detail)

    def close(self, frac: float) -> None:
        from ..utils import faults
        if self._active is not None:
            kind, _end, detail = self._active
            inj = faults.active()
            faults.disarm()
            self.annotations.append({
                "kind": kind, "at_progress": round(frac, 3),
                "detail": detail,
                "faults_fired": len(inj.log) if inj else 0})
            self._active = None


def run_shard_sweep_point(cfg: ShardSweepConfig | None = None) -> dict:
    """Measure ONE shard count under notary saturation and verify the
    safety invariants (per-shard exactly-once, replica agreement, zero
    leftover reservations after in-doubt recovery). Returns one
    ``shard_sweep`` entry for the LEDGER artifact."""
    from ..consensus.raft import LEADER
    from ..consensus.raft_uniqueness import (DistributedImmutableMap,
                                             RaftUniquenessProvider)
    from ..consensus.sharded_uniqueness import (ShardedUniquenessProvider,
                                                shard_of)
    from ..core.contracts.structures import StateRef
    from ..core.crypto.secure_hash import SecureHash
    from ..network.inmemory import InMemoryMessagingNetwork
    from ..node.notary import UniquenessException
    from ..utils import faults
    from ..utils.metrics import MetricRegistry

    cfg = cfg if cfg is not None else ShardSweepConfig()
    n_shards = max(1, cfg.shards)
    rng = random.Random(cfg.seed * 1000003 + n_shards)
    bus = InMemoryMessagingNetwork()
    registry = MetricRegistry()

    shard_names = [[f"s{s}r{i}" for i in range(cfg.raft_replicas)]
                   for s in range(n_shards)]
    shard_machines = [[DistributedImmutableMap() for _ in grp]
                      for grp in shard_names]
    shard_providers = [[RaftUniquenessProvider.build(
        n, grp, bus.create_node(n), state_machine=shard_machines[s][i],
        seed=cfg.seed + 31 * s + i, native=False)
        for i, n in enumerate(grp)]
        for s, grp in enumerate(shard_names)]
    stop = threading.Event()

    def pump(shard: int):
        group = shard_providers[shard]
        names = shard_names[shard]
        while not stop.is_set():
            for p in group:
                p.raft.tick()
            # drain the group to QUIESCENCE each iteration: a tick's
            # AppendEntries, the followers' acks, and the leader's commit
            # all land inside one pass regardless of which replica holds
            # leadership — otherwise the round RTT depends on the
            # leader's position in the drain order (an extra full pump
            # interval when it drains before its followers reply)
            while True:
                delivered = False
                for name in names:
                    while bus.pump_receive(name) is not None:
                        delivered = True
                if not delivered:
                    break
            # the sleep IS the design: consensus RTT dominates per-shard
            # capacity and sleeping releases the GIL, so shards wait in
            # parallel instead of serializing on the interpreter
            time.sleep(cfg.pump_interval_s)

    pumps = [threading.Thread(target=pump, args=(s,), daemon=True,
                              name=f"sweep-pump-s{s}")
             for s in range(n_shards)]
    for t in pumps:
        t.start()

    sharded = None
    try:
        deadline = time.monotonic() + 15
        entry = []
        for s, grp in enumerate(shard_providers):
            while not any(p.raft.role == LEADER for p in grp):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no raft leader (shard {s})")
                time.sleep(0.01)
            leader = next(p for p in grp if p.raft.role == LEADER)
            leader.committer_opts = {
                "max_batch": cfg.committer_max_batch,
                "max_latency_s": cfg.committer_max_latency_s,
                "max_inflight_batches": cfg.committer_inflight,
                "attempt_timeout_s": cfg.attempt_timeout_s,
            }
            entry.append(leader)
        sharded = ShardedUniquenessProvider(
            entry, timeout_s=cfg.timeout_s, metrics=registry,
            coordinator_workers=cfg.coordinator_workers,
            attempt_timeout_s=cfg.attempt_timeout_s)

        # pre-bucketed refs: rejection-sample fresh StateRefs by home shard
        # so single-shard ops stay single-shard and cross-shard ops touch
        # exactly two shards, deterministically per seed
        pools: list[list] = [[] for _ in range(n_shards)]
        quota = cfg.operations + 64
        salt = 0
        while any(len(p) < quota for p in pools):
            ref = StateRef(SecureHash.sha256(
                b"sweep:%d:%d:%d" % (cfg.seed, n_shards, salt)), 0)
            pools[shard_of(ref, n_shards)].append(ref)
            salt += 1

        ops = []                 # (kind, tx_id, refs, intended_s)
        spent_pool = []          # refs already used (conflict fodder)
        for j in range(cfg.operations):
            tx = SecureHash.sha256(b"sweeptx:%d:%d:%d"
                                   % (cfg.seed, n_shards, j))
            r = rng.random()
            if spent_pool and r < cfg.conflict_pct:
                prior = spent_pool[rng.randrange(len(spent_pool))]
                refs, kind = [prior], "conflict"
                if n_shards > 1 and rng.random() < 0.5:
                    # cross-shard conflict: the 2PC must abort and release
                    # the fresh ref it reserved alongside the spent one
                    other = (shard_of(prior, n_shards) + 1) % n_shards
                    refs = [prior, pools[other].pop()]
            elif n_shards > 1 and r < cfg.conflict_pct + cfg.cross_shard_pct:
                a = rng.randrange(n_shards)
                b = (a + 1 + rng.randrange(n_shards - 1)) % n_shards
                refs, kind = [pools[a].pop(), pools[b].pop()], "cross"
            else:
                refs, kind = [pools[j % n_shards].pop()], "single"
            if kind != "conflict":
                spent_pool.extend(refs)
            ops.append((kind, tx, refs, j / cfg.rate_tx_per_sec))

        chaos = _SweepChaos(cfg, [p.raft for grp in shard_providers
                                  for p in grp]) if cfg.chaos else None
        lock = threading.Lock()
        outcomes: dict = {"committed": 0, "rejected": 0, "failed": 0}
        latencies: list[float] = []
        accepted: list = []      # (tx_id, refs) the provider confirmed
        resolved = [0]
        started = time.monotonic()
        hard_stop = started + cfg.max_duration_s
        launched = 0
        total = len(ops)

        def _done(fut, kind, tx, refs, intended):
            err = fut.exception()
            with lock:
                resolved[0] += 1
                if err is None:
                    outcomes["committed"] += 1
                    accepted.append((tx, refs))
                    latencies.append(
                        (time.monotonic() - started) - intended)
                elif isinstance(err, UniquenessException):
                    outcomes["rejected"] += 1
                else:
                    outcomes["failed"] += 1

        while resolved[0] < total and time.monotonic() < hard_stop:
            now_rel = time.monotonic() - started
            if chaos is not None:
                chaos.tick(resolved[0] / total, now_rel)
            while launched < total and ops[launched][3] <= now_rel:
                kind, tx, refs, intended = ops[launched]
                fut = sharded.commit_async(refs, tx, "sweep")
                fut.add_done_callback(
                    lambda f, k=kind, t=tx, r=refs, i=intended:
                    _done(f, k, t, r, i))
                launched += 1
            time.sleep(0.001)
        duration_s = time.monotonic() - started
        if chaos is not None:
            chaos.close(resolved[0] / max(1, total))
        faults.disarm()

        # resolve anything a chaos window left in doubt, then require the
        # reservation maps to drain on EVERY replica
        recovered = sharded.recover_in_doubt()
        machines = [m for grp in shard_machines for m in grp]
        agree_deadline = time.monotonic() + 10
        replicas_agree = False
        reserved_leftover = sum(len(m._reserved) for m in machines)
        while time.monotonic() < agree_deadline:
            agree = all(
                all({r: d.consuming_tx for r, d in m._map.items()} ==
                    {r: d.consuming_tx for r, d in grp[0]._map.items()}
                    for m in grp[1:])
                for grp in shard_machines)
            reserved_leftover = sum(len(m._reserved) for m in machines)
            if agree and reserved_leftover == 0:
                replicas_agree = True
                break
            time.sleep(0.05)
        exactly_once_ok = replicas_agree
        if replicas_agree:
            for tx, refs in accepted:
                for ref in refs:
                    for m in shard_machines[shard_of(ref, n_shards)]:
                        d = m._map.get(ref)
                        if d is None or d.consuming_tx != tx:
                            exactly_once_ok = False

        lat = sorted(latencies)
        snapshot = registry.snapshot()
        try:
            heat = sharded.heat_stats()
        except Exception:
            heat = {"skew_index": 0.0, "coordinator_log_bytes": 0}
        return {
            "shards": n_shards,
            "operations": total,
            "skew_index": round(float(heat.get("skew_index", 0.0)), 4),
            "coordinator_log_bytes": int(
                heat.get("coordinator_log_bytes", 0)),
            "offered_tx_per_sec": cfg.rate_tx_per_sec,
            "committed": outcomes["committed"],
            "rejected": outcomes["rejected"],
            "failed": outcomes["failed"],
            "unresolved": total - resolved[0],
            "committed_tx_per_sec":
                round(outcomes["committed"] / duration_s, 3)
                if duration_s else 0.0,
            "duration_s": round(duration_s, 3),
            "latency_ms_p50": round(_percentile(lat, 0.50) * 1000, 3),
            "latency_ms_p99": round(_percentile(lat, 0.99) * 1000, 3),
            "cross_shard_committed": int(
                (snapshot.get("CrossShard.Committed") or {})
                .get("count", 0)),
            "cross_shard_aborted": int(
                (snapshot.get("CrossShard.Aborted") or {}).get("count", 0)),
            "recovered_in_doubt": len(recovered),
            "exactly_once_ok": exactly_once_ok,
            "replicas_agree": replicas_agree,
            "reserved_leftover": reserved_leftover,
            "chaos_windows": chaos.annotations if chaos is not None else [],
            "chaos_enabled": bool(cfg.chaos),
        }
    finally:
        faults.disarm()
        if sharded is not None:
            try:
                sharded.close()
            except Exception:
                pass
        for grp in shard_providers:
            for p in grp:
                try:
                    p.close()
                except Exception:
                    pass
        stop.set()
        for t in pumps:
            t.join(timeout=5)


def shard_scaling_fields(points: list[dict]) -> dict:
    """Flatten a sweep ([run_shard_sweep_point per shard count]) into the
    LEDGER artifact's scaling-curve fields benchguard locks:
    ``committed_tx_per_sec_shards_N`` per point, the efficiency of the
    biggest point against linear scaling from the 1-shard baseline, and
    the sweep's aggregate abort rate — named ``shard_sweep_abort_rate``
    so it can never collide with (and silently overwrite) the flows
    scenario's ``cross_shard_abort_rate``, which describes a different
    workload."""
    points = sorted(points, key=lambda p: p["shards"])
    out: dict = {"shard_sweep": points}
    base = next((p for p in points if p["shards"] == 1), None)
    top = points[-1] if points else None
    for p in points:
        out[f"committed_tx_per_sec_shards_{p['shards']}"] = \
            p["committed_tx_per_sec"]
    if base and top and base["committed_tx_per_sec"] > 0:
        ratio = top["committed_tx_per_sec"] / base["committed_tx_per_sec"]
        out["shard_scaling_x"] = round(ratio, 3)
        out["shard_scaling_efficiency_pct"] = round(
            100.0 * ratio / max(1, top["shards"]), 2)
    else:
        out["shard_scaling_x"] = 0.0
        out["shard_scaling_efficiency_pct"] = 0.0
    cross_c = sum(p.get("cross_shard_committed", 0) for p in points)
    cross_a = sum(p.get("cross_shard_aborted", 0) for p in points)
    out["shard_sweep_abort_rate"] = round(
        cross_a / (cross_a + cross_c), 4) if (cross_a + cross_c) else 0.0
    # worst skew any point saw (per-shard request imbalance; 1.0 == even,
    # 0.0 == a pre-r05 point that never measured it)
    out["shard_sweep_skew_index"] = round(max(
        (float(p.get("skew_index", 0.0)) for p in points), default=0.0), 4)
    out["shard_sweep_ok"] = bool(points) and all(
        p["exactly_once_ok"] and p["replicas_agree"]
        and p["reserved_leftover"] == 0 for p in points)
    return out
