"""RPC operations surface — the client-visible node API.

Reference parity: CordaRPCOps (core/messaging/CordaRPCOps.kt:60-449, 54 ops)
and CordaRPCOpsImpl (node/internal/CordaRPCOpsImpl.kt:1-199). The wire
transport (queue-backed proxy with observable demux, RPCApi.kt/RPCServer.kt)
plugs in behind this object; in-process callers (shell, tests, webserver
equivalent) call it directly.

Streaming (`DataFeed`) follows the reference shape: a snapshot plus a
subscription handle; updates are delivered to registered callbacks (the Rx
Observable analog on the deterministic host runtime).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..flows.api import FlowLogic, rpc_startable_flows, flow_name


@dataclass
class DataFeed:
    """snapshot + live updates (CordaRPCOps DataFeed)."""

    snapshot: Any
    _subscribe: Callable[[Callable], None]

    def subscribe(self, callback: Callable) -> None:
        self._subscribe(callback)


@dataclass(frozen=True)
class StateMachineInfo:
    run_id: str
    flow_class: str
    done: bool


from ..core.serialization import register_type as _register_type  # noqa: E402

_register_type("rpc.StateMachineInfo", StateMachineInfo)


class FlowPermissionException(Exception):
    pass


class CordaRPCOps:
    """The operation set served to clients (CordaRPCOps.kt:60+)."""

    def __init__(self, hub, smm):
        self.hub = hub
        self.smm = smm

    # -- node / network info -------------------------------------------------
    def node_identity(self):
        return self.hub.my_info

    def network_map_snapshot(self) -> list:
        return self.hub.network_map_cache.all_nodes()

    def notary_identities(self) -> list:
        return [n.notary_identity for n in self.hub.network_map_cache.notary_nodes()]

    def current_node_time(self):
        import datetime
        return datetime.datetime.now(datetime.timezone.utc)

    # -- flows ---------------------------------------------------------------
    def registered_flows(self) -> list[str]:
        return sorted(rpc_startable_flows())

    def start_flow_dynamic(self, flow_class_or_name, *args, **kwargs):
        """startFlowDynamic: only @StartableByRPC flows may be started
        (CordaRPCOpsImpl.startFlowDynamic); every permission decision is
        audited (FlowPermissionAuditEvent)."""
        requested = (flow_class_or_name if isinstance(flow_class_or_name, str)
                     else flow_name(flow_class_or_name))
        try:
            if isinstance(flow_class_or_name, str):
                flows = rpc_startable_flows()
                cls = flows.get(flow_class_or_name)
                if cls is None:
                    matches = [c for n, c in flows.items()
                               if n.rsplit(".", 1)[-1] == flow_class_or_name]
                    if len(matches) != 1:
                        raise FlowPermissionException(
                            f"Unknown or ambiguous flow {flow_class_or_name!r}")
                    cls = matches[0]
            else:
                cls = flow_class_or_name
                if not getattr(cls, "_startable_by_rpc", False):
                    raise FlowPermissionException(
                        f"{flow_name(cls)} is not annotated @StartableByRPC")
        except FlowPermissionException:
            self._audit_permission(requested, granted=False)
            raise
        self._audit_permission(requested, granted=True)
        flow: FlowLogic = cls(*args, **kwargs)
        return self.smm.add(flow)

    def _audit_permission(self, flow: str, granted: bool) -> None:
        audit = getattr(self.hub, "audit", None)
        if audit is not None:
            from .audit import FlowPermissionAuditEvent
            audit.record_audit_event(FlowPermissionAuditEvent(
                description="startFlowDynamic permission check",
                principal="rpc", flow_type=flow,
                permission_requested=f"StartFlow.{flow}",
                permission_granted=granted))

    def state_machines_snapshot(self) -> list[StateMachineInfo]:
        return [StateMachineInfo(fsm.run_id, flow_name(type(fsm.flow)), fsm.done)
                for fsm in self.smm.flows.values()]

    def state_machines_feed(self) -> DataFeed:
        def subscribe(cb):
            self.smm.changes.append(
                lambda event, fsm: cb((event, StateMachineInfo(
                    fsm.run_id, flow_name(type(fsm.flow)), fsm.done))))
        return DataFeed(self.state_machines_snapshot(), subscribe)

    def start_tracked_flow_dynamic(self, flow_class_or_name, *args, **kwargs):
        """startTrackedFlowDynamic (CordaRPCOps.kt:209): starts the flow AND
        returns (fsm, DataFeed) whose updates stream progress-tracker steps
        and the terminal ("removed", result-or-error) event."""
        subscribers: list = []
        buffered: list = []   # a fast flow can finish before anyone subscribes

        def emit(update):
            if not subscribers:
                buffered.append(update)
                return
            for cb in list(subscribers):
                try:
                    cb(update)
                except Exception:
                    pass

        def subscribe(cb):
            subscribers.append(cb)
            while buffered:
                cb(buffered.pop(0))

        fsm = self.start_flow_dynamic(flow_class_or_name, *args, **kwargs)
        tracker = getattr(fsm.flow, "progress_tracker", None)
        if tracker is not None:
            tracker.subscribe(
                lambda ev: emit(("progress", str(ev[2])))
                if ev[0] == "position" else None)

        def on_done(fut):
            try:
                emit(("removed", ["done", fut.result()]))
            except Exception as e:
                emit(("removed", ["failed", f"{type(e).__name__}: {e}"]))

        fsm.result_future.add_done_callback(on_done)
        return fsm, DataFeed(fsm.run_id, subscribe)

    def state_machine_recorded_transaction_mapping_snapshot(self) -> list:
        """stateMachineRecordedTransactionMapping (CordaRPCOps.kt:184-187):
        which flow recorded which transaction."""
        return [list(m) for m in self.smm.tx_mappings]

    def state_machine_recorded_transaction_mapping_feed(self) -> DataFeed:
        def subscribe(cb):
            self.smm.add_mapping_observer(lambda m: cb(list(m)))
        return DataFeed(
            self.state_machine_recorded_transaction_mapping_snapshot(),
            subscribe)

    # -- ledger --------------------------------------------------------------
    def verified_transactions_snapshot(self) -> list:
        return self.hub.storage.transactions

    def verified_transactions_feed(self) -> DataFeed:
        def subscribe(cb):
            self.hub.storage.add_commit_listener(cb)
        return DataFeed(self.hub.storage.transactions, subscribe)

    def network_map_feed(self) -> DataFeed:
        """networkMapFeed (CordaRPCOps.kt:193): snapshot + MapChange pushes."""
        def subscribe(cb):
            self.hub.network_map_cache.add_change_observer(cb)
        return DataFeed(self.network_map_snapshot(), subscribe)

    def wait_until_registered_with_network_map(self) -> bool:
        """waitUntilRegisteredWithNetworkMap (CordaRPCOps.kt:275) — here a
        non-blocking registration probe (the remote client polls it)."""
        return len(self.hub.network_map_cache.all_nodes()) > 1 or \
            self.hub.my_info in self.hub.network_map_cache.all_nodes()

    # -- vault ---------------------------------------------------------------
    def vault_snapshot(self, state_type: type | None = None) -> list:
        return self.hub.vault.unconsumed_states(state_type)

    def vault_query(self, state_type: type | None = None,
                    status: str = "unconsumed", **criteria) -> list:
        return self.hub.vault.query(state_type, status=status, **criteria)

    def vault_query_by(self, criteria=None, paging=None, sorting=None):
        """Full QueryCriteria query (reference CordaRPCOps.vaultQueryBy):
        returns a node.query.Page with states + total count."""
        return self.hub.vault.query_by(criteria, paging=paging, sorting=sorting)

    # -- monitoring ----------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        """The node's metric registry (the JMX-export analog: verification
        timers/meters, batcher counters, flow rates), merged with the
        process-wide retry counters (utils.retry keeps its own registry —
        its call sites have no ServiceHub) so ``Retry.Attempts.*`` rides
        /metrics and /api/metrics alongside the node families."""
        from ..utils import retry
        merged = dict(retry.snapshot())
        merged.update(self.hub.monitoring.snapshot())
        return merged

    def health(self) -> dict:
        """Readiness payload for /readyz: named pass/fail checks plus the
        ``ready`` conjunction. Checks apply only where the capability
        exists — a host-only node is not held unready for cold device
        tables, a non-notary node not for raft state."""
        checks: dict = {}
        degraded: dict = {}
        controller_block: dict | None = None
        svc = self.hub.verifier_service
        batcher = getattr(svc, "batcher", None)
        if batcher is not None:
            # the dispatcher thread is the batcher's heart: if it died (or
            # close() ran), every queued Future would hang forever
            checks["batcher_dispatcher_alive"] = (
                batcher._thread.is_alive() and not batcher._closed)
            if batcher.use_device:
                # first-verify latency pays the multi-MB table transfer
                # unless the committed-table cache is already warm
                from ..ops.field import _DEVICE_TABLE_CACHE
                checks["device_tables_warm"] = bool(_DEVICE_TABLE_CACHE)
            status = getattr(batcher, "breaker_status", None)
            if status is not None:
                breakers = status()
                open_schemes = {name: st for name, st in breakers.items()
                                if st["state"] != "closed"}
                if open_schemes:
                    # DEGRADED, not unready: an open breaker means that
                    # scheme verifies on host — slower, still correct —
                    # so the node keeps taking traffic while operators
                    # see exactly which breaker tripped
                    degraded["device_breakers"] = open_schemes
        fleet_fn = getattr(svc, "fleet_status", None)
        if fleet_fn is not None:
            # out-of-process fleet: unready with NO workers attached (work
            # would queue forever); degraded — still serving — when fewer
            # than the configured fleet size are attached
            fleet = fleet_fn()
            checks["fleet_workers_attached"] = fleet["attached"] > 0
            if fleet.get("degraded"):
                degraded["fleet"] = {
                    "expected": fleet["expected"],
                    "attached": fleet["attached"],
                    "workers": sorted(fleet["workers"]),
                    # workers whose last load report is older than 3× the
                    # report interval: attached but possibly wedged
                    "stale": sorted(fleet.get("stale", ())),
                    "last_report_age_s": {
                        w: info.get("last_report_age_s")
                        for w, info in fleet["workers"].items()}}
            ctl = fleet.get("controller")
            if ctl is not None:
                # the FleetController's self-report: state, ladder rung,
                # recent actions — an operator hitting /readyz during an
                # episode sees exactly which concessions are in force
                controller_block = ctl
                if ctl.get("state") != "steady":
                    degraded["controller"] = {
                        "state": ctl["state"],
                        "ladder_step": ctl["ladder_step"],
                        "actions_total": ctl["actions_total"]}
        notary = getattr(self.hub, "notary_service", None)
        if notary is not None:
            raft = getattr(notary.uniqueness, "raft", None)
            if raft is not None:
                checks["raft_leader_known"] = raft.leader_id is not None
        else:
            # non-notary node: ready means it can REACH a notary
            checks["notary_known"] = bool(self.notary_identities())
        slo = getattr(self.hub, "slo_tracker", None)
        if slo is not None:
            # burn-rate alert = DEGRADED, not unready: the node still
            # commits, but it is eating its error budget — operators get
            # the per-objective budget/burn picture right on /readyz
            status = slo.status()
            if status["alerting"]:
                degraded["slo"] = status
        out = {"ready": all(checks.values()), "checks": checks}
        if controller_block is not None:
            out["controller"] = controller_block
        if degraded:
            out["degraded"] = degraded
        return out

    def profile_snapshot(self) -> dict:
        """The kernel flight recorder's full state (/debug/profile):
        per-kernel compile/dispatch/wait accounting, batch occupancy,
        prep/device overlap."""
        from ..observability import get_profiler
        return get_profiler().snapshot()

    def fleet_status(self) -> dict:
        """Verifier-fleet picture for /api/fleet (and tools/fleetstat.py):
        per-worker shard/capacity/queue-depth plus last-report freshness.
        Empty dict when the node runs an in-process verifier."""
        fleet_fn = getattr(self.hub.verifier_service, "fleet_status", None)
        return fleet_fn() if fleet_fn is not None else {}

    def request_timelines(self, limit: int | None = None) -> dict:
        """Per-request lifecycle event timelines for /debug/requests
        (submitted → routed → … → resolved), newest request first. Empty
        when the verifier keeps no request log (in-process path)."""
        log = getattr(self.hub.verifier_service, "request_log", None)
        return log.snapshot(limit=limit) if log is not None else {}

    def critpath_report(self, top_k: int = 10) -> dict:
        """Tail forensics for /debug/critpath: critical-path blame
        decomposition + top-K slowest transactions with annotated
        blocking chains, over every stitched trace currently in the
        tracer ring (observability/critpath.py). Cheap-empty when
        tracing is off."""
        from ..observability import critpath, get_tracer
        return critpath.critpath_report(get_tracer().traces(), top_k=top_k)

    def raft_report(self) -> dict:
        """Consensus observatory for /debug/raft: per-group raft
        introspection (leader, term, log length, election episodes,
        commit-path attribution percentiles) plus shard heat/skew when
        this node's notary shards its uniqueness provider. Empty-groups
        dict for a non-notary node — the endpoint is always safe."""
        from ..observability import consensus_obs
        groups: dict = {}
        sharded = None
        notary = getattr(self.hub, "notary_service", None)
        uniq = getattr(notary, "uniqueness", None) \
            if notary is not None else None
        if uniq is not None:
            shards = getattr(uniq, "shards", None)
            if shards:
                sharded = uniq
                for s, provider in enumerate(shards):
                    raft = getattr(provider, "raft", None)
                    if raft is not None:
                        groups[f"s{s}"] = [raft]
            else:
                raft = getattr(uniq, "raft", None)
                if raft is not None:
                    groups["s0"] = [raft]
        return consensus_obs.raft_report(groups, sharded=sharded)

    def timeseries_snapshot(self, names=None, limit: int | None = None,
                            since: float | None = None,
                            resolution: float | None = None) -> dict:
        """Retained time-series plane for /api/timeseries: downsampled
        multi-resolution history of the consensus gauges sampled by the
        raft pump (observability/timeseries.py). ``names`` filters to
        specific series, ``limit`` caps rows per resolution, ``since``
        drops buckets starting before that epoch time and ``resolution``
        keeps only the ring with that bucket width (the soak poller's
        incremental-fetch filters). Well-formed and empty when nothing
        has been recorded."""
        from ..observability import get_timeseries
        return get_timeseries().snapshot(names=names, limit=limit,
                                         since=since, resolution=resolution)

    def soak_report(self) -> dict:
        """Soak observatory for /debug/soak: every structure registered
        with the resource accounting plane — live size, declared kind
        (bounded vs grows-by-design), leak verdict over its retained
        ``Resource.*`` series — plus the subsystem CPU-attribution
        snapshot when a profiler is active (observability/soak.py).
        Well-formed and empty on a node with no registered probes."""
        from ..observability.soak import soak_report
        return soak_report()

    def vault_feed(self, state_type: type | None = None) -> DataFeed:
        def subscribe(cb):
            self.hub.vault.add_update_observer(cb)
        return DataFeed(self.vault_snapshot(state_type), subscribe)

    def vault_track_by(self, criteria=None, paging=None, sorting=None
                       ) -> DataFeed:
        """vaultTrackBy (CordaRPCOps.kt:137-156): criteria-filtered page
        snapshot + the vault update stream."""
        def subscribe(cb):
            self.hub.vault.add_update_observer(cb)
        return DataFeed(
            self.hub.vault.query_by(criteria, paging=paging, sorting=sorting),
            subscribe)

    def add_vault_transaction_note(self, tx_id, note: str) -> None:
        self.hub.vault.add_transaction_note(tx_id, note)

    def get_vault_transaction_notes(self, tx_id) -> list[str]:
        return self.hub.vault.get_transaction_notes(tx_id)

    def get_cash_balances(self) -> dict:
        """getCashBalances (CordaRPCOps.kt:230): unconsumed fungible-asset
        quantities summed per product (currency code)."""
        balances: dict = {}
        for sar in self.hub.vault.unconsumed_states():
            amount = getattr(sar.state.data, "amount", None)
            if amount is None:
                continue
            product = getattr(amount.token, "product", amount.token)
            key = str(product)
            balances[key] = balances.get(key, 0) + amount.quantity
        return balances

    # -- attachments ---------------------------------------------------------
    def upload_attachment(self, data: bytes):
        return self.hub.attachments.import_attachment(data)

    def open_attachment(self, att_id):
        return self.hub.attachments.open_attachment(att_id)

    def attachment_exists(self, att_id) -> bool:
        return self.hub.attachments.has_attachment(att_id)

    def upload_file(self, data_type: str, name: str | None,
                    data: bytes) -> str:
        """uploadFile (CordaRPCOps.kt:249): typed upload dispatch — files of
        type "attachment" land in attachment storage; other types go to any
        registered acceptor (the interest-rates-oracle fixes upload path)."""
        if data_type == "attachment":
            return str(self.hub.attachments.import_attachment(data))
        acceptor = getattr(self.hub, "file_uploaders", {}).get(data_type)
        if acceptor is None:
            raise ValueError(f"no acceptor for file type {data_type!r}")
        return acceptor(name, data)

    # -- contract upgrade authorisation --------------------------------------
    def authorise_contract_upgrade(self, state_and_ref,
                                   upgraded_contract_name: str) -> None:
        from ..flows.contract_upgrade import authorise_contract_upgrade
        authorise_contract_upgrade(self.hub, state_and_ref,
                                   upgraded_contract_name)

    def deauthorise_contract_upgrade(self, state_and_ref) -> None:
        from ..flows.contract_upgrade import deauthorise_contract_upgrade
        deauthorise_contract_upgrade(self.hub, state_and_ref)

    # -- identity ------------------------------------------------------------
    def party_from_key(self, key):
        return self.hub.identity_service.party_from_key(key)

    def well_known_party_from_x500_name(self, name):
        return self.hub.well_known_party(name)

    def parties_from_name(self, query: str, exact: bool = False) -> set:
        out = set()
        for info in self.hub.network_map_cache.all_nodes():
            name = str(info.legal_identity.name)
            if (exact and query == name) or (not exact and query in name):
                out.add(info.legal_identity)
        return out

    def party_from_name(self, name: str):
        """partyFromName (CordaRPCOps.kt:288): unique substring match."""
        matches = self.parties_from_name(name, exact=False)
        return next(iter(matches)) if len(matches) == 1 else None

    def node_identity_from_party(self, party):
        """nodeIdentityFromParty (CordaRPCOps.kt:313)."""
        for info in self.hub.network_map_cache.all_nodes():
            if info.legal_identity == party or \
                    info.legal_identity.owning_key == getattr(
                        party, "owning_key", None):
                return info
        return None

    # -- delegating aliases (the reference defines these as default methods
    # on CordaRPCOps itself: CordaRPCOps.kt:74,109-118,147-156,176,187,196) --
    def state_machines_and_updates(self):
        return self.state_machines_feed()

    def vault_and_updates(self):
        return self.vault_feed()

    def verified_transactions(self):
        return self.verified_transactions_feed()

    def state_machine_recorded_transaction_mapping(self):
        return self.state_machine_recorded_transaction_mapping_feed()

    def network_map_updates(self):
        return self.network_map_feed()

    @staticmethod
    def _typed_criteria(state_type):
        from .query import VaultQueryCriteria
        return (None if state_type is None
                else VaultQueryCriteria(contract_state_types=(state_type,)))

    def vault_query_by_criteria(self, criteria, state_type: type | None = None):
        typed = self._typed_criteria(state_type)
        if typed is not None:
            criteria = typed if criteria is None else (criteria & typed)
        return self.vault_query_by(criteria)

    def vault_query_by_with_paging_spec(self, criteria, paging):
        return self.vault_query_by(criteria, paging=paging)

    def vault_query_by_with_sorting(self, criteria, sorting):
        return self.vault_query_by(criteria, sorting=sorting)

    def vault_track(self, state_type: type | None = None):
        return self.vault_track_by(self._typed_criteria(state_type))

    def vault_track_by_criteria(self, criteria):
        return self.vault_track_by(criteria)

    def vault_track_by_with_paging_spec(self, criteria, paging):
        return self.vault_track_by(criteria, paging=paging)

    def vault_track_by_with_sorting(self, criteria, sorting):
        return self.vault_track_by(criteria, sorting=sorting)

    def party_from_x500_name(self, name):
        return self.well_known_party_from_x500_name(name)
