"""Notary services: uniqueness (double-spend prevention) + time-window check.

Reference parity (node/services/transactions/ + core NotaryFlow.kt:95-120):
- `UniquenessProvider.commit` with conflict reporting
  (core/node/services/UniquenessProvider.kt, PersistentUniquenessProvider.kt:73-130)
- `SimpleNotaryService` (non-validating) / `ValidatingNotaryService`
  (SimpleNotaryService.kt:12-26, ValidatingNotaryService.kt:38-52)
- `TimeWindowChecker` (services/TimeWindowChecker.kt)

The Raft/BFT clustered backends plug in behind the same `UniquenessProvider`
interface (the consensus package, SURVEY.md §7 phase 5; not ported yet).
"""
from __future__ import annotations

import datetime
import logging
import os
import threading
from dataclasses import dataclass

from ..core.contracts.structures import StateRef
from ..core.identity import Party
from ..core.serialization import deserialize, register_type, serialize

_log = logging.getLogger(__name__)


@dataclass(frozen=True)
class ConsumedStateDetails:
    """Who consumed a state, in which transaction (UniquenessProvider.Conflict)."""

    consuming_tx: object     # SecureHash
    consuming_index: int
    requesting_party: str


register_type("notary.ConsumedStateDetails", ConsumedStateDetails)


class UniquenessException(Exception):
    def __init__(self, conflicts: dict):
        super().__init__(f"Input states already consumed: {sorted(conflicts, key=repr)}")
        self.conflicts = conflicts  # StateRef -> ConsumedStateDetails


class UniquenessProvider:
    """The notary commit-log SPI."""

    def commit(self, states: list[StateRef], tx_id, caller: str) -> None:
        raise NotImplementedError


def find_conflicts(consumed_map: dict, states, tx_id) -> dict:
    """All refs already consumed by a DIFFERENT transaction (re-notarising
    the same tx is idempotent) — the shared check of every commit-log
    backend (in-memory, file, replicated)."""
    conflicts = {}
    for ref in states:
        prev = consumed_map.get(ref)
        if prev is not None and prev.consuming_tx != tx_id:
            conflicts[ref] = prev
    return conflicts


def record_all(consumed_map: dict, states, tx_id, caller: str) -> None:
    for i, ref in enumerate(states):
        consumed_map[ref] = ConsumedStateDetails(tx_id, i, caller)


class InMemoryUniquenessProvider(UniquenessProvider):
    """ThreadBox'd map semantics of PersistentUniquenessProvider.kt:73-130:
    atomically check all inputs, record all or none, report ALL conflicts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._consumed: dict[StateRef, ConsumedStateDetails] = {}

    def commit(self, states, tx_id, caller: str) -> None:
        with self._lock:
            conflicts = find_conflicts(self._consumed, states, tx_id)
            if conflicts:
                raise UniquenessException(conflicts)
            record_all(self._consumed, states, tx_id, caller)

    def __len__(self):
        with self._lock:
            return len(self._consumed)


class FileUniquenessProvider(InMemoryUniquenessProvider):
    """Durable commit log: append-only file of canonical-codec records, synced
    before the commit is acknowledged (the JDBC commit-log analog)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path, "rb") as f:
                for line in f.read().split(b"\n"):
                    if line:
                        ref, details = deserialize(line)
                        self._consumed[ref] = details

    def commit(self, states, tx_id, caller: str) -> None:
        with self._lock:
            conflicts = find_conflicts(self._consumed, states, tx_id)
            if conflicts:
                raise UniquenessException(conflicts)
            with open(self.path, "ab") as f:
                for i, ref in enumerate(states):
                    details = ConsumedStateDetails(tx_id, i, caller)
                    f.write(serialize([ref, details]) + b"\n")
                f.flush()
                os.fsync(f.fileno())
                record_all(self._consumed, states, tx_id, caller)


class TimeWindowChecker:
    """services/TimeWindowChecker.kt: tolerance-adjusted containment of now."""

    def __init__(self, clock=None, tolerance_s: float = 30.0):
        self.clock = clock or (lambda: datetime.datetime.now(datetime.timezone.utc))
        self.tolerance = datetime.timedelta(seconds=tolerance_s)

    def is_valid(self, time_window) -> bool:
        if time_window is None:
            return True
        from ..core.serialization.codec import exact_epoch_micros
        now = exact_epoch_micros(self.clock())
        tol = int(self.tolerance.total_seconds() * 1_000_000)
        # TimeWindow bounds are epoch-microsecond ints (structures.TimeWindow)
        if time_window.until_time is not None and now > time_window.until_time + tol:
            return False
        if time_window.from_time is not None and now < time_window.from_time - tol:
            return False
        return True


class NotaryService:
    """Base notary service installed on a notary node; registers its service
    flow for NotaryFlow.Client inits (TrustedAuthorityNotaryService analog)."""

    type_id = "corda.notary"
    validating = False

    def __init__(self, hub, uniqueness: UniquenessProvider | None = None,
                 time_window_checker: TimeWindowChecker | None = None):
        self.hub = hub
        # back-reference for the node's readiness probe (/readyz checks the
        # commit-log backend — e.g. a raft cluster without a leader is not
        # ready to notarise)
        hub.notary_service = self
        self.uniqueness = uniqueness if uniqueness is not None \
            else InMemoryUniquenessProvider()
        self.time_window_checker = time_window_checker or TimeWindowChecker()

    def install(self, smm) -> None:
        from ..flows.library import NotaryFlow, NotaryServiceFlow
        from ..flows.api import flow_name
        smm.register_flow_factory(
            flow_name(NotaryFlow),
            lambda peer: NotaryServiceFlow(peer, self))

    #: probe-able capability flag (same pattern as the verifier service's
    #: supports_trace_ctx): callers may pass their span context through
    supports_trace_ctx = True

    def _shard_tags(self, refs) -> dict:
        """``{"shards": "s0+s2"}`` when the uniqueness backend partitions
        the ref domain (sharded provider), else nothing — keeps the
        notary.uniqueness span shape unchanged for single-log backends."""
        describe = getattr(self.uniqueness, "touched_shards", None)
        if describe is None:
            return {}
        try:
            return {"shards": describe(refs)}
        except Exception:
            return {}

    def commit(self, input_refs, tx_id, caller_name: str,
               trace_ctx=None) -> None:
        import time as _time

        from ..observability import get_tracer, jlog
        refs = list(input_refs)
        jlog(_log, "notary.commit", ctx=trace_ctx,
             tx_id=tx_id.bytes.hex()[:16], n_inputs=len(refs),
             caller=caller_name)
        with get_tracer().span("notary.commit", parent=trace_ctx,
                               tx_id=tx_id.bytes.hex()[:16],
                               n_inputs=len(refs), caller=caller_name) as sp:
            # notary.uniqueness: the commit-log check itself, separated
            # from request handling so the LEDGER artifact's
            # notary_uniqueness_p99_ms isolates the double-spend check
            # (and, for a replicated provider, the consensus round under
            # its nested raft.commit span) from flow/session overhead
            uctx = sp.context() or trace_ctx
            with get_tracer().span("notary.uniqueness", parent=uctx,
                                   tx_id=tx_id.bytes.hex()[:16],
                                   n_inputs=len(refs),
                                   **self._shard_tags(refs)) as usp:
                kwargs = {}
                if getattr(self.uniqueness, "supports_trace_ctx", False):
                    kwargs["trace_ctx"] = usp.context() or uctx
                    kwargs["metrics"] = getattr(self.hub, "monitoring", None)
                t0 = _time.perf_counter()
                try:
                    self.uniqueness.commit(refs, tx_id, caller_name, **kwargs)
                finally:
                    monitoring = getattr(self.hub, "monitoring", None)
                    if monitoring is not None:
                        trace_id = getattr(uctx, "trace_id", None)
                        monitoring.histogram(
                            "notary_uniqueness_seconds").update(
                                _time.perf_counter() - t0, trace_id=trace_id)

    @property
    def supports_async_commit(self) -> bool:
        """True when the uniqueness backend can group-commit (the raft
        provider's commit_async path) — NotaryServiceFlow parks on the
        returned future instead of blocking the notary node thread for a
        full consensus round per transaction."""
        return hasattr(self.uniqueness, "commit_async")

    def commit_async(self, input_refs, tx_id, caller_name: str,
                     trace_ctx=None):
        """Group-commit path: enqueue on the provider's GroupCommitter and
        return a Future resolving None on commit / failing with
        UniquenessException on conflict. The ``notary.commit`` and
        ``notary.uniqueness`` spans are opened here and finished when the
        verdict lands, so span durations cover the true suspended wait and
        /traces stitching matches the sync path's shape. Returns None when
        the backend has no async path (caller falls back to sync commit)."""
        import time as _time
        from concurrent.futures import Future

        from ..observability import get_tracer, jlog
        if not self.supports_async_commit:
            return None
        refs = list(input_refs)
        jlog(_log, "notary.commit", ctx=trace_ctx,
             tx_id=tx_id.bytes.hex()[:16], n_inputs=len(refs),
             caller=caller_name, group_commit=True)
        tracer = get_tracer()
        sp = tracer.span("notary.commit", parent=trace_ctx,
                         tx_id=tx_id.bytes.hex()[:16], n_inputs=len(refs),
                         caller=caller_name, group_commit=True)
        uctx = sp.context() or trace_ctx
        usp = tracer.span("notary.uniqueness", parent=uctx,
                          tx_id=tx_id.bytes.hex()[:16], n_inputs=len(refs),
                          **self._shard_tags(refs))
        t0 = _time.perf_counter()
        inner = self.uniqueness.commit_async(
            refs, tx_id, caller_name, trace_ctx=usp.context() or uctx,
            metrics=getattr(self.hub, "monitoring", None))
        outer: Future = Future()

        def _done(f):
            err = f.exception()
            monitoring = getattr(self.hub, "monitoring", None)
            if monitoring is not None:
                trace_id = getattr(uctx, "trace_id", None)
                monitoring.histogram("notary_uniqueness_seconds").update(
                    _time.perf_counter() - t0, trace_id=trace_id)
            if err is not None:
                usp.set_tag("error", f"{type(err).__name__}: {err}")
                sp.set_tag("error", f"{type(err).__name__}: {err}")
            usp.finish()
            sp.finish()
            if err is None:
                outer.set_result(None)
            else:
                outer.set_exception(err)

        inner.add_done_callback(_done)
        return outer

    def sign_tx_id(self, tx_id):
        return self.hub.sign(tx_id.bytes)


class SimpleNotaryService(NotaryService):
    """Non-validating: checks uniqueness + time window only
    (SimpleNotaryService.kt:12-26)."""

    type_id = "corda.notary.simple"
    validating = False


class ValidatingNotaryService(NotaryService):
    """Validating: additionally resolves and fully verifies the transaction
    before committing (ValidatingNotaryService.kt:38-52) — on this framework
    the signature checks ride the device batcher when the hub's verifier
    service is the device one."""

    type_id = "corda.notary.validating"
    validating = True
