"""Sharded notary uniqueness: N raft groups + cross-shard 2PC.

One raft cluster owning every StateRef caps global committed tx/s at a
single consensus group no matter how fat the group-commit batches get
(LEDGER_r03: 19.3 tx/s). This module partitions the uniqueness domain
across N notary shards, each backed by its own 3-replica raft group and
``put_all_batch`` GroupCommitter, keyed by StateRef hash
(:func:`shard_of`). The reference precedent is multi-notary operation
with a notary-change flow for moving states between notaries; here the
partitioning is transparent — one logical notary, N commit logs.

* **Single-shard transactions** (the overwhelming majority of issuance/
  payment traffic) take the existing group-commit fast path on their
  home shard, untouched.
* **Cross-shard transactions** run a deterministic two-phase
  provisional commit. Phase 1 reserves all input refs on every touched
  shard in canonical shard order (``reserve_all`` — provisional-spend
  records carrying the coordinating tx id, replay-safe via the same
  first-spender-wins verdict machinery as ``put_all_batch``). Canonical
  order means two racing cross-shard transactions always contend at
  their lowest common shard first, so one wins outright — no livelock.
  Phase 2 finalizes (``finalize_all``) or aborts (``release_all``); an
  abort releases the reservations — on EVERY touched shard, not just
  the ones whose reserve verdict was seen, so a reserve round that
  timed out but late-commits cannot strand a reservation — and honest
  retries succeed. Every ``finalize_all`` verdict is checked: a
  conflict after the durable commit decision (a lost reservation) is
  an atomicity violation surfaced as
  :class:`CrossShardAtomicityError`, with the transaction left
  in-doubt rather than silently reported committed. The coordinator's
  durable decision record (:class:`CoordinatorLog`) is the commit
  point: crash-recovery (:meth:`ShardedUniquenessProvider.
  recover_in_doubt`) finalizes transactions whose decision reached
  "commit" and releases everything else, so no ref stays permanently
  reserved.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time as _time

from ..node.notary import (UniquenessException, UniquenessProvider,
                           ValidatingNotaryService)
from ..utils.faults import FaultError, fault_point
from .provider import consensus_round


class CrossShardAtomicityError(RuntimeError):
    """Phase-2 ``finalize_all`` found an input consumed by a DIFFERENT
    transaction after the commit decision was durably recorded — a
    lost-reservation anomaly (e.g. a zombie coordinator racing
    ``recover_in_doubt``, or a pre-shard snapshot restore that dropped
    the reservation map). The transaction is left in-doubt in the
    decision record rather than reported committed, and the conflicting
    entries ride on ``conflicts`` so the caller sees exactly which
    inputs were stolen."""

    def __init__(self, tx_id, conflicts: dict):
        self.tx_id = tx_id
        self.conflicts = dict(conflicts)
        super().__init__(
            f"cross-shard finalize of {tx_id} lost "
            f"{len(self.conflicts)} input(s) to another transaction "
            "after the commit decision (left in-doubt)")


def shard_of(ref, n_shards: int) -> int:
    """Home shard of a StateRef: stable hash of (txhash, index). Keying
    off the already-uniform SHA-256 transaction id spreads refs evenly
    without any coordination or rebalancing metadata."""
    if n_shards <= 1:
        return 0
    return (int.from_bytes(ref.txhash.bytes[:8], "big") + ref.index) % n_shards


def skew_index(loads) -> float:
    """max/mean shard load — 1.0 is perfectly even, N is everything on
    one of N shards, 0.0 means no load observed yet. The direct input
    signal for live resharding: a sustained skew index well above 1
    says the hash partitioning (or the workload) is hot-spotting."""
    loads = [float(x) for x in loads]
    total = sum(loads)
    if not loads or total <= 0:
        return 0.0
    return max(loads) / (total / len(loads))


class CoordinatorLog:
    """The coordinator's durable decision record — the 2PC commit point.

    Every cross-shard transaction moves begin("prepare") → decide
    ("commit"/"abort") → complete; entries still present after a crash
    are in-doubt and are resolved by ``recover_in_doubt`` from the
    recorded status. ``path`` appends each transition to an append-only
    serialized log (fsync'd, like FileUniquenessProvider) so the record
    survives coordinator restarts; replaying the file reconstructs the
    in-doubt set.

    GC (ISSUE 20): completed transactions contribute three dead lines
    each, so a long-running coordinator's log grows without bound.
    ``compact()`` rewrites ONLY the live (in-doubt) entries to a side
    file, fsyncs it, and atomically renames it over the log — replaying
    the compacted file reconstructs the identical in-doubt set
    (``recover_in_doubt`` equivalence is the test invariant). With
    ``compact_threshold_bytes`` set, ``complete()`` triggers compaction
    automatically once the appended bytes cross the threshold — the
    bounded-sawtooth behavior the soak observatory gates on.
    """

    def __init__(self, path: str | None = None,
                 compact_threshold_bytes: int | None = None):
        self.path = path
        self.compact_threshold_bytes = compact_threshold_bytes
        self._lock = threading.Lock()
        self._entries: dict = {}     # tx_id -> {"status", "by_shard"}
        #: logical log bytes appended (including replayed history) — the
        #: CoordinatorLog.Bytes soak gauge. Counted even without a path
        #: so an in-memory decision record still shows growth; compaction
        #: resets it to the live-entry footprint (the sawtooth floor).
        self.bytes_appended = 0
        self.compactions = 0
        self.bytes_reclaimed = 0
        if path is not None:
            self._replay()

    def _replay(self) -> None:
        import os
        from ..core.serialization import deserialize
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            for line in f.read().splitlines():
                if not line:
                    continue
                self.bytes_appended += len(line) + 1
                import base64
                op, tx_id, extra = deserialize(base64.b64decode(line))
                if op == "begin":
                    self._entries[tx_id] = {
                        "status": "prepare",
                        "by_shard": {s: list(refs) for s, refs in extra}}
                elif op == "decide" and tx_id in self._entries:
                    self._entries[tx_id]["status"] = extra
                elif op == "complete":
                    self._entries.pop(tx_id, None)

    def _append(self, record) -> None:
        import base64
        from ..core.serialization import serialize
        line = base64.b64encode(serialize(record)) + b"\n"
        self.bytes_appended += len(line)   # callers hold self._lock
        if self.path is None:
            return
        import os
        with open(self.path, "ab") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())

    def begin(self, tx_id, by_shard: dict) -> None:
        with self._lock:
            self._entries[tx_id] = {
                "status": "prepare",
                "by_shard": {s: list(refs) for s, refs in by_shard.items()}}
            self._append(("begin", tx_id,
                          [(s, list(refs)) for s, refs in by_shard.items()]))

    def decide(self, tx_id, decision: str) -> None:
        with self._lock:
            entry = self._entries.get(tx_id)
            if entry is not None:
                entry["status"] = decision
            self._append(("decide", tx_id, decision))

    def status(self, tx_id) -> str | None:
        with self._lock:
            entry = self._entries.get(tx_id)
            return None if entry is None else entry["status"]

    def complete(self, tx_id) -> None:
        with self._lock:
            self._entries.pop(tx_id, None)
            self._append(("complete", tx_id, None))
            if self.compact_threshold_bytes is not None \
                    and self.bytes_appended >= self.compact_threshold_bytes:
                self._compact_locked()

    def compact(self) -> int:
        """GC the decision log: rewrite only live (in-doubt) entries,
        fsync, atomically rename over the old log. Returns the logical
        bytes reclaimed. Safe to call at any time; a failure (including
        an injected ``coordlog.compact`` fault) leaves the original log
        untouched."""
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        # NB: self._lock is a plain (non-reentrant) Lock — this helper
        # assumes the caller holds it.
        import base64
        from ..core.serialization import serialize
        lines = []
        for tx_id, entry in self._entries.items():
            lines.append(base64.b64encode(serialize(
                ("begin", tx_id,
                 [(s, list(refs))
                  for s, refs in entry["by_shard"].items()]))) + b"\n")
            if entry["status"] != "prepare":
                lines.append(base64.b64encode(serialize(
                    ("decide", tx_id, entry["status"]))) + b"\n")
        content = b"".join(lines)
        reclaimed = self.bytes_appended - len(content)
        if reclaimed <= 0:
            return 0
        try:
            from ..utils.faults import DROP, fault_point
            if self.path is not None:
                import os
                tmp = self.path + ".compact"
                with open(tmp, "wb") as f:
                    f.write(content)
                    f.flush()
                    os.fsync(f.fileno())
                if fault_point("coordlog.compact") == DROP:
                    return 0   # injected abort: original log untouched
                os.replace(tmp, self.path)
            elif fault_point("coordlog.compact") == DROP:
                return 0
        except Exception as e:
            import logging
            from ..observability import jlog
            jlog(logging.getLogger(__name__), "coordlog.compact_failed",
                 level=logging.WARNING, error=str(e))
            return 0
        self.bytes_appended = len(content)
        self.compactions += 1
        self.bytes_reclaimed += reclaimed
        import logging
        from ..observability import jlog
        jlog(logging.getLogger(__name__), "coordlog.compact",
             level=logging.INFO, live_entries=len(self._entries),
             bytes_reclaimed=reclaimed, bytes_live=len(content))
        return reclaimed

    def in_doubt(self) -> list:
        """Snapshot of unresolved entries: [(tx_id, {"status", "by_shard"})]."""
        with self._lock:
            return [(tx, {"status": e["status"],
                          "by_shard": {s: list(r)
                                       for s, r in e["by_shard"].items()}})
                    for tx, e in self._entries.items()]

    def __len__(self):
        with self._lock:
            return len(self._entries)


class ShardedUniquenessProvider(UniquenessProvider):
    """UniquenessProvider spanning N shard providers (one per raft group).

    ``shards`` is a list of per-shard entry providers (each a
    RaftUniquenessProvider whose node is a member — ideally the leader —
    of that shard's raft group); index in the list == shard id ==
    ``shard_of`` bucket.
    """

    supports_trace_ctx = True

    def __init__(self, shards, timeout_s: float = 30.0, metrics=None,
                 decision_log: CoordinatorLog | None = None,
                 coordinator_workers: int = 8,
                 attempt_timeout_s: float | None = None):
        self.shards = list(shards)
        self.n_shards = len(self.shards)
        self.timeout_s = timeout_s
        #: per-attempt bound on one 2PC consensus submit (provider.py):
        #: a prepare/finalize stranded on a deposed shard leader retries
        #: promptly instead of holding its reservations for timeout_s
        self.attempt_timeout_s = attempt_timeout_s
        self.log = decision_log if decision_log is not None \
            else CoordinatorLog()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=coordinator_workers,
            thread_name_prefix="xshard-2pc")
        from ..observability import get_tracer
        from ..utils.metrics import MetricRegistry
        self._tracer = get_tracer()
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._m_prepared = self.metrics.meter("CrossShard.Prepared")
        self._m_committed = self.metrics.meter("CrossShard.Committed")
        self._m_aborted = self.metrics.meter("CrossShard.Aborted")
        self._m_recovered = self.metrics.meter("CrossShard.Recovered")
        #: finalize verdicts that reported a conflict AFTER the durable
        #: commit decision — each mark is an atomicity violation that
        #: left its transaction in-doubt (never silently completed)
        self._m_finalize_conflict = self.metrics.meter(
            "CrossShard.FinalizeConflict")
        for s, provider in enumerate(self.shards):
            provider.timeout_s = timeout_s
            opts = dict(getattr(provider, "committer_opts", None) or {})
            opts.setdefault("label", f"s{s}")
            provider.committer_opts = opts
        # -- shard heat/skew telemetry (consensus observatory) ---------------
        self._heat_lock = threading.Lock()
        self._shard_requests = [0] * max(1, self.n_shards)
        self._shard_refs = [0] * max(1, self.n_shards)
        self._touch_matrix: dict = {}   # "s0+s2" -> commit request count
        # exact 2PC consensus-round durations: these appends produce raft
        # attribution samples too, so the observatory's conservation probe
        # needs their measured side alongside the GroupCommitter's
        from collections import deque
        self._round_samples: deque = deque(maxlen=4096)
        self.metrics.add_collector(self._heat_collect)

    # -- heat/skew telemetry --------------------------------------------------
    def _record_heat(self, by_shard: dict) -> None:
        key = "+".join(f"s{s}" for s in sorted(by_shard)) or "s0"
        with self._heat_lock:
            for s, refs in by_shard.items():
                self._shard_requests[s] += 1
                self._shard_refs[s] += len(refs)
            self._touch_matrix[key] = self._touch_matrix.get(key, 0) + 1

    def heat_stats(self) -> dict:
        """Per-shard load snapshot: request/ref counts routed since start,
        live applied-map and reserved-set sizes read off each shard's
        state machine, the cross-shard touch matrix, and the skew index
        over routed requests."""
        with self._heat_lock:
            requests = list(self._shard_requests)
            refs = list(self._shard_refs)
            touch = dict(self._touch_matrix)
        shards = []
        for s, provider in enumerate(self.shards):
            entry = {"shard": f"s{s}", "requests": requests[s],
                     "refs": refs[s]}
            sm = getattr(provider, "state_machine", None)
            if sm is not None:
                applied = getattr(sm, "_map", None)
                reserved = getattr(sm, "_reserved", None)
                if applied is not None:
                    entry["applied"] = len(applied)
                if reserved is not None:
                    entry["reserved"] = len(reserved)
            shards.append(entry)
        return {"shards": shards, "touch_matrix": touch,
                "skew_index": skew_index(requests),
                "coordinator_log_bytes": getattr(self.log, "bytes_appended", 0),
                "coordinator_in_doubt": len(self.log),
                "coordinator_compactions": getattr(self.log, "compactions", 0),
                "coordinator_bytes_reclaimed": getattr(
                    self.log, "bytes_reclaimed", 0)}

    def _heat_collect(self) -> dict:
        """Metrics collector: Shard.* labeled families + coordinator-log
        gauges ride every registry snapshot (same labeled-family shape as
        the federation collector, so /metrics and fleetstat render them
        without special cases)."""
        stats = self.heat_stats()
        # gauge_fn = the value-only gauge shape (prometheus_text renders
        # plain ``_value`` samples; a full "gauge" snapshot carries a
        # high-water ``max`` field this collector doesn't track)
        out = {"Shard.SkewIndex": {"type": "gauge_fn",
                                   "value": stats["skew_index"]},
               "CoordinatorLog.Bytes": {"type": "gauge_fn",
                                        "value": stats["coordinator_log_bytes"]},
               "CoordinatorLog.InDoubt": {"type": "gauge_fn",
                                          "value": stats["coordinator_in_doubt"]},
               "CoordinatorLog.Compactions": {
                   "type": "gauge_fn",
                   "value": stats["coordinator_compactions"]}}
        for entry in stats["shards"]:
            labels = {"shard": entry["shard"]}
            for field, family in (("requests", "Shard.Requests"),
                                  ("refs", "Shard.Refs"),
                                  ("applied", "Shard.Applied"),
                                  ("reserved", "Shard.Reserved")):
                if field not in entry:
                    continue
                out[f'{family}{{shard="{entry["shard"]}"}}'] = {
                    "type": "gauge_fn", "family": family,
                    "labels": dict(labels), "value": entry[field]}
        return out

    # -- partitioning --------------------------------------------------------
    def partition(self, refs) -> dict:
        """{shard id: [refs]} over this provider's shard count."""
        by_shard: dict = {}
        for ref in refs:
            by_shard.setdefault(shard_of(ref, self.n_shards), []).append(ref)
        return by_shard

    def touched_shards(self, refs) -> str:
        """Span-tag rendering of the shards a ref set lands on ("s0+s2")."""
        return "+".join(f"s{s}" for s in sorted(self.partition(refs))) or "s0"

    # -- commit paths --------------------------------------------------------
    def commit(self, states, tx_id, caller: str, trace_ctx=None,
               metrics=None) -> None:
        by_shard = self.partition(states)
        self._record_heat(by_shard)
        if len(by_shard) <= 1:
            home = next(iter(by_shard), 0)
            return self.shards[home].commit(
                states, tx_id, caller, trace_ctx=trace_ctx,
                metrics=metrics if metrics is not None else self.metrics)
        self._commit_cross(by_shard, tx_id, caller, trace_ctx)

    def commit_async(self, states, tx_id, caller: str, trace_ctx=None,
                     metrics=None):
        """Future-returning commit: single-shard requests go straight onto
        the home shard's GroupCommitter (the fast path, untouched);
        cross-shard requests run the 2PC on the coordinator pool."""
        by_shard = self.partition(states)
        self._record_heat(by_shard)
        if len(by_shard) <= 1:
            home = next(iter(by_shard), 0)
            return self.shards[home].commit_async(
                states, tx_id, caller, trace_ctx=trace_ctx,
                metrics=metrics if metrics is not None else self.metrics)
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def run():
            try:
                self._commit_cross(by_shard, tx_id, caller, trace_ctx)
            except BaseException as exc:  # noqa: BLE001 — future carries it
                fut.set_exception(exc)
            else:
                fut.set_result(None)

        self._pool.submit(run)
        return fut

    # -- the two-phase protocol ---------------------------------------------
    def _round(self, shard: int, command, trace_ctx, phase: str,
               n_states: int):
        site = f"raft.submit.shard_{phase}"
        timing: dict = {}
        with self._tracer.span("raft.commit", parent=trace_ctx,
                               shard=f"s{shard}", phase=phase,
                               n_states=n_states, cross_shard=True) as sp:
            try:
                return consensus_round(self.shards[shard].raft, command,
                                       self.timeout_s,
                                       trace_ctx=sp.context() or trace_ctx,
                                       site=site,
                                       attempt_timeout_s=self.attempt_timeout_s,
                                       timing=timing)
            finally:
                submit_p = timing.get("submit_perf")
                resolved_p = timing.get("resolved_perf")
                if isinstance(submit_p, float) \
                        and isinstance(resolved_p, float) \
                        and resolved_p > submit_p:
                    self._round_samples.append(resolved_p - submit_p)

    def round_samples(self) -> list:
        """Exact retained 2PC consensus-round durations (seconds) — pooled
        with the GroupCommitters' for the attribution-conservation probe."""
        with self._heat_lock:
            return list(self._round_samples)

    def _commit_cross(self, by_shard: dict, tx_id, caller: str,
                      trace_ctx) -> None:
        order = sorted(by_shard)
        detail = tx_id.bytes.hex()[:12]
        self.log.begin(tx_id, by_shard)
        self._m_prepared.mark()
        decided_commit = False
        try:
            t0 = _time.time()
            for s in order:
                fault_point("shard2pc.prepare", detail=f"s{s}:{detail}")
                out = self._round(
                    s, ("reserve_all", (tx_id, list(by_shard[s]), caller)),
                    trace_ctx, "prepare", len(by_shard[s]))
                if not out.get("committed"):
                    self._abort(tx_id, by_shard)
                    raise UniquenessException(out.get("conflicts") or {})
            if trace_ctx is not None:
                self._tracer.record(
                    "wait.cross_shard_prepare", parent=trace_ctx, start_s=t0,
                    duration_s=_time.time() - t0,
                    wait_kind="cross_shard.prepare",
                    shards="+".join(f"s{s}" for s in order))
            fault_point("shard2pc.decide", detail=detail)
            self.log.decide(tx_id, "commit")   # durable commit point
            decided_commit = True
            fault_point("shard2pc.finalize", detail=detail)
            conflicts: dict = {}
            for s in order:
                out = self._finalize(s, tx_id, by_shard[s], caller,
                                     trace_ctx)
                if out.get("committed"):
                    # dedicated cross-shard per-shard meter: the fast-path
                    # GroupCommit.Committed{shard=} counts must keep summing
                    # to the aggregate GroupCommit.Committed
                    self.metrics.meter(
                        f'CrossShard.Committed{{shard="s{s}"}}').mark()
                else:
                    conflicts.update(out.get("conflicts") or {})
            if conflicts:
                # Lost-reservation anomaly: finalize refuses to overwrite
                # another tx's consumption. The entry stays in-doubt (NOT
                # completed) so the violation is visible to recovery and
                # operators instead of resolving as a silent partial commit.
                self._m_finalize_conflict.mark()
                raise CrossShardAtomicityError(tx_id, conflicts)
            self.log.complete(tx_id)
            self._m_committed.mark()
        except UniquenessException:
            raise
        except FaultError:
            # Injected coordinator crash: the "process" died mid-protocol —
            # no inline cleanup, the decision record resolves it later.
            raise
        except BaseException:
            # Coordinator survived but a round failed (timeout, partition).
            # Post-decision the tx must still commit — leave it in-doubt for
            # recovery; pre-decision, abort and release what we reserved.
            if not decided_commit:
                self._abort(tx_id, by_shard)
            raise

    #: Finalize rounds a coordinator gives a transaction it decided to
    #: commit before it leaves it in doubt. The decision is durable and
    #: finalize_all idempotent, so a round that timed out (an append lost
    #: in a partition or drop window) is submitted again: in doubt, the
    #: transaction would hold its reservations until recover_in_doubt()
    #: while its client, told the commit failed, spends the same states
    #: again and parks behind those reservations.
    FINALIZE_ROUNDS = 3

    def _finalize(self, shard: int, tx_id, refs, caller: str, trace_ctx):
        for left in range(self.FINALIZE_ROUNDS - 1, -1, -1):
            try:
                return self._round(
                    shard, ("finalize_all", (tx_id, list(refs), caller)),
                    trace_ctx, "finalize", len(refs))
            except TimeoutError:
                if not left:
                    raise

    def _abort(self, tx_id, by_shard: dict) -> None:
        self.log.decide(tx_id, "abort")
        self._m_aborted.mark()
        # Release on EVERY touched shard, not just those whose reserve
        # verdict came back success: a reserve round that timed out can
        # still commit later (the _RoundStuck late-commit race), and its
        # reservation would otherwise outlive this abort forever.
        # release_all is idempotent — releasing a shard that never
        # reserved is harmless.
        if self._release(tx_id, sorted(by_shard), by_shard):
            self.log.complete(tx_id)

    def _release(self, tx_id, shard_ids, by_shard: dict) -> bool:
        ok = True
        for s in shard_ids:
            try:
                self._round(s, ("release_all", (tx_id, list(by_shard[s]))),
                            None, "release", len(by_shard[s]))
            except Exception:
                ok = False   # stays in-doubt; recover_in_doubt retries
        return ok

    # -- crash recovery ------------------------------------------------------
    def recover_in_doubt(self) -> list:
        """Resolve every unresolved entry in the decision record: a
        transaction whose decision reached "commit" is finalized on all
        its shards (the reservation-holders learn the outcome); anything
        else is aborted and its reservations released. Returns
        [(tx_id, "committed"|"aborted")] for what was resolved."""
        resolved = []
        for tx_id, entry in self.log.in_doubt():
            by_shard = entry["by_shard"]
            order = sorted(by_shard)
            if entry["status"] == "commit":
                ok = True
                conflicted = False
                for s in order:
                    try:
                        out = self._round(
                            s, ("finalize_all",
                                (tx_id, list(by_shard[s]), "recovery")),
                            None, "finalize", len(by_shard[s]))
                    except Exception:
                        ok = False
                        continue
                    if not out.get("committed"):
                        # lost-reservation anomaly (see _commit_cross):
                        # never complete the entry — it stays in-doubt so
                        # the violation is visible, and the meter alerts
                        ok = False
                        conflicted = True
                if conflicted:
                    self._m_finalize_conflict.mark()
                if ok:
                    self.log.complete(tx_id)
                    resolved.append((tx_id, "committed"))
            else:
                if entry["status"] != "abort":
                    self.log.decide(tx_id, "abort")
                if self._release(tx_id, order, by_shard):
                    self.log.complete(tx_id)
                    resolved.append((tx_id, "aborted"))
        if resolved:
            self._m_recovered.mark(len(resolved))
        return resolved

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        for provider in self.shards:
            provider.close()


class ShardedNotaryService(ValidatingNotaryService):
    """Validating notary whose uniqueness provider spans N raft-backed
    shards — one logical notary identity, N commit logs. Everything else
    (signature checking, flow protocol, async commit capability) is the
    validating notary's."""

    type_id = "corda.notary.sharded.validating"
