"""Per-stage latency breakdown helpers for the verification pipeline.

The SignatureBatcher records one Histogram (utils/metrics.py) per pipeline
stage; this module names the stages and flattens a metrics snapshot into
the flat percentile fields bench.py emits alongside its throughput numbers
(driver-parseable JSON, same artifact).

Stage model (verifier/batcher.py):
- ``prep``     host-side batch preparation (decompress keys, pack arrays)
               up to the async device launch — ``verifier_prep_seconds``
- ``dispatch`` the device round trip (kernel execution + transfers), or
               the host verify loop on the host route —
               ``verifier_dispatch_seconds``
- ``finish``   future/group resolution fan-out — ``verifier_finish_seconds``

plus ``verifier_batch_size`` (items per flush) and ``tx_verify_seconds``
(whole-transaction verify, verifier/service.py).
"""
from __future__ import annotations

#: stage name -> histogram metric name (the batcher's registry keys)
STAGE_METRICS = {
    "prep": "verifier_prep_seconds",
    "dispatch": "verifier_dispatch_seconds",
    "finish": "verifier_finish_seconds",
}

#: Ledger commit-path stages (ISSUE 10): the span tree a committed
#: transaction leaves behind, as Histograms on the owning node's
#: ``hub.monitoring`` registry. flow_run lands in statemachine._finalize,
#: tx_verify in verifier/service.py, notary_uniqueness in node/notary.py,
#: raft_commit in consensus/provider.py, vault_update in
#: node/services.record_transactions.
LEDGER_STAGE_METRICS = {
    "flow_run": "flow_run_seconds",
    "tx_verify": "tx_verify_seconds",
    "notary_uniqueness": "notary_uniqueness_seconds",
    "raft_commit": "raft_commit_seconds",
    "vault_update": "vault_update_seconds",
}

_QUANTS = ("p50", "p90", "p99")


def stage_percentiles(snapshot: dict) -> dict:
    """Flatten a MetricRegistry snapshot into bench-output fields:
    ``stage_<stage>_ms_<q>`` per present stage histogram, plus
    ``verifier_batch_size_<q>`` when the batch-size histogram exists.
    Stages with no samples (e.g. ``prep`` on a host-only run) are omitted —
    absent keys mean "stage never ran", not zero latency."""
    out: dict = {}
    for stage, metric in STAGE_METRICS.items():
        fields = snapshot.get(metric)
        if not fields or not fields.get("count"):
            continue
        for q in _QUANTS:
            out[f"stage_{stage}_ms_{q}"] = round(fields[q] * 1000.0, 4)
    sizes = snapshot.get("verifier_batch_size")
    if sizes and sizes.get("count"):
        for q in _QUANTS:
            out[f"verifier_batch_size_{q}"] = round(sizes[q], 1)
    return out


def group_commit_fields(snapshot: dict) -> dict:
    """Flatten the GroupCommitter's amortization metrics into LEDGER
    artifact fields. Always present (0.0 defaults): a run without a
    group-commit path must LOOK unbatched (occupancy 0), not crash the
    schema — the before/after is the point of the fields."""
    sizes = snapshot.get("ledger_commit_batch_size") or {}
    appends = (snapshot.get("GroupCommit.RaftAppends") or {}).get("count", 0)
    committed = (snapshot.get("GroupCommit.Committed") or {}).get("count", 0)
    out = {
        "commit_batch_occupancy_mean": round(sizes.get("mean", 0.0), 2),
        "commit_batch_occupancy_p99": round(sizes.get("p99", 0.0), 1),
        "ledger_commit_batch_count": int(sizes.get("count", 0)),
        "group_commit_raft_appends": int(appends),
        "group_commit_committed": int(committed),
        "group_commit_rejected": int(
            (snapshot.get("GroupCommit.Rejected") or {}).get("count", 0)),
        "group_commit_prescreened": int(
            (snapshot.get("GroupCommit.PreScreened") or {}).get("count", 0)),
        "group_commit_deferred": int(
            (snapshot.get("GroupCommit.Deferred") or {}).get("count", 0)),
        "raft_appends_per_committed_tx":
            round(appends / committed, 4) if committed else 0.0,
    }
    return out


def ledger_shard_fields(snapshot: dict, n_shards: int) -> dict:
    """Flatten the sharded-notary metrics into LEDGER artifact fields.
    Always present (zero defaults, same stance as group_commit_fields):
    a single-shard run reports ``ledger_shard_count`` 1 and zero
    cross-shard activity rather than dropping the keys, so benchguard's
    schema holds across topologies. Per-shard commit counts come from
    the labeled ``GroupCommit.Committed{shard="sK"}`` meters (the
    federation label-naming convention)."""
    counts = {}
    for k in range(max(1, n_shards)):
        fam = snapshot.get(f'GroupCommit.Committed{{shard="s{k}"}}') or {}
        counts[f"s{k}"] = int(fam.get("count", 0))
    cross_c = int((snapshot.get("CrossShard.Committed") or {})
                  .get("count", 0))
    cross_a = int((snapshot.get("CrossShard.Aborted") or {}).get("count", 0))
    return {
        "ledger_shard_count": max(1, n_shards),
        "ledger_shard_commit_counts": counts,
        "ledger_shard_cross_committed": cross_c,
        "ledger_shard_cross_aborted": cross_a,
        "ledger_shard_cross_recovered": int(
            (snapshot.get("CrossShard.Recovered") or {}).get("count", 0)),
        # finalize verdicts that conflicted AFTER the durable commit
        # decision: each one is a cross-shard atomicity violation left
        # in-doubt (sharded_uniqueness.CrossShardAtomicityError) — any
        # nonzero value is an alert, so it must be artifact-visible
        "ledger_shard_finalize_conflicts": int(
            (snapshot.get("CrossShard.FinalizeConflict") or {})
            .get("count", 0)),
        "cross_shard_abort_rate":
            round(cross_a / (cross_a + cross_c), 4) if (cross_a + cross_c)
            else 0.0,
    }


def ledger_stage_percentiles(snapshot: dict) -> dict:
    """Flatten the commit-path stage histograms into LEDGER artifact
    fields: ``ledger_stage_<stage>_ms_<q>``. Same omission rule as
    stage_percentiles — a stage with no samples (e.g. raft_commit on an
    in-memory notary) stays absent, meaning "never ran"."""
    out: dict = {}
    for stage, metric in LEDGER_STAGE_METRICS.items():
        fields = snapshot.get(metric)
        if not fields or not fields.get("count"):
            continue
        for q in _QUANTS:
            out[f"ledger_stage_{stage}_ms_{q}"] = round(fields[q] * 1000.0, 4)
    return out
