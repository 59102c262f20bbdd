"""Critical-path extraction over stitched span trees (tail forensics).

Per-stage histograms answer "is any stage slow?" — they cannot answer
"where did THIS p99 transaction's seconds go?", because commit-path time
hides in queues (FlowScheduler admission, AwaitFuture parks, the
GroupCommitter's cutter/defer buffers, verifier bulk admission, raft
leaderless backoff) whose occupants overlap arbitrarily. The wait-state
spans (``wait.*``, tagged ``wait_kind``) make that parked time
first-class in the trace tree; this module walks a FINISHED stitched
tree and computes the **blocking chain** from submit to resolution:

* Starting at the root's end, repeatedly step to the child span that was
  running at the cursor and finished last — the span the parent was
  actually blocked on. Time between consecutive blocking children is the
  parent's **self-time**. This is the standard trace critical-path
  algorithm (Anderson-style, as in Jaeger's CPD): every critical-path
  millisecond is attributed to exactly ONE span, so the per-component
  blame vector sums to the end-to-end duration by construction — the
  conservation property benchguard locks.
* Each critical-path segment is charged to a **component** (
  ``flow.compute`` / ``scheduler.wait`` / ``verify`` /
  ``notary.batch_wait`` / ``raft.commit`` / ``raft.leaderless`` /
  ``vault`` / ``network`` / ``other``) by span name, with
  ``wait.await_future`` consulting its ``wait_kind`` tag.
* The scheduler-admission wait starts BEFORE the flow.run root exists
  (submit precedes launch), so it is prepended to the chain and the
  transaction's e2e extends back to submit time.

Robustness contract (foreign workers ship spans over the wire): orphan
spans whose parent never arrived are ignored, zero-duration spans are
safe, and malformed parent pointers that form cycles terminate — every
span enters the chain at most once (visited set).
"""
from __future__ import annotations

__all__ = [
    "COMPONENTS", "WAIT_KINDS", "component_of", "critical_path",
    "flow_kind", "aggregate_critpaths", "ledger_critpath_fields",
    "critpath_report", "LEDGER_CRITPATH_KINDS",
]

#: Blame components, display order. Every critical-path millisecond lands
#: in exactly one of these.
COMPONENTS = ("flow.compute", "scheduler.wait", "verify",
              "notary.batch_wait", "raft.commit", "raft.fsync",
              "raft.replicate", "raft.leaderless",
              "cross_shard", "vault", "network", "other")

#: wait_kind taxonomy: tag value -> blame component. One row per
#: commit-path queueing point (docs/OBSERVABILITY.md, tail forensics).
WAIT_KINDS = {
    "scheduler.admission": "scheduler.wait",   # FlowScheduler._waiting
    "verify.park": "verify",                   # Verify future park
    "verify.gather": "verify",                 # VerifyMany wave gather
    "verifier.admission": "verify",            # bulk cap block (_enqueue)
    "notary.commit": "notary.batch_wait",      # AwaitFuture notary park
    "group_commit.queue": "notary.batch_wait",  # cutter queue wait
    "group_commit.defer": "notary.batch_wait",  # pending-overlap defer
    "group_commit.round": "raft.commit",       # consensus round in flight
    "raft.leaderless": "raft.leaderless",      # retry backoff sleep
    "cross_shard.prepare": "cross_shard",      # 2PC reserve rounds (sharded)
}

#: (span-name prefix, component) — first match wins; checked after the
#: wait_kind tag for ``wait.*`` spans.
_NAME_RULES = (
    ("wait.scheduler_admission", "scheduler.wait"),
    ("wait.verifier_admission", "verify"),
    ("wait.verify", "verify"),
    ("wait.cross_shard_prepare", "cross_shard"),
    ("wait.group_commit_round", "raft.commit"),
    ("wait.group_commit", "notary.batch_wait"),
    ("wait.raft_leaderless", "raft.leaderless"),
    ("wait.await_future", "notary.batch_wait"),
    ("flow.run", "flow.compute"),
    ("flow.", "flow.compute"),
    ("tx.verify", "verify"),
    ("verifier.", "verify"),
    ("batcher.", "verify"),
    ("worker.", "verify"),
    ("notary.", "notary.batch_wait"),
    # one level below raft.commit: the attribution child spans RaftNode
    # records per committed entry (consensus observatory). raft.apply and
    # raft.election deliberately fall through to the raft.commit rule.
    ("raft.fsync", "raft.fsync"),
    ("raft.replicate", "raft.replicate"),
    ("raft.", "raft.commit"),
    ("vault.", "vault"),
    ("session.", "network"),
    ("net.", "network"),
    ("p2p.", "network"),
)


def component_of(span: dict) -> str:
    """Blame component for one span: the ``wait_kind`` tag wins (it names
    the queue precisely), then the span-name prefix rules."""
    tags = span.get("tags")
    if isinstance(tags, dict):
        comp = WAIT_KINDS.get(tags.get("wait_kind"))
        if comp is not None:
            return comp
    name = str(span.get("name", ""))
    for prefix, comp in _NAME_RULES:
        if name.startswith(prefix):
            return comp
    return "other"


def _num(v, default=0.0) -> float:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else default


def _end(span: dict) -> float:
    return _num(span.get("start_s")) + max(0.0, _num(span.get("duration_s")))


def _index(spans) -> tuple[dict, dict]:
    """(span_id -> span, parent_id -> [children]) over well-formed spans.
    Orphans — a parent_id that never arrived (old worker, ring eviction)
    — keep their entry in ``nodes`` but never join a children list, so
    they cannot claim critical-path time they have no anchor for."""
    nodes: dict = {}
    for s in spans:
        if isinstance(s, dict) and s.get("span_id"):
            nodes[s["span_id"]] = s
    children: dict = {}
    for s in nodes.values():
        pid = s.get("parent_id")
        if pid is not None and pid in nodes and pid != s["span_id"]:
            children.setdefault(pid, []).append(s)
    return nodes, children


def _pick_root(nodes: dict) -> dict | None:
    """The submit-to-resolution anchor: prefer the flow.run span (the
    commit path's root), else the longest parentless span."""
    roots = [s for s in nodes.values()
             if s.get("parent_id") is None or s.get("parent_id") not in nodes]
    if not roots:
        return None
    flow_roots = [s for s in roots if s.get("name") == "flow.run"]
    pool = flow_roots or roots
    return max(pool, key=lambda s: max(0.0, _num(s.get("duration_s"))))


def critical_path(spans) -> dict | None:
    """Blocking-chain decomposition of ONE stitched trace (a list of span
    dicts sharing a trace_id). Returns None when no usable root exists::

        {"trace_id", "root_name", "flow_type", "start_s", "e2e_ms",
         "blame_ms": {component: ms},          # sums to e2e_ms
         "dominant": component,
         "segments": [{"name", "component", "wait_kind", "ms"}, ...]}

    ``segments`` is the chain in chronological order. Cycles from
    malformed parent pointers cannot hang the walk: a span is expanded at
    most once.
    """
    nodes, children = _index(spans)
    root = _pick_root(nodes)
    if root is None:
        return None
    segments: list = []          # (span, seg_start, seg_end)
    visited = {root["span_id"]}
    # (span, t_lo, t_hi): the window this span may claim time in. Each
    # child's window is clamped INSIDE its parent's — spans in a stitched
    # tree routinely start before their parent (retroactive wait spans,
    # responder flows joining mid-trace), and without the lower clamp the
    # walk re-attributes intervals already charged elsewhere, inflating
    # blame past e2e. With it, segments are disjoint by construction and
    # conservation cannot break, however malformed the tree.
    stack = [(root, _num(root.get("start_s")), _end(root))]
    while stack:
        span, t_lo, t_hi = stack.pop()
        start = max(_num(span.get("start_s")), t_lo)
        cursor = min(_end(span), t_hi)
        kids = [c for c in children.get(span["span_id"], ())
                if c["span_id"] not in visited
                and _num(c.get("start_s")) < cursor
                and _end(c) > _num(c.get("start_s"))]
        # last-finishing child first: the span the parent was blocked on
        kids.sort(key=_end, reverse=True)
        for child in kids:
            if cursor <= start:
                break
            c_end = min(_end(child), cursor)
            c_start = max(_num(child.get("start_s")), start)
            if c_end <= c_start:
                continue        # fully shadowed by a later sibling
            if cursor > c_end:
                segments.append((span, c_end, cursor))   # parent self-time
            visited.add(child["span_id"])
            stack.append((child, c_start, c_end))
            cursor = c_start
        if cursor > start:
            segments.append((span, start, cursor))
    # the admission wait precedes the root's own start (submit → launch):
    # prepend it so the chain covers submit-to-resolution, not launch-to-
    # resolution, and extend e2e back accordingly. ONLY the root flow's
    # own wait qualifies (parented to the root): a stitched trace also
    # carries the responder/notary flows' admission waits, and counting
    # those would stack overlapping pre-root segments and break blame
    # conservation.
    t0 = _num(root.get("start_s"))
    for s in nodes.values():
        if (s.get("name") == "wait.scheduler_admission"
                and s.get("parent_id") == root["span_id"]
                and s["span_id"] not in visited
                and _num(s.get("start_s")) < t0):
            lo = _num(s.get("start_s"))
            hi = min(_end(s), t0)
            if hi > lo:
                segments.append((s, lo, hi))
                visited.add(s["span_id"])
                t0 = lo
    t1 = _end(root)
    if t1 <= t0:
        return None
    blame = {}
    out_segments = []
    for span, lo, hi in sorted(segments, key=lambda seg: seg[1]):
        ms = (hi - lo) * 1000.0
        comp = component_of(span)
        blame[comp] = blame.get(comp, 0.0) + ms
        tags = span.get("tags") if isinstance(span.get("tags"), dict) else {}
        out_segments.append({"name": str(span.get("name", "?")),
                             "component": comp,
                             "wait_kind": tags.get("wait_kind"),
                             "ms": round(ms, 3)})
    root_tags = root.get("tags") if isinstance(root.get("tags"), dict) else {}
    blame = {k: round(v, 3) for k, v in blame.items() if v > 0.0}
    return {
        "trace_id": root.get("trace_id"),
        "root_name": str(root.get("name", "?")),
        "flow_type": root_tags.get("flow_type"),
        "start_s": t0,
        "e2e_ms": round((t1 - t0) * 1000.0, 3),
        "blame_ms": blame,
        "dominant": max(blame, key=blame.get) if blame else "other",
        "segments": out_segments,
    }


def flow_kind(flow_type) -> str | None:
    """Ledger-scenario flow class for a flow.run ``flow_type`` tag."""
    name = str(flow_type or "")
    if "CashIssueFlow" in name:
        return "issue"
    if "CashPaymentFlow" in name:
        return "pay"
    if ("SellerFlow" in name or "BuyerFlow" in name
            or "CommercialPaper" in name):
        return "settle"
    return None


def _percentile_item(items: list, q: float):
    """The item at the q-quantile of an e2e-sorted list (nearest-rank):
    its blame vector sums to ITS e2e exactly — the conservation property
    an averaged vector would lose."""
    if not items:
        return None
    rank = min(len(items) - 1, max(0, int(round(q * (len(items) - 1)))))
    return items[rank]


def aggregate_critpaths(traces: dict, top_k: int = 5,
                        classify=flow_kind) -> dict:
    """Fleet-level decomposition over ``tracer.traces()`` output
    (trace_id -> spans). Returns::

        {"traces": n_decomposed,
         "per_class": {kind: {"n", "e2e_ms_p50", "e2e_ms_p99",
                              "blame_p50": {...}, "blame_p99": {...},
                              "dominant": component}},
         "top": [critical_path dicts, slowest first, annotated]}

    The p50/p99 blame vectors are the decompositions of the p50/p99
    *transactions* (nearest rank), so each vector sums to that
    transaction's e2e — blame conservation holds per vector.
    """
    paths = []
    for spans in (traces or {}).values():
        cp = critical_path(spans)
        if cp is not None:
            paths.append(cp)
    by_class: dict = {}
    for cp in paths:
        kind = classify(cp.get("flow_type")) if classify else None
        if kind is not None:
            by_class.setdefault(kind, []).append(cp)
    per_class = {}
    for kind, items in sorted(by_class.items()):
        items.sort(key=lambda c: c["e2e_ms"])
        p50 = _percentile_item(items, 0.50)
        p99 = _percentile_item(items, 0.99)
        per_class[kind] = {
            "n": len(items),
            "e2e_ms_p50": p50["e2e_ms"], "e2e_ms_p99": p99["e2e_ms"],
            "blame_p50": p50["blame_ms"], "blame_p99": p99["blame_ms"],
            "dominant": p50["dominant"],
        }
    top = sorted(paths, key=lambda c: c["e2e_ms"], reverse=True)[:top_k]
    top = [dict(cp, segments=_cap_segments(cp["segments"])) for cp in top]
    return {"traces": len(paths), "per_class": per_class, "top": top}


def _cap_segments(segments: list, keep: int = 8) -> list:
    """Annotated-path cap for reports: the ``keep`` longest segments, in
    chain order (a deep resolve chain can have hundreds)."""
    if len(segments) <= keep:
        return segments
    longest = sorted(segments, key=lambda s: s["ms"], reverse=True)[:keep]
    ids = {id(s) for s in longest}
    return [s for s in segments if id(s) in ids]


#: flow classes the LEDGER artifact carries critpath fields for
LEDGER_CRITPATH_KINDS = ("issue", "pay", "settle")


def ledger_critpath_fields(traces: dict, top_k: int = 5) -> dict:
    """Flat ``ledger_critpath_*`` artifact fields (benchguard-locked;
    always present, zero/empty-valued when a class never ran — the
    group_commit_fields always-present-with-defaults discipline)."""
    agg = aggregate_critpaths(traces, top_k=top_k)
    out = {"ledger_critpath_traces": agg["traces"],
           "ledger_critpath_top": agg["top"]}
    for kind in LEDGER_CRITPATH_KINDS:
        cls = agg["per_class"].get(kind)
        out[f"ledger_critpath_blame_p50_{kind}"] = \
            cls["blame_p50"] if cls else {}
        out[f"ledger_critpath_blame_p99_{kind}"] = \
            cls["blame_p99"] if cls else {}
        out[f"ledger_critpath_e2e_p50_ms_{kind}"] = \
            cls["e2e_ms_p50"] if cls else 0.0
        out[f"ledger_critpath_dominant_{kind}"] = \
            cls["dominant"] if cls else "-"
    return out


def critpath_report(traces: dict, top_k: int = 10) -> dict:
    """The /debug/critpath payload: aggregate + top-K slowest
    transactions with annotated blocking chains."""
    agg = aggregate_critpaths(traces, top_k=top_k)
    return {"traces": agg["traces"], "components": list(COMPONENTS),
            "per_class": agg["per_class"], "top": agg["top"]}
