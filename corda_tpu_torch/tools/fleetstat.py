"""fleetstat — a `top`-style live view of a node's verifier fleet.

Polls the node webserver's JSON surfaces (/api/fleet + /api/metrics, plus
/debug/critpath and /debug/raft when the node answers them) and renders
one worker per row: attach state, report freshness, queue depth,
capacity, and the federated per-worker throughput families — plus one
consensus line per raft group. Pure-stdlib (urllib + ANSI clear), so it
runs anywhere the node does::

    python -m corda_tpu_torch.tools.fleetstat http://127.0.0.1:8080
    python -m corda_tpu_torch.tools.fleetstat http://127.0.0.1:8080 --once

``render()`` is a pure function of the two fetched payloads — the unit
tests drive it with canned dicts, no HTTP involved.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

#: Federated per-worker families worth a column, in display order.
#: SigBatcher.Checked counts every resolved signature (host or device
#: route); DeviceChecked/DeviceBatches isolate the device path.
_RATE_FAMILIES = (
    ("SigBatcher.Checked", "checked"),
    ("SigBatcher.DeviceChecked", "dev_checked"),
    ("SigBatcher.DeviceBatches", "batches"),
    ("Breaker.Trips", "trips"),
)


def fetch(base_url: str, path: str, timeout: float = 5.0):
    with urllib.request.urlopen(base_url.rstrip("/") + path,
                                timeout=timeout) as r:
        return json.loads(r.read().decode())


def _worker_counts(metrics: dict, worker: str) -> dict:
    """Pull the federated count fields for one worker out of a node
    /api/metrics payload (keys look like ``Family{worker="w0"}``)."""
    out = {}
    if not isinstance(metrics, dict):
        return out
    suffix = f'{{worker="{worker}"}}'
    for family, label in _RATE_FAMILIES:
        fields = metrics.get(family + suffix)
        if isinstance(fields, dict):
            c = fields.get("count", fields.get("value"))
            if isinstance(c, (int, float)) and not isinstance(c, bool):
                out[label] = int(c)
    return out


def _cell(value, default):
    """A value safe to width-format: numbers and strings pass through,
    anything else (None, nested junk from a half-written payload)
    collapses to ``default``."""
    if isinstance(value, bool) or not isinstance(value, (int, float, str)):
        return default
    return value


def render(fleet: dict, metrics: dict, critpath: dict | None = None,
           raft: dict | None = None, soak: dict | None = None) -> str:
    """One screenful: fleet header + a row per worker, plus (when the
    node answers /debug/critpath) one tail-forensics line per flow class:
    the dominant blame component and its p50 share. Pure function of the
    JSON payloads — tolerates empty and malformed ones (a worker that
    crashed mid-report can leave non-dict entries behind; a node without
    tracing answers critpath with zero traces)."""
    if not isinstance(fleet, dict):
        fleet = {}
    if not isinstance(metrics, dict):
        metrics = {}
    workers = fleet.get("workers")
    if not isinstance(workers, dict):
        workers = {}
    stale = fleet.get("stale")
    stale = set(stale) if isinstance(stale, (list, tuple, set)) else set()
    lines = [
        "verifier fleet: "
        f"{_cell(fleet.get('attached'), 0)}"
        f"/{_cell(fleet.get('expected'), 0) or '?'} attached"
        + ("  DEGRADED" if fleet.get("degraded") else "")
        + (f"  stale={sorted(stale)}" if stale else ""),
        f"{'WORKER':<14}{'STATE':<10}{'AGE(s)':>8}{'DEPTH':>7}{'CAP':>5}"
        f"{'CHECKED':>10}{'DEV_CHK':>10}{'BATCHES':>9}{'TRIPS':>7}",
    ]
    for name in sorted(workers, key=str):
        w = workers[name]
        if not isinstance(w, dict):
            w = {}
        age = w.get("last_report_age_s")
        counts = _worker_counts(metrics, name)
        lines.append(
            f"{str(name):<14}"
            f"{'stale' if (name in stale or w.get('stale')) else 'ok':<10}"
            f"{_cell(age, '-'):>8}"
            f"{_cell(w.get('queue_depth'), 0):>7}"
            f"{_cell(w.get('capacity'), 1):>5}"
            f"{counts.get('checked', 0):>10}"
            f"{counts.get('dev_checked', 0):>10}"
            f"{counts.get('batches', 0):>9}"
            f"{counts.get('trips', 0):>7}")
    if not workers:
        lines.append("(no workers attached)")
    agg = metrics.get("Fleet.agg.SigBatcher.Checked") or \
        metrics.get("Fleet.agg.SigBatcher.DeviceChecked")
    if isinstance(agg, dict):
        lines.append(f"fleet aggregate checked: {agg.get('count', 0)}")
    ctl = fleet.get("controller")
    if isinstance(ctl, dict):
        state = _cell(ctl.get("state"), "?")
        rungs = ctl.get("ladder")
        applied = [s.get("name") for s in rungs
                   if isinstance(s, dict) and s.get("applied")] \
            if isinstance(rungs, (list, tuple)) else []
        lines.append(
            f"controller: {state}"
            f"  ladder={'+'.join(applied) if applied else 'none'}"
            f"  actions={_cell(ctl.get('actions_total'), 0)}"
            f"  episodes={_cell(ctl.get('episodes'), 0)}"
            + (f"  recovery_s={ctl['recovery_s_last']}"
               if isinstance(ctl.get("recovery_s_last"), (int, float))
               else ""))
        recent = ctl.get("recent_actions")
        if isinstance(recent, (list, tuple)) and recent:
            tail = [a for a in recent[-3:] if isinstance(a, dict)]
            if tail:
                lines.append("  recent: " + "; ".join(
                    f"{a.get('action', '?')}"
                    + (f"({a.get('step') or a.get('worker')})"
                       if (a.get('step') or a.get('worker')) else "")
                    for a in tail))
    # sharded-notary commit counts (ISSUE 15): per-shard labeled meters
    # ``GroupCommit.Committed{shard="s0"}``. Pre-shard nodes expose only
    # the unlabeled family — render "-" so an operator sees the surface
    # exists but carries no per-shard split (the benchtrend "-" stance).
    shard_cells = []
    for key in sorted(k for k in metrics
                      if isinstance(k, str)
                      and k.startswith('GroupCommit.Committed{shard="')):
        fields = metrics.get(key)
        c = fields.get("count") if isinstance(fields, dict) else None
        label = key[len('GroupCommit.Committed{shard="'):].rstrip('"}')
        shard_cells.append(
            f"{label}={int(c) if isinstance(c, (int, float)) and not isinstance(c, bool) else '-'}")
    if shard_cells:
        lines.append("shard commits: " + "  ".join(shard_cells))
    elif isinstance(metrics.get("GroupCommit.Committed"), dict):
        lines.append("shard commits: -")
    # consensus observatory (ISSUE 16): one line per raft group from
    # /debug/raft — role of the reporting leader, tenure, election count,
    # fsync p99, max peer lag, log length. A native core that cannot
    # attribute renders "-" cells; a malformed payload renders nothing.
    groups = raft.get("groups") if isinstance(raft, dict) else None
    if isinstance(groups, dict) and groups:
        parts = []
        for label in sorted(groups, key=str):
            g = groups[label]
            if not isinstance(g, dict):
                continue
            leader = g.get("leader")
            leader = leader if isinstance(leader, dict) else {}
            tenure = leader.get("leader_tenure_s")
            tenure_txt = (f"{tenure:.0f}s"
                          if isinstance(tenure, (int, float))
                          and not isinstance(tenure, bool) else "-")
            lag = leader.get("peer_lag")
            lag_max = max((v for v in lag.values()
                           if isinstance(v, (int, float))
                           and not isinstance(v, bool)), default=0) \
                if isinstance(lag, dict) else "-"
            attrib = g.get("attribution")
            fsync = attrib.get("fsync") if isinstance(attrib, dict) else None
            p99 = fsync.get("p99_ms") if isinstance(fsync, dict) else None
            fsync_txt = (f"{p99:.1f}ms"
                         if isinstance(p99, (int, float))
                         and not isinstance(p99, bool) else "-")
            parts.append(
                f"{label}:"
                f"{'leader' if leader else 'no-leader'}"
                f"({_cell(leader.get('node'), '?')})"
                f" tenure={tenure_txt}"
                f" elections={_cell(g.get('elections_total'), 0)}"
                f" fsync_p99={fsync_txt}"
                f" lag={_cell(lag_max, '-')}"
                f" log={_cell(g.get('log_entries'), 0)}"
                # "-" on pre-r06 payloads without the compaction fields
                f" snap={_cell(g.get('snapshot_index'), '-')}"
                f" inst={_cell(g.get('installs_received'), '-')}")
        if parts:
            lines.append("consensus: " + "  ".join(parts))
    per_class = critpath.get("per_class") if isinstance(critpath, dict) \
        else None
    if isinstance(per_class, dict) and per_class:
        parts = []
        for kind in sorted(per_class):
            c = per_class[kind]
            if not isinstance(c, dict):
                continue
            blame = c.get("blame_p50")
            dom = c.get("dominant")
            share = blame.get(dom) if isinstance(blame, dict) \
                and isinstance(dom, str) else None
            e2e = c.get("e2e_ms_p50")
            pct = (f" {100 * share / e2e:.0f}%"
                   if isinstance(share, (int, float))
                   and isinstance(e2e, (int, float))
                   and not isinstance(e2e, bool) and e2e > 0 else "")
            parts.append(f"{kind}={_cell(dom, '?')}{pct}")
        if parts:
            lines.append("critpath blame(p50): " + "  ".join(parts))
    # soak observatory (ISSUE 19): one line from /debug/soak — leak
    # verdict summary over the registered structures plus the top
    # commit-path CPU consumer when a profiler is running. A node
    # without the soak plane just loses the line.
    resources = soak.get("resources") if isinstance(soak, dict) else None
    if isinstance(resources, dict) and resources:
        leaking = soak.get("leaking")
        leaking = leaking if isinstance(leaking, (list, tuple)) else []
        growing = sum(1 for r in resources.values()
                      if isinstance(r, dict)
                      and r.get("verdict") == "growing")
        cpu = soak.get("cpu") if isinstance(soak.get("cpu"), dict) else {}
        top = cpu.get("top_commit_path")
        lines.append(
            f"soak: {len(resources)} structures"
            f" leaking={len(leaking)}"
            + (f"{sorted(leaking)}" if leaking else "")
            + f" growing={growing}"
            + (f"  cpu_top={top}" if isinstance(top, str) and top else ""))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fleetstat", description="top-like verifier fleet monitor")
    ap.add_argument("url", help="node webserver base URL "
                    "(e.g. http://127.0.0.1:8080)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll interval in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (no screen clearing)")
    args = ap.parse_args(argv)
    while True:
        try:
            fleet = fetch(args.url, "/api/fleet")
            metrics = fetch(args.url, "/api/metrics")
        except Exception as e:
            print(f"fleetstat: cannot reach {args.url}: {e}",
                  file=sys.stderr)
            return 1
        try:
            # optional surface: older nodes (or tracing off) just lose
            # the blame line, not the whole screen
            critpath = fetch(args.url, "/debug/critpath?top_k=1")
        except Exception:
            critpath = None
        try:
            # optional surface: a node predating the consensus
            # observatory just loses the consensus line
            raft = fetch(args.url, "/debug/raft")
        except Exception:
            raft = None
        try:
            # optional surface: a node without the soak observatory just
            # loses the soak line
            soak = fetch(args.url, "/debug/soak")
        except Exception:
            soak = None
        screen = render(fleet, metrics, critpath, raft, soak)
        if args.once:
            print(screen)
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + screen + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
