"""consensus_stat — a `top`-style live view of a node's consensus tier.

Polls the node webserver's consensus observatory surfaces (/debug/raft +
/api/timeseries) and renders one raft group per row — role of the local
replica, leader tenure, election count, log length, per-peer replication
lag, and the commit-path attribution percentiles (append-wait / fsync /
replicate / apply) — plus the shard heat table and a sparkline per
retained time series. Pure-stdlib (urllib + ANSI clear), so it runs
anywhere the node does::

    python -m corda_tpu_torch.tools.consensus_stat http://127.0.0.1:8080
    python -m corda_tpu_torch.tools.consensus_stat http://127.0.0.1:8080 --once

``render()`` is a pure function of the two fetched payloads — the unit
tests drive it with canned dicts, no HTTP involved. Like fleetstat, it
tolerates empty and malformed payloads: a native raft core that cannot
attribute renders "-" cells, a node without the observatory renders an
honest "(no raft groups)" screen instead of a traceback.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

#: Attribution columns, pipeline order (consensus_obs.ATTRIBUTION_COMPONENTS
#: plus the telescoped total) — repeated here so the tool stays importable
#: against an older node that predates the observatory.
_ATTRIB_COLS = ("append_wait", "fsync", "replicate", "apply", "total")

_SPARK = "▁▂▃▄▅▆▇█"


def fetch(base_url: str, path: str, timeout: float = 5.0):
    with urllib.request.urlopen(base_url.rstrip("/") + path,
                                timeout=timeout) as r:
        return json.loads(r.read().decode())


def _cell(value, default):
    """A value safe to width-format: numbers and strings pass through,
    anything else (None, nested junk) collapses to ``default``."""
    if isinstance(value, bool) or not isinstance(value, (int, float, str)):
        return default
    return value


def _ms(stats_map, comp) -> str:
    """One attribution cell: ``p50/p99`` in ms, "-" when the group's
    nodes cannot attribute that component (native-core honesty rule)."""
    stats = stats_map.get(comp) if isinstance(stats_map, dict) else None
    if not isinstance(stats, dict):
        return "-"
    p50, p99 = stats.get("p50_ms"), stats.get("p99_ms")
    if not isinstance(p50, (int, float)) or isinstance(p50, bool):
        return "-"
    if not isinstance(p99, (int, float)) or isinstance(p99, bool):
        return f"{p50:.1f}"
    return f"{p50:.1f}/{p99:.1f}"


def _sparkline(points) -> str:
    """Render a ring's rows (the ``mean`` column — index 4 of the
    ``[t, n, min, max, mean, last]`` snapshot row) as a unicode sparkline.
    Empty/malformed rows render as an empty string — never raises."""
    means = []
    for row in points if isinstance(points, (list, tuple)) else ():
        m = row[4] if isinstance(row, (list, tuple)) and len(row) >= 5 \
            else None
        if isinstance(m, (int, float)) and not isinstance(m, bool):
            means.append(float(m))
    if not means:
        return ""
    lo, hi = min(means), max(means)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int((v - lo) / span * (len(_SPARK) - 1)))]
        for v in means)


def _soak_lines(soak) -> list:
    """The soak-observatory section: one row per registered structure
    (size, declared kind, leak verdict, slope) and the subsystem CPU
    shares when a profiler is running. Empty list when the payload is
    absent/malformed — a node without the soak plane just loses the
    section, never the screen."""
    if not isinstance(soak, dict):
        return []
    resources = soak.get("resources")
    lines: list = []
    if isinstance(resources, dict) and resources:
        lines.append("soak resources (size / kind / verdict):")
        for name in sorted(resources, key=str):
            r = resources[name]
            if not isinstance(r, dict):
                continue
            verdict = _cell(r.get("verdict"), "-")
            slope = r.get("slope_per_s")
            slope_txt = f" {slope:+.3g}/s" \
                if isinstance(slope, (int, float)) \
                and not isinstance(slope, bool) and slope else ""
            flag = " !!" if verdict == "leaking" else ""
            lines.append(
                f"  {str(name):<28}{_cell(r.get('size'), '-'):>14}"
                f"  {_cell(r.get('kind'), '-'):<8}"
                f"{verdict}{slope_txt}{flag}")
    cpu = soak.get("cpu")
    if isinstance(cpu, dict):
        shares = cpu.get("shares_pct")
        if isinstance(shares, dict) and shares:
            cells = [f"{k}={v:.1f}%" for k, v in
                     sorted(shares.items(), key=lambda kv: -kv[1])
                     if isinstance(v, (int, float))
                     and not isinstance(v, bool) and v > 0]
            if cells:
                top = _cell(cpu.get("top_commit_path"), "-")
                lines.append(f"cpu shares (busy, top commit-path: {top}): "
                             + "  ".join(cells))
    return lines


def render(raft: dict, timeseries: dict | None = None,
           soak: dict | None = None) -> str:
    """One screenful: a row per raft group, the shard heat table when the
    notary shards, a sparkline per retained time series, and the soak
    observatory section (resource verdicts + CPU shares) when the node
    serves /debug/soak. Pure function of the JSON payloads — tolerates
    empty and malformed ones."""
    if not isinstance(raft, dict):
        raft = {}
    groups = raft.get("groups")
    if not isinstance(groups, dict):
        groups = {}
    lines = [
        f"consensus groups: {len(groups)}",
        f"{'GROUP':<8}{'LEADER':<10}{'TERM':>6}{'TENURE(s)':>11}"
        f"{'ELECTIONS':>11}{'LOG':>8}{'SNAP':>7}{'INST':>6}{'LAG':>5}"
        f"{'  APPEND(p50/99ms)':>19}{'FSYNC':>12}{'REPL':>12}{'APPLY':>12}",
    ]
    for label in sorted(groups, key=str):
        g = groups[label]
        if not isinstance(g, dict):
            g = {}
        leader = g.get("leader")
        if not isinstance(leader, dict):
            leader = {}
        lag = leader.get("peer_lag")
        lag_max = max((v for v in lag.values()
                       if isinstance(v, (int, float))
                       and not isinstance(v, bool)), default=0) \
            if isinstance(lag, dict) else "-"
        tenure = leader.get("leader_tenure_s")
        attrib = g.get("attribution")
        lines.append(
            f"{str(label):<8}"
            f"{str(_cell(leader.get('node'), '-')):<10}"
            f"{_cell(leader.get('term'), '-'):>6}"
            + (f"{tenure:>11.1f}" if isinstance(tenure, (int, float))
               and not isinstance(tenure, bool) else f"{'-':>11}")
            + f"{_cell(g.get('elections_total'), 0):>11}"
            f"{_cell(g.get('log_entries'), 0):>8}"
            # compaction columns (ISSUE 20): "-" on pre-r06 payloads that
            # predate the snapshot fields, real values after
            f"{_cell(g.get('snapshot_index'), '-'):>7}"
            f"{_cell(g.get('installs_received'), '-'):>6}"
            f"{_cell(lag_max, '-'):>5}"
            f"{_ms(attrib, 'append_wait'):>19}"
            f"{_ms(attrib, 'fsync'):>12}"
            f"{_ms(attrib, 'replicate'):>12}"
            f"{_ms(attrib, 'apply'):>12}")
    if not groups:
        lines.append("(no raft groups)")
    shards = raft.get("shards")
    if isinstance(shards, dict):
        skew = shards.get("skew_index")
        lines.append(
            "shard heat: skew="
            + (f"{skew:.3f}" if isinstance(skew, (int, float))
               and not isinstance(skew, bool) else "-")
            + f"  coordinator_log_bytes="
              f"{_cell(shards.get('coordinator_log_bytes'), '-')}"
            + f"  in_doubt={_cell(shards.get('coordinator_in_doubt'), 0)}"
            + f"  gc={_cell(shards.get('coordinator_compactions'), '-')}")
        rows = shards.get("shards")
        if isinstance(rows, (list, tuple)):
            cells = []
            for row in rows:
                if not isinstance(row, dict):
                    continue
                cells.append(
                    f"{_cell(row.get('shard'), '?')}:"
                    f"req={_cell(row.get('requests'), 0)}"
                    f" applied={_cell(row.get('applied'), '-')}"
                    f" reserved={_cell(row.get('reserved'), '-')}")
            if cells:
                lines.append("  " + "  ".join(cells))
    series = (timeseries or {}).get("series") \
        if isinstance(timeseries, dict) else None
    if isinstance(series, dict) and series:
        lines.append("retained series (coarsest→finest mean):")
        for name in sorted(series, key=str):
            rings = series[name]
            if not isinstance(rings, (list, tuple)):
                continue
            sparks = [s for s in (_sparkline(
                r.get("points") if isinstance(r, dict) else None)
                for r in rings) if s]
            if sparks:
                lines.append(f"  {name:<36} " + " | ".join(sparks))
    lines.extend(_soak_lines(soak))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="consensus_stat",
        description="top-like consensus observatory monitor")
    ap.add_argument("url", help="node webserver base URL "
                    "(e.g. http://127.0.0.1:8080)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll interval in seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (no screen clearing)")
    args = ap.parse_args(argv)
    while True:
        try:
            raft = fetch(args.url, "/debug/raft")
        except Exception as e:
            print(f"consensus_stat: cannot reach {args.url}: {e}",
                  file=sys.stderr)
            return 1
        try:
            # optional surface: a node predating the retained plane just
            # loses the sparklines, not the whole screen
            timeseries = fetch(args.url, "/api/timeseries")
        except Exception:
            timeseries = None
        try:
            # optional surface: /debug/soak (resource verdicts + CPU
            # shares) — a node without the soak plane loses the section
            soak = fetch(args.url, "/debug/soak")
        except Exception:
            soak = None
        screen = render(raft, timeseries, soak)
        if args.once:
            print(screen)
            return 0
        sys.stdout.write("\x1b[2J\x1b[H" + screen + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
