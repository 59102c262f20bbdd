"""benchtrend — the repo's performance trajectory as one table.

The driver locks every measured round into a ``*_r0N.json`` artifact at
the repo root (BENCH_r0*.json kernel/service rounds, MULTICHIP_r0*.json
fleet rounds, LEDGER_r0*.json end-to-end ledger rounds). benchguard
turns those into regression floors; this tool turns them into the
human-readable trend line::

    python -m corda_tpu_torch.tools.benchtrend                 # all families
    python -m corda_tpu_torch.tools.benchtrend --family ledger
    python -m corda_tpu_torch.tools.benchtrend --family bench \
        --metrics value,service_path_verifies_per_sec

Each row is one round; the Δ% column tracks the first metric against the
previous round, so a regression reads as a negative delta at a glance.
``trend_rows()`` / ``render_table()`` are pure functions of the parsed
artifacts — the tests feed them canned dicts.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

from . import benchguard

#: family → (trajectory glob, default metric columns). The first metric
#: is the headline one the Δ% column tracks; "higher"/"lower" direction
#: is only cosmetic here (benchguard owns enforcement).
FAMILIES = {
    "bench": (benchguard.default_trajectory_paths,
              ("value", "service_path_verifies_per_sec", "vs_baseline",
               "tx_verify_p50_ms_batch1")),
    "multichip": (benchguard.multichip_trajectory_paths,
                  ("aggregate_verifies_per_sec", "n_devices", "ok",
                   "recovery_s")),
    "ledger": (benchguard.ledger_trajectory_paths,
               ("committed_tx_per_sec", "e2e_ms_p99",
                "notary_uniqueness_p99_ms", "slo_error_budget_pct",
                "exactly_once_ok",
                # tail forensics (rounds before r03 render "-")
                "ledger_critpath_dominant_issue",
                "ledger_critpath_dominant_pay",
                "ledger_critpath_dominant_settle",
                # shard scaling (rounds before r04 render "-")
                "ledger_shard_count",
                "shard_scaling_efficiency_pct",
                "shard_sweep_abort_rate",
                # consensus observatory (rounds before r05 render "-")
                "ledger_raft_fsync_ms_p99",
                "ledger_raft_replicate_ms_p99",
                "ledger_shard_skew_index")),
    # soak observatory (ISSUE 19): endurance rounds. Every column is
    # tolerant of pre-soak artifacts — a missing field renders "-".
    "soak": (benchguard.soak_trajectory_paths,
             ("committed_tx_per_sec", "soak_minutes",
              "soak_throughput_slope_pct_per_min",
              "soak_p99_slope_pct_per_min", "soak_drift_ok",
              "soak_leak_ok", "soak_invariant_ok",
              "soak_cpu_top_commit_path", "soak_cpu_share_sum_pct",
              "soak_chaos_cycles")),
}

_ROUND_RE = re.compile(r"_r(\d+)\.json$")


def _round_of(path: str) -> str:
    m = _ROUND_RE.search(os.path.basename(path))
    return f"r{int(m.group(1)):02d}" if m else os.path.basename(path)


def load_rounds(family: str, root: str | None = None,
                paths: list[str] | None = None) -> list[tuple[str, dict]]:
    """[(round_label, parsed_artifact)] oldest-first for one family."""
    glob_fn, _ = FAMILIES[family]
    if paths is None:
        paths = glob_fn(root) if root is not None else glob_fn()
    out = []
    for path in sorted(paths):
        try:
            with open(path, encoding="utf-8") as f:
                obj = json.load(f)
        except (OSError, ValueError):
            continue
        out.append((_round_of(path), benchguard.parse_artifact(obj)))
    return out


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:,.2f}" if abs(v) < 1e6 else f"{v:,.0f}"
    if isinstance(v, int):
        return f"{v:,}"
    return "-" if v is None else str(v)


def trend_rows(rounds: list[tuple[str, dict]],
               metrics: tuple[str, ...]) -> list[dict]:
    """One dict per round: label, formatted cells, and Δ% of the first
    metric vs the previous round (None when either side is missing)."""
    rows = []
    prev = None
    for label, run in rounds:
        head = run.get(metrics[0]) if metrics else None
        delta = None
        if isinstance(head, (int, float)) and not isinstance(head, bool) \
                and isinstance(prev, (int, float)) and prev:
            delta = 100.0 * (head - prev) / prev
        rows.append({
            "round": label,
            "cells": [_fmt(run.get(m)) for m in metrics],
            "delta_pct": delta,
            "smoke": bool(run.get("smoke")),
        })
        if isinstance(head, (int, float)) and not isinstance(head, bool):
            prev = head
    return rows


def render_table(family: str, rounds: list[tuple[str, dict]],
                 metrics: tuple[str, ...]) -> str:
    if not rounds:
        return f"{family}: (no artifacts)"
    rows = trend_rows(rounds, metrics)
    headers = ["ROUND"] + list(metrics) + ["Δ%"]
    body = [[r["round"] + (" (smoke)" if r["smoke"] else "")] + r["cells"]
            + ["" if r["delta_pct"] is None else f"{r['delta_pct']:+.1f}%"]
            for r in rows]
    widths = [max(len(h), *(len(b[i]) for b in body))
              for i, h in enumerate(headers)]
    lines = [family,
             "  ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip()]
    for b in body:
        lines.append("  ".join(c.ljust(w)
                               for c, w in zip(b, widths)).rstrip())
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="corda_tpu_torch.tools.benchtrend",
        description="render the *_r0N.json artifact trajectory as tables")
    ap.add_argument("--family", choices=sorted(FAMILIES) + ["all"],
                    default="all")
    ap.add_argument("--root", default=None,
                    help="directory holding the artifacts "
                         "(default: repo root)")
    ap.add_argument("--metrics", default=None,
                    help="comma-separated metric columns (default: the "
                         "family's standard set)")
    args = ap.parse_args(argv)
    families = sorted(FAMILIES) if args.family == "all" else [args.family]
    blocks = []
    for fam in families:
        _, default_metrics = FAMILIES[fam]
        metrics = (tuple(m for m in args.metrics.split(",") if m)
                   if args.metrics else default_metrics)
        blocks.append(render_table(fam, load_rounds(fam, root=args.root),
                                   metrics))
    try:
        print("\n\n".join(blocks))
    except BrokenPipeError:  # `benchtrend | head` closing the pipe is fine
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())
