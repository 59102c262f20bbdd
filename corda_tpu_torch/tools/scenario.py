"""CLI driver for the ledger scenario harness.

Runs the open-loop finance workload (observability/ledger_harness.py)
against the in-process raft-notary topology and prints the LEDGER
report as JSON — the same fields ``bench.py --ledger`` emits into
``LEDGER_r0*.json``, for interactive use:

    python -m corda_tpu_torch.tools.scenario                  # smoke shape
    python -m corda_tpu_torch.tools.scenario --full --chaos   # measured shape
    python -m corda_tpu_torch.tools.scenario --parties 12 --ops 120 --rate 20
    python -m corda_tpu_torch.tools.scenario --soak 10        # 10-min endurance

``--soak MINUTES`` runs the drift-gated endurance preset instead
(observability/soak.py): steady offered load over the sharded notary
with chaos recurring on a schedule, per-minute phase segments, resource
leak verdicts, subsystem CPU attribution and mid-run invariant
re-checks. It exits 1 on ANY leak verdict, drift-gate breach or
invariant failure, printing the repro seed line on the way out.

Exit status is non-zero when the run violated the ledger invariant
(exactly-once / replica agreement) so CI can gate on it directly.
"""
from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="corda_tpu_torch.tools.scenario",
        description="open-loop ledger scenario runner")
    ap.add_argument("--full", action="store_true",
                    help="measured shape (24 parties, 240 ops) instead of "
                         "the CPU smoke shape")
    ap.add_argument("--chaos", action="store_true",
                    help="arm the partition / leader-kill / append-drop "
                         "fault windows")
    ap.add_argument("--hot-state", action="store_true",
                    help="hostile preset: every payment targets one "
                         "exchange-like party, then a deliberate "
                         "double-spend replay burst (combine with --full "
                         "for the measured shape)")
    ap.add_argument("--byzantine", action="store_true",
                    help="hostile-client preset: replayed, mis-signed and "
                         "malformed transactions injected mid-load on a "
                         "sharded topology; exits 1 unless every one was "
                         "rejected with throughput held and zero "
                         "reservation leaks (combine with --full / "
                         "--chaos for the measured shape)")
    ap.add_argument("--shards", type=int, default=None,
                    help="sharded-notary preset: partition the uniqueness "
                         "domain over N raft groups with a cross-shard "
                         "payment mix (combine with --full for the "
                         "measured shape)")
    ap.add_argument("--cross-shard-pct", type=float, default=None,
                    help="fraction of payments forced multi-coin so their "
                         "inputs straddle shards (default 0.35 with "
                         "--shards)")
    ap.add_argument("--soak", type=float, default=None, metavar="MINUTES",
                    help="endurance preset: MINUTES of steady load over "
                         "the sharded notary with recurring chaos, leak "
                         "verdicts, CPU attribution and drift gates; "
                         "exits 1 on any leak / drift breach / invariant "
                         "failure")
    ap.add_argument("--parties", type=int, default=None)
    ap.add_argument("--ops", type=int, default=None,
                    help="total operations (issue ops included)")
    ap.add_argument("--rate", type=float, default=None,
                    help="offered operations per second (open loop)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=None,
                    help="uniqueness-provider commit timeout (seconds)")
    ap.add_argument("--device", default="cuda",
                    help="device of the nodes and the shared verifier "
                         "(default cuda, the card; cpu runs the plain "
                         "kernels and the host route)")
    return ap


def build_config(argv=None):
    from ..observability.ledger_harness import LedgerScenarioConfig

    args = _parser().parse_args(argv)

    if args.byzantine:
        cfg = LedgerScenarioConfig.byzantine(full=args.full)
        cfg.chaos = args.chaos
        if args.shards is not None and args.shards > 1:
            cfg.shards = args.shards
        if args.cross_shard_pct is not None:
            cfg.cross_shard_pct = args.cross_shard_pct
    elif args.shards is not None and args.shards > 1:
        cfg = LedgerScenarioConfig.sharded(
            shards=args.shards,
            cross_shard_pct=(args.cross_shard_pct
                             if args.cross_shard_pct is not None else 0.35),
            full=args.full)
        cfg.chaos = args.chaos
    elif args.hot_state:
        cfg = LedgerScenarioConfig.hot_state(full=args.full)
        cfg.chaos = args.chaos
    elif args.full:
        cfg = LedgerScenarioConfig.full(chaos=args.chaos)
    else:
        cfg = LedgerScenarioConfig(chaos=args.chaos)
    if args.parties is not None:
        cfg.parties = args.parties
    if args.ops is not None:
        cfg.operations = args.ops
    if args.rate is not None:
        cfg.rate_tx_per_sec = args.rate
    if args.seed is not None:
        cfg.seed = args.seed
    if args.timeout is not None:
        cfg.provider_timeout_s = args.timeout
    cfg.device = args.device
    return cfg


def soak_main(args) -> int:
    """The --soak preset: run the endurance scenario and hold it to the
    full soak gate (tools/benchguard.guard_soak — leak verdicts, drift
    gates, mid-run invariant re-checks, CPU sanity). Exit 1 on any
    breach, with the repro seed line printed to stderr so the failure is
    replayable (the chaos schedule, workload mix and fault decisions are
    all derived from the one seed)."""
    from ..observability.soak import SoakConfig, run_soak
    from .benchguard import guard_soak

    cfg = SoakConfig(minutes=args.soak)
    if args.seed is not None:
        cfg.seed = args.seed
    if args.rate is not None:
        cfg.rate_tx_per_sec = args.rate
    if args.parties is not None:
        cfg.parties = args.parties
    if args.shards is not None:
        cfg.shards = max(1, args.shards)
    if args.cross_shard_pct is not None:
        cfg.cross_shard_pct = args.cross_shard_pct
    if args.timeout is not None:
        cfg.provider_timeout_s = args.timeout
    cfg.device = args.device
    report = run_soak(cfg)
    report.pop("trace_sample", None)
    print(json.dumps(report, indent=2, sort_keys=True, default=str))
    problems = guard_soak(report)
    if problems:
        for p in problems:
            print(f"SOAK FAILED: {p}", file=sys.stderr)
        # the chaos conftest repro discipline: one seed reproduces the
        # workload mix, the recurring chaos schedule and every fault
        # decision inside the windows
        print(f"soak seed {cfg.seed} — reproduce with "
              f"python -m corda_tpu_torch.tools.scenario --soak {args.soak:g} "
              f"--seed {cfg.seed}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    from ..observability.ledger_harness import run_ledger_scenario

    args = _parser().parse_args(argv)
    if args.soak is not None:
        return soak_main(args)

    report = run_ledger_scenario(build_config(argv))
    print(json.dumps(report, indent=2, sort_keys=True, default=str))
    ok = report["exactly_once_ok"] and report["replicas_agree"]
    if report.get("hot_state"):
        # the hostile gate: every deliberate double spend rejected, and
        # the hot vault still committed real throughput
        ok = ok and report["double_spend_rejection_rate"] == 1.0 \
            and report["committed_tx_per_sec"] > 0
    if report.get("byzantine"):
        # the hostile-client gate (ISSUE 20): every injected replay /
        # mis-sign / malformed submission rejected, honest throughput
        # held, and no byzantine attempt left a reservation behind
        ok = ok and report["byzantine_attempted"] > 0 \
            and report["byzantine_rejection_rate"] == 1.0 \
            and report["committed_tx_per_sec"] > 0 \
            and report.get("ledger_shard_reserved_leftover", 0) == 0
    if report.get("ledger_shard_count", 1) > 1:
        # the sharded gate: exactly-once held across shards (base ok
        # already covers it), the cross-shard 2PC path actually committed
        # work, and no reservation outlived the run
        ok = ok and report.get("ledger_shard_cross_committed", 0) > 0 \
            and report.get("ledger_shard_reserved_leftover", 0) == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
