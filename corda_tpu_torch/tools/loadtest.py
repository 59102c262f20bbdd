"""Load-test harness: command generation, execution, state gathering,
invariant checking, and fault injection.

Reference parity: tools/loadtest (LoadTest.kt:1-211 — the generate /
interpret / execute / gatherRemoteState test shape), tests/
{SelfIssueTest,CrossCashTest}.kt, and Disruption.kt:17-105 (kill/restart
nodes, message-drop windows) — here driven against MockNetwork for
deterministic volume or the process driver for real clusters.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable

from ..core.contracts.amount import Amount, USD
from ..finance import CashIssueFlow, CashPaymentFlow, CashState


@dataclass
class LoadTest:
    """One scenario: generate commands from the model state, execute them,
    gather the remote state, check the invariant (LoadTest.kt's type)."""

    name: str
    generate: Callable[[Any, random.Random], list]
    execute: Callable[[Any, Any], None]          # (nodes_ctx, command)
    gather: Callable[[Any], Any]                  # nodes_ctx -> observed
    check: Callable[[Any, Any], None]             # (model, observed) raises


class Disruption:
    """Fault injection applied for a window of iterations
    (Disruption.kt analogs)."""

    name = "noop"

    def apply(self, ctx) -> None:  # pragma: no cover - interface
        pass

    def restore(self, ctx) -> None:  # pragma: no cover - interface
        pass


class KillRestartNode(Disruption):
    """Kill a node mid-run and restart it from its checkpoints
    (Disruption.kt's nodeKill + restart via SSH, MockNetwork edition)."""

    def __init__(self, pick: Callable[[Any], Any]):
        self.pick = pick
        self.name = "kill-restart-node"

    def apply(self, ctx) -> None:
        node = self.pick(ctx)
        restarted = node.restart()
        restarted.start()
        for key in ("nodes", "party_nodes"):
            seq = ctx.get(key)
            if seq and node in seq:
                seq[seq.index(node)] = restarted

    def restore(self, ctx) -> None:
        pass  # the restart IS the recovery


class DropMessages(Disruption):
    """Drop a fraction of bus transfers for the window (network flakiness)."""

    def __init__(self, fraction: float, seed: int = 0):
        self.fraction = fraction
        self.name = f"drop-{fraction}"
        self._rng = random.Random(seed)

    def apply(self, ctx) -> None:
        net = ctx["network"]
        self._old = net.bus.transfer_filter
        net.bus.transfer_filter = \
            lambda t: self._rng.random() >= self.fraction

    def restore(self, ctx) -> None:
        ctx["network"].bus.transfer_filter = self._old


def run_load_test(test: LoadTest, ctx, iterations: int, seed: int = 0,
                  disruptions: list[tuple[int, int, Disruption]] = ()) -> Any:
    """Run `iterations` rounds; each round generates commands from the model,
    executes them, pumps the network, and (at the end) checks invariants.
    `disruptions` = [(start_iter, end_iter, disruption)]."""
    rng = random.Random(seed)
    model: dict = {"issued": {}, "paid": []}
    active: list[Disruption] = []
    for it in range(iterations):
        for start, end, d in disruptions:
            if it == start:
                d.apply(ctx)
                active.append(d)
            if it == end and d in active:
                d.restore(ctx)
                active.remove(d)
        for command in test.generate(model, rng):
            test.execute(ctx, command)
        ctx["network"].run_network()
    for d in active:
        d.restore(ctx)
    ctx["network"].run_network()
    observed = test.gather(ctx)
    test.check(model, observed)
    return observed


# ---------------------------------------------------------------------------
# The standard scenarios (SelfIssueTest / CrossCashTest analogs)
# ---------------------------------------------------------------------------

class HangProcess(Disruption):
    """HANG a real node process under load for a window — SIGSTOP the OS
    process (it stays attached: sockets open, peers see silence, not EOF),
    SIGCONT on restore. Disruption.kt:17-105's `hang` (the reference
    suspends the remote JVM over SSH); this is the local-process edition."""

    def __init__(self, pick: Callable[[Any], Any]):
        self.pick = pick
        self.name = "hang-process"
        self._victim = None

    def apply(self, ctx) -> None:
        # runner-agnostic: the ProcessHandle delivers SIGSTOP locally or
        # via a remote `kill -STOP` over the SSH transport (testing.runner)
        self._victim = self.pick(ctx)
        self._victim.process.suspend()

    def restore(self, ctx) -> None:
        if self._victim is not None:
            self._victim.process.resume()
            self._victim = None


def run_driver_cluster_load(dsl, parties, notary_party, iterations: int = 12,
                            seed: int = 0, kill_restart_at: int | None = None,
                            hang_window: tuple[int, int] | None = None,
                            report_path: str | None = None) -> dict:
    """Drive a REAL subprocess cluster (testing.driver DriverDSL) with the
    self-issue/cross-cash mix over RPC, optionally hard-killing and
    restarting one node mid-load (LoadTest.kt executed against Driver-
    started processes + Disruption.kt's kill/restart, the real-cluster
    edition the reference runs over SSH).

    ``parties``: mutable list of NodeHandle; index 1 is the kill victim.
    ``hang_window``: (start_iter, end_iter) SIGSTOPs party 0 for those
    iterations (Disruption.kt's hang-under-load); the cluster must make
    progress around the hung member and complete once it resumes.
    Returns (and optionally writes) a BENCH-style JSON report with the
    measured flows/s and the conservation check result.
    """
    import json
    import time

    rng = random.Random(seed)
    issued_total = 0
    flows_done = 0
    hang = HangProcess(lambda ctx: ctx["victim"]) \
        if hang_window is not None else None
    if hang is not None and not (0 <= hang_window[0] < hang_window[1]
                                 < iterations):
        raise ValueError(f"hang_window {hang_window} must fall inside "
                         f"[0, {iterations})")
    hang_active = False
    t0 = time.monotonic()
    try:
        for it in range(iterations):
            if hang is not None:
                if it == hang_window[0]:
                    hang.apply({"victim": parties[0]})
                    hang_active = True
                if it == hang_window[1]:
                    hang.restore(None)
                    hang_active = False
            if kill_restart_at is not None and it == kill_restart_at:
                victim = parties[1]
                victim.process.kill()            # no goodbye, no flush
                victim.process.wait(timeout=15)
                parties[1] = dsl.restart_node(victim)
            # while a member hangs, load routes around it (the reference's
            # disruption runs expect the healthy members to keep serving)
            live = parties[1:] if hang_active and len(parties) > 1 else parties
            issuer = live[rng.randrange(len(live))]
            quantity = rng.randint(1, 500) * 100
            issuer.rpc.start_flow_and_wait(
                "CashIssueFlow", Amount(quantity, USD), b"\x01",
                issuer.rpc.node_identity().legal_identity, notary_party,
                timeout_s=120)
            issued_total += quantity
            flows_done += 1
            if len(live) > 1 and rng.random() < 0.5:
                a, b = rng.sample(range(len(live)), 2)
                balances = live[a].rpc.get_cash_balances()
                spendable = balances.get("USD", 0)
                if spendable >= 100:
                    pay = min(spendable, rng.randint(1, 50) * 100)
                    live[a].rpc.start_flow_and_wait(
                        "CashPaymentFlow", Amount(pay, USD),
                        live[b].rpc.node_identity().legal_identity,
                        timeout_s=120)
                    flows_done += 1
    finally:
        # an RPC failure mid-window must never leave the victim SIGSTOPped:
        # the driver teardown would block forever on the frozen process
        if hang is not None and hang._victim is not None:
            hang.restore(None)
    elapsed = time.monotonic() - t0
    held_total = sum(h.rpc.get_cash_balances().get("USD", 0)
                     for h in parties)
    report = {
        "metric": "driver_cluster_flows_per_sec",
        "value": round(flows_done / elapsed, 3),
        "unit": "flows/s",
        "flows": flows_done,
        "elapsed_s": round(elapsed, 1),
        "issued_total": issued_total,
        "held_total": held_total,
        "conserved": held_total == issued_total,
        "kill_restart_at": kill_restart_at,
    }
    if report_path is not None:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
    return report


def self_issue_test() -> LoadTest:
    """Nodes repeatedly self-issue cash; the invariant is that every node's
    vault total equals the model's issued total (SelfIssueTest.kt)."""

    def generate(model, rng):
        return [("issue", rng.randrange(0, 3), rng.randint(1, 500) * 100)]

    def execute(ctx, command):
        _, node_idx, quantity = command
        node = ctx["party_nodes"][node_idx]
        notary = ctx["notary"]
        fsm = node.start_flow(CashIssueFlow(
            Amount(quantity, USD), b"\x01", node.party, notary.party))
        ctx.setdefault("flows", []).append(fsm)
        ctx["model_issued"] = ctx.get("model_issued", {})
        ctx["model_issued"][node_idx] = \
            ctx["model_issued"].get(node_idx, 0) + quantity

    def gather(ctx):
        totals = {}
        for i, node in enumerate(ctx["party_nodes"]):
            totals[i] = sum(s.state.data.amount.quantity
                            for s in node.services.vault.unconsumed_states(CashState))
        return totals

    def check(model, observed):
        pass  # the caller compares against ctx["model_issued"]

    return LoadTest("SelfIssue", generate, execute, gather, check)


def cross_cash_test() -> LoadTest:
    """Nodes issue and pay each other; the invariant is conservation: the sum
    of all vault holdings equals the total issued (CrossCashTest.kt)."""

    def generate(model, rng):
        cmds = []
        if rng.random() < 0.5:
            cmds.append(("issue", rng.randrange(0, 3),
                         rng.randint(1, 500) * 100))
        if rng.random() < 0.6:
            a, b = rng.sample(range(3), 2)
            cmds.append(("pay", a, b, rng.randint(1, 50) * 100))
        return cmds

    def execute(ctx, command):
        nodes = ctx["party_nodes"]
        if command[0] == "issue":
            _, i, quantity = command
            fsm = nodes[i].start_flow(CashIssueFlow(
                Amount(quantity, USD), b"\x01", nodes[i].party,
                ctx["notary"].party))
            ctx["total_issued"] = ctx.get("total_issued", 0) + quantity
        else:
            _, a, b, quantity = command
            fsm = nodes[a].start_flow(CashPaymentFlow(
                Amount(quantity, USD), nodes[b].party))
        ctx.setdefault("flows", []).append(fsm)

    def gather(ctx):
        return sum(s.state.data.amount.quantity
                   for node in ctx["party_nodes"]
                   for s in node.services.vault.unconsumed_states(CashState))

    def check(model, observed):
        pass  # caller compares against ctx["total_issued"]

    return LoadTest("CrossCash", generate, execute, gather, check)
