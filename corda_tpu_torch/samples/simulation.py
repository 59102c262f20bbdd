"""Headless multi-bank simulation over MockNetwork.

Reference parity: the network-visualiser's in-process `Simulation`
(samples/network-visualiser/.../netmap/simulation/Simulation.kt:43 +
IRSSimulation): a deterministic pseudo-random trading day among N banks on
one MockNetwork, driven step-by-step, with an observable event stream — the
data the JavaFX map animated. The GUI becomes the event list / observer
callbacks (consume them from a TUI, a notebook, or tests); everything else
is the same shape: a bank-of-corda issuer, a notary, N trading banks, cash
issues and payments flowing between random pairs.

    sim = Simulation(n_banks=4, seed=11)
    sim.run(steps=20)
    sim.balances()          # {bank name: cents}
    sim.events              # [(step, kind, detail), ...]

A copy of the reference's module; ``Simulation(device=...)`` (default
"cuda", raising without CUDA) hands its device to ``MockNetwork(device=)``.
"""
from __future__ import annotations

import numpy as np

from ..core.contracts.amount import Amount, USD
from ..device import DEFAULT_DEVICE
from ..finance import CashIssueFlow, CashPaymentFlow, CashState
from ..flows import FlowException
from ..testing import MockNetwork


class Simulation:
    def __init__(self, n_banks: int = 4, seed: int = 11,
                 issue_cents: int = 1_000_00, device=DEFAULT_DEVICE):
        self.rng = np.random.default_rng(seed)
        self.network = MockNetwork(device=device)
        self.notary = self.network.create_notary_node()
        self.issuer = self.network.create_node("O=Bank of Corda, L=London, C=GB")
        self.banks = [
            self.network.create_node(f"O=Bank {chr(65 + i)}, L=City {i}, C=GB")
            for i in range(n_banks)
        ]
        self.network.start_nodes()
        self.events: list[tuple[int, str, str]] = []
        self._observers: list = []
        self._step = 0
        # seed every bank with cash from the issuer (the simulation prologue)
        for i, bank in enumerate(self.banks):
            self._run_flow(self.issuer, CashIssueFlow(
                Amount(issue_cents, USD), bytes([i + 1]), bank.party,
                self.notary.party), f"issue->{bank.party.name}")

    # -- event stream (the visualiser feed) ----------------------------------
    def add_observer(self, cb) -> None:
        self._observers.append(cb)

    def _emit(self, kind: str, detail: str) -> None:
        ev = (self._step, kind, detail)
        self.events.append(ev)
        for cb in self._observers:
            cb(ev)

    # -- stepping ------------------------------------------------------------
    def _run_flow(self, node, flow, label: str):
        fsm = node.start_flow(flow)
        self.network.run_network()
        try:
            result = fsm.result_future.result(timeout=10)
            self._emit("flow-complete", label)
            return result
        except FlowException as e:
            self._emit("flow-failed", f"{label}: {e}")
            return None

    def iterate(self) -> None:
        """One simulation step: a random bank pays a random other bank a
        random amount (Simulation.iterate's random-deal role)."""
        self._step += 1
        payer, payee = (self.banks[int(i)] for i in
                        self.rng.choice(len(self.banks), size=2, replace=False))
        amount = int(self.rng.integers(1_00, 200_00))
        self._emit("payment-start",
                   f"{payer.party.name} -> {payee.party.name} ${amount/100:.2f}")
        self._run_flow(payer, CashPaymentFlow(Amount(amount, USD), payee.party),
                       f"pay {payer.party.name}->{payee.party.name}")

    def run(self, steps: int = 10) -> "Simulation":
        for _ in range(steps):
            self.iterate()
        return self

    # -- observation ---------------------------------------------------------
    def balances(self) -> dict[str, int]:
        out = {}
        for bank in self.banks:
            states = bank.services.vault.unconsumed_states(CashState)
            out[str(bank.party.name)] = sum(
                s.state.data.amount.quantity for s in states)
        return out

    def total_cents(self) -> int:
        return sum(self.balances().values())


def main() -> None:
    sim = Simulation(n_banks=4, seed=11).run(steps=12)
    print(f"{len(sim.events)} events over 12 steps")
    for name, cents in sorted(sim.balances().items()):
        print(f"  {name:32} ${cents/100:12,.2f}")
    print(f"  conservation: total ${sim.total_cents()/100:,.2f}")


if __name__ == "__main__":
    main()
