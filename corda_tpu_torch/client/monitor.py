"""NodeMonitorModel — one subscription point turning RPC feeds into live
observable models.

Reference parity: client/jfx's NodeMonitorModel + the observable-value
utilities (client/jfx/.../Models.kt, NodeMonitorModel tracking vault,
transactions, state-machine progress per flow over RPC). JavaFX property
bindings become plain observable lists/values with callbacks — the same
aggregation layer the explorer/GUI consumed, usable from any Python UI,
notebook, or test.
"""
from __future__ import annotations

import threading
from typing import Any, Callable


class ObservableValue:
    """A value plus change callbacks (the Property binding analog)."""

    def __init__(self, initial: Any = None):
        self._lock = threading.Lock()
        self._value = initial
        self._observers: list[Callable] = []

    @property
    def value(self):
        with self._lock:
            return self._value

    def set(self, value) -> None:
        with self._lock:
            self._value = value
            observers = list(self._observers)
        for cb in observers:
            cb(value)

    def update(self, fn: Callable[[Any], Any]) -> None:
        """Atomic read-modify-write (concurrent feed callbacks must not lose
        increments)."""
        with self._lock:
            self._value = value = fn(self._value)
            observers = list(self._observers)
        for cb in observers:
            cb(value)

    def observe(self, cb: Callable) -> None:
        self._observers.append(cb)


class ObservableList:
    """An append-only observable list (the ObservableList utilities role)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: list = []
        self._observers: list[Callable] = []

    def append(self, item) -> None:
        with self._lock:
            self._items.append(item)
            observers = list(self._observers)
        for cb in observers:
            cb(item)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._items)

    def observe(self, cb: Callable) -> None:
        self._observers.append(cb)

    def __len__(self):
        return len(self._items)


class NodeMonitorModel:
    """Subscribe once, read live models: state-machine events, vault
    updates, verified transactions, and derived aggregates."""

    def __init__(self):
        self.state_machine_events = ObservableList()   # ("add"/"remove", info)
        self.vault_updates = ObservableList()          # VaultUpdate
        self.transactions = ObservableList()           # SignedTransaction
        self.in_flight_flows = ObservableValue(0)
        self.tx_count = ObservableValue(0)

    def register(self, ops) -> "NodeMonitorModel":
        """Wire every feed of a CordaRPCOps (in-process or remote proxy).
        Subscriptions attach BEFORE snapshot seeding and seeding dedupes by
        transaction id, so events landing in the snapshot/subscribe gap are
        neither lost nor double-counted."""
        self._seen_tx = set()
        self._seen_sm = set()
        sm_feed = ops.state_machines_feed()
        sm_feed.subscribe(self._on_sm_event)
        for info in list(sm_feed.snapshot):
            self._on_sm_event(("add", info))
            if info.done:
                self._on_sm_event(("remove", info))

        vault_feed = ops.vault_feed()
        vault_feed.subscribe(self.vault_updates.append)
        if vault_feed.snapshot:
            # fold the pre-existing holdings into one initial update
            # (the reference's initial Vault.Update from the snapshot)
            from ..node.vault import VaultUpdate
            self.vault_updates.append(
                VaultUpdate((), tuple(vault_feed.snapshot)))

        tx_feed = ops.verified_transactions_feed()
        tx_feed.subscribe(self._on_tx)
        for stx in list(tx_feed.snapshot):
            self._on_tx(stx)
        return self

    def _on_sm_event(self, event) -> None:
        kind, info = event
        key = (kind, info.run_id)
        if key in self._seen_sm:   # seeded AND delivered live: count once
            return
        self._seen_sm.add(key)
        self.state_machine_events.append((kind, info))
        delta = 1 if kind == "add" else -1
        self.in_flight_flows.update(lambda v: max(0, v + delta))

    def _on_tx(self, stx) -> None:
        if stx.id in self._seen_tx:
            return
        self._seen_tx.add(stx.id)
        self.transactions.append(stx)
        self.tx_count.update(lambda v: v + 1)
