"""Vault: tracks relevant states, streams updates, soft-locks in-flight spends.

Reference parity: NodeVaultService (node/services/vault/NodeVaultService.kt:62
— notifyAll :230, soft locks :261-296), Vault.Update model, the
unconsumed/consumed StateStatus axis of the vault query API
(core/node/services/vault/QueryCriteria.kt), and soft-lock auto-release on
flow completion (VaultSoftLockManager.kt).

The SQL/Hibernate query engine of the reference maps here to predicate-based
in-memory querying (the JDBC layer is a storage backend concern, not an API
one). Two query surfaces: `query()` covers the quick axes used by the finance
layer (status, state type, owners, notary); `query_by()` is the full
QueryCriteria engine (node.query) with linear/fungible/custom criteria,
And/Or composition, time conditions, soft-lock filters, paging and sorting.
"""
from __future__ import annotations

import datetime as _dt
import threading
from dataclasses import dataclass, field

from ..core.contracts.structures import StateAndRef, StateRef
from .query import (Page, PageSpecification, QueryCriteria, Sort, VaultRecord,
                    run_query)


@dataclass(frozen=True)
class VaultUpdate:
    """One atomic vault transition (Vault.Update)."""

    consumed: tuple[StateAndRef, ...]
    produced: tuple[StateAndRef, ...]

    @property
    def is_empty(self) -> bool:
        return not self.consumed and not self.produced


from ..core.serialization import register_type as _register_type  # noqa: E402

# vault updates cross the RPC wire as pushed feed observations
_register_type("vault.VaultUpdate", VaultUpdate,
               to_fields=lambda u: [list(u.consumed), list(u.produced)],
               from_fields=lambda f: VaultUpdate(tuple(f[0]), tuple(f[1])))


class SoftLockError(Exception):
    pass


class NodeVaultService:
    def __init__(self, hub, clock=None):
        self.hub = hub
        self.clock = clock or (lambda: _dt.datetime.now(_dt.timezone.utc))
        self._lock = threading.Lock()
        self._unconsumed: dict[StateRef, StateAndRef] = {}
        self._consumed: dict[StateRef, StateAndRef] = {}
        self._recorded_time: dict[StateRef, _dt.datetime] = {}
        self._consumed_time: dict[StateRef, _dt.datetime] = {}
        self._soft_locks: dict[StateRef, str] = {}      # ref -> lock id (flow id)
        self._observers: list = []
        self._tx_notes: dict = {}                       # tx_id -> [notes]

    # -- transaction notes (CordaRPCOps.addVaultTransactionNote) ------------
    def add_transaction_note(self, tx_id, note: str) -> None:
        with self._lock:
            self._tx_notes.setdefault(tx_id, []).append(note)

    def get_transaction_notes(self, tx_id) -> list[str]:
        with self._lock:
            return list(self._tx_notes.get(tx_id, ()))

    # -- relevance ----------------------------------------------------------
    def _is_relevant(self, state) -> bool:
        our_keys = self.hub.key_management.keys
        participants = getattr(state.data, "participants", [])
        keys = {getattr(p, "owning_key", p) for p in participants}
        return any(any(leaf in our_keys for leaf in k.keys) for k in keys)

    # -- ingestion (NodeVaultService.notifyAll :230) -------------------------
    def notify_all(self, txs) -> list[VaultUpdate]:
        updates = []
        for stx in txs:
            wtx = stx.tx if hasattr(stx, "tx") else stx
            with self._lock:
                now = self.clock()
                consumed = []
                for ref in wtx.inputs:
                    sar = self._unconsumed.pop(ref, None)
                    if sar is not None:
                        self._consumed[ref] = sar
                        self._consumed_time[ref] = now
                        self._soft_locks.pop(ref, None)
                        consumed.append(sar)
                produced = []
                for i, out in enumerate(wtx.outputs):
                    if self._is_relevant(out):
                        sar = StateAndRef(out, StateRef(wtx.id, i))
                        self._unconsumed[sar.ref] = sar
                        self._recorded_time[sar.ref] = now
                        produced.append(sar)
            update = VaultUpdate(tuple(consumed), tuple(produced))
            if not update.is_empty:
                updates.append(update)
                for cb in list(self._observers):
                    cb(update)
        return updates

    def add_update_observer(self, cb) -> None:
        self._observers.append(cb)

    # -- queries -------------------------------------------------------------
    def unconsumed_states(self, state_type: type | None = None,
                          include_soft_locked: bool = True) -> list[StateAndRef]:
        with self._lock:
            out = []
            for sar in self._unconsumed.values():
                if state_type is not None and not isinstance(sar.state.data, state_type):
                    continue
                if not include_soft_locked and sar.ref in self._soft_locks:
                    continue
                out.append(sar)
            return out

    def query(self, state_type: type | None = None, status: str = "unconsumed",
              owner_keys=None, notary=None) -> list[StateAndRef]:
        """The QueryCriteria axes: status ∈ {unconsumed, consumed, all}."""
        with self._lock:
            pools = {"unconsumed": [self._unconsumed], "consumed": [self._consumed],
                     "all": [self._unconsumed, self._consumed]}[status]
            out = []
            for pool in pools:
                for sar in pool.values():
                    if state_type is not None and not isinstance(sar.state.data, state_type):
                        continue
                    if notary is not None and sar.state.notary != notary:
                        continue
                    if owner_keys is not None:
                        owner = getattr(sar.state.data, "owner", None)
                        key = getattr(owner, "owning_key", owner)
                        if key not in set(owner_keys):
                            continue
                    out.append(sar)
            return out

    def query_by(self, criteria: QueryCriteria | None = None,
                 paging: PageSpecification | None = None,
                 sorting: Sort | None = None) -> Page:
        """Full QueryCriteria engine (reference vaultQueryBy): composable
        criteria + paging + sorting over all vault records. See node.query
        for the criteria classes."""
        with self._lock:
            records = [
                VaultRecord(sar, "unconsumed", self._recorded_time.get(ref),
                            None, self._soft_locks.get(ref))
                for ref, sar in self._unconsumed.items()
            ] + [
                VaultRecord(sar, "consumed", self._recorded_time.get(ref),
                            self._consumed_time.get(ref), None)
                for ref, sar in self._consumed.items()
            ]
        return run_query(records, criteria, paging, sorting)

    # -- soft locking (NodeVaultService :261-296) ----------------------------
    def soft_lock_reserve(self, lock_id: str, refs) -> None:
        with self._lock:
            refs = list(refs)
            for ref in refs:
                holder = self._soft_locks.get(ref)
                if holder is not None and holder != lock_id:
                    raise SoftLockError(
                        f"State {ref} is locked by {holder}")
                if ref not in self._unconsumed:
                    raise SoftLockError(f"State {ref} is not unconsumed")
            for ref in refs:
                self._soft_locks[ref] = lock_id

    def soft_lock_release(self, lock_id: str, refs=None) -> None:
        with self._lock:
            if refs is None:
                for ref in [r for r, holder in self._soft_locks.items()
                            if holder == lock_id]:
                    del self._soft_locks[ref]
            else:
                for ref in refs:
                    if self._soft_locks.get(ref) == lock_id:
                        del self._soft_locks[ref]

    def soft_locked_states(self, lock_id: str | None = None) -> list[StateRef]:
        with self._lock:
            return [r for r, holder in self._soft_locks.items()
                    if lock_id is None or holder == lock_id]

    # -- coin selection (the spend path of OnLedgerAsset) --------------------
    def try_lock_states_for_spending(self, lock_id: str, amount_quantity: int,
                                     state_type: type,
                                     quantity_of=lambda s: s.amount.quantity,
                                     state_filter=None) -> list[StateAndRef]:
        """Greedy selection of unlocked fungible states covering the quantity;
        atomically soft-locks the selection (unconsumedStatesForSpending).
        ``state_filter`` restricts eligibility — e.g. to one currency, so a
        multi-currency vault never pays a USD price in GBP coins."""
        with self._lock:
            selected, total = [], 0
            for sar in self._unconsumed.values():
                if not isinstance(sar.state.data, state_type):
                    continue
                if state_filter is not None and not state_filter(sar.state.data):
                    continue
                if sar.ref in self._soft_locks:
                    continue
                selected.append(sar)
                total += quantity_of(sar.state.data)
                if total >= amount_quantity:
                    break
            if total < amount_quantity:
                return []
            for sar in selected:
                self._soft_locks[sar.ref] = lock_id
            return selected
