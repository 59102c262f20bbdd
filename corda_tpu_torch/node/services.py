"""ServiceHub: the service locator every flow and node component sees.

Reference parity: ServiceHub (core/node/ServiceHub.kt), NodeInfo,
TransactionStorage (Services.kt / storage SPI), NetworkMapCache lookups.
The hub composes: messaging, validated-tx storage, identity, key management,
attachments, the verifier service, and (when started) the state machine.
The port's hub also names the device its node's own device work runs on
(``ServiceHub.device``).
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass

from ..core.contracts.structures import Attachment
from ..core.crypto.keys import KeyPair, PublicKey
from ..core.crypto.secure_hash import SecureHash
from ..core.crypto.signatures import Crypto, DigitalSignatureWithKey
from ..core.identity import Party
from ..device import DEFAULT_DEVICE, resolve_device


class InMemoryAttachmentStorage:
    """Content-addressed attachment store (NodeAttachmentService semantics:
    import returns the hash id; open verifies by construction since the id IS
    the hash — NodeAttachmentService.kt:35,148)."""

    def __init__(self):
        self._blobs: dict[SecureHash, bytes] = {}

    def import_attachment(self, data: bytes) -> SecureHash:
        att_id = SecureHash.sha256(data)
        self._blobs.setdefault(att_id, bytes(data))
        return att_id

    def open_attachment(self, att_id: SecureHash) -> Attachment | None:
        data = self._blobs.get(att_id)
        return Attachment(att_id, data) if data is not None else None

    def has_attachment(self, att_id: SecureHash) -> bool:
        return att_id in self._blobs


class InMemoryIdentityService:
    """key → Party resolution, including verified anonymous identities
    (InMemoryIdentityService.kt:1-162: registerAnonymousIdentity with
    ownership proof, partyFromAnonymous)."""

    def __init__(self, parties=()):
        self._by_key: dict[PublicKey, Party] = {}
        self._anonymous: dict[PublicKey, Party] = {}
        for p in parties:
            self.register(p)

    def register(self, party: Party) -> None:
        self._by_key[party.owning_key] = party

    def party_from_key(self, key: PublicKey) -> Party | None:
        return self._by_key.get(key) or self._anonymous.get(key)

    def parties_from_keys(self, keys) -> tuple[Party, ...]:
        return tuple(p for p in (self.party_from_key(k) for k in keys)
                     if p is not None)

    # -- confidential identities --------------------------------------------
    @staticmethod
    def ownership_content(anonymous_key: PublicKey, owner_name) -> bytes:
        """The canonical bytes a well-known identity signs to attest it owns
        an anonymous key (the certificate-path role of the reference's
        registerAnonymousIdentity, X.509 replaced by the canonical codec)."""
        from ..core.serialization import serialize
        return serialize(["confidential-identity", anonymous_key,
                          str(owner_name)])

    def verify_and_register_anonymous(self, anonymous, well_known: Party,
                                      signature: bytes) -> None:
        """Validate the ownership attestation and record the mapping;
        raises on a bad signature (registerAnonymousIdentity semantics)."""
        from ..core.crypto.signatures import DigitalSignatureWithKey
        content = self.ownership_content(anonymous.owning_key, well_known.name)
        DigitalSignatureWithKey(signature, well_known.owning_key).verify(content)
        self._anonymous[anonymous.owning_key] = well_known

    def well_known_party_from_anonymous(self, party) -> Party | None:
        """partyFromAnonymous: resolve an AnonymousParty (or pass a Party
        through) to its verified well-known identity."""
        if isinstance(party, Party):
            return party
        return self._anonymous.get(party.owning_key)


@dataclass(frozen=True)
class ServiceInfo:
    """An advertised service (notary etc.) — ServiceInfo/ServiceType analog."""

    type: str           # e.g. "corda.notary.simple", "corda.notary.validating"
    name: str | None = None


@dataclass(frozen=True)
class NodeInfo:
    """Directory entry for a node (core NodeInfo: address + identity +
    advertised services)."""

    address: str
    legal_identity: Party
    advertised_services: tuple[ServiceInfo, ...] = ()

    @property
    def notary_identity(self) -> Party:
        return self.legal_identity


class TransactionStorage:
    """Validated-transaction store with commit listeners
    (DBTransactionStorage + its Rx `updates` feed analog)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._txs: dict = {}
        self._listeners: list = []

    def add_transaction(self, stx, notify: bool = True) -> bool:
        with self._lock:
            fresh = stx.id not in self._txs
            if fresh:
                self._txs[stx.id] = stx
        if fresh and notify:
            self.notify_listeners(stx)
        return fresh

    def notify_listeners(self, stx) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for cb in listeners:
            cb(stx)

    def get_transaction(self, tx_id):
        with self._lock:
            return self._txs.get(tx_id)

    def add_commit_listener(self, cb) -> None:
        with self._lock:
            self._listeners.append(cb)

    @property
    def transactions(self) -> list:
        with self._lock:
            return list(self._txs.values())


class DurableTransactionStorage(TransactionStorage):
    """Validated-tx store persisted on the kvlog engine (DBTransactionStorage
    role): canonical-codec blobs keyed by tx id, replayed at open."""

    def __init__(self, path: str, use_native: bool | None = None):
        super().__init__()
        from ..core.serialization import deserialize, serialize
        from ..storage import KvStore
        self._serialize = serialize
        self._kv = KvStore(path, use_native=use_native)
        for key, blob in self._kv.items():
            stx = deserialize(blob)
            self._txs[stx.id] = stx

    def add_transaction(self, stx, notify: bool = True) -> bool:
        with self._lock:
            fresh = stx.id not in self._txs
            if fresh:
                self._kv[stx.id.bytes] = self._serialize(stx)
                self._txs[stx.id] = stx
        if fresh and notify:
            self.notify_listeners(stx)
        return fresh

    def close(self) -> None:
        self._kv.close()


class KeyManagementService:
    """Signing keys + fresh-key generation
    (PersistentKeyManagementService / E2ETestKeyManagementService analog).

    ``store_path`` makes fresh (confidential-identity) keys DURABLE: each
    generated/added pair is appended to the store and reloaded on
    construction — without it a restarted node would filter its own
    fresh-key-owned vault states out as irrelevant (review r3)."""

    def __init__(self, key_pairs=(), store_path: str | None = None):
        self._keys: dict[PublicKey, KeyPair] = {kp.public: kp for kp in key_pairs}
        self._store_path = store_path
        if store_path is not None and os.path.exists(store_path):
            from ..core.crypto.keys import PrivateKey
            from ..core.crypto.schemes import scheme_by_id
            with open(store_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    sid, priv_hex, pub_hex = json.loads(line)
                    scheme = scheme_by_id(sid)
                    kp = KeyPair(PublicKey(scheme, bytes.fromhex(pub_hex)),
                                 PrivateKey(scheme, bytes.fromhex(priv_hex)))
                    self._keys[kp.public] = kp

    def _persist(self, kp: KeyPair) -> None:
        if self._store_path is None:
            return
        with open(self._store_path, "a") as f:
            f.write(json.dumps([kp.public.scheme.scheme_number_id,
                                kp.private.encoded.hex(),
                                kp.public.encoded.hex()]) + "\n")
            f.flush()
            os.fsync(f.fileno())

    @property
    def keys(self) -> set[PublicKey]:
        return set(self._keys)

    def fresh_key(self, scheme=None) -> KeyPair:
        from ..core.crypto.keys import generate_keypair
        from ..core.crypto.schemes import DEFAULT_SIGNATURE_SCHEME
        kp = generate_keypair(scheme or DEFAULT_SIGNATURE_SCHEME)
        self._keys[kp.public] = kp
        self._persist(kp)
        return kp

    def add(self, kp: KeyPair) -> None:
        if kp.public not in self._keys:
            self._persist(kp)
        self._keys[kp.public] = kp

    def key_pair(self, key: PublicKey) -> KeyPair:
        kp = self._keys.get(key)
        if kp is None:
            raise ValueError(f"No private key known for {key.to_string_short()}")
        return kp

    def sign(self, content: bytes, key: PublicKey) -> DigitalSignatureWithKey:
        return Crypto.sign_with_key(self.key_pair(key), content)


class NetworkMapCache:
    """name → NodeInfo directory (InMemoryNetworkMapCache analog; fed by the
    network-map service or statically by MockNetwork)."""

    def __init__(self):
        self._nodes: dict[str, NodeInfo] = {}
        self._observers: list = []    # cb(("added"|"removed", NodeInfo))

    def add_node(self, info: NodeInfo) -> None:
        self._nodes[str(info.legal_identity.name)] = info
        self._emit(("added", info))

    def remove_node(self, name: str) -> None:
        info = self._nodes.pop(name, None)
        if info is not None:
            self._emit(("removed", info))

    def add_change_observer(self, cb) -> None:
        """networkMapFeed's MapChange stream (NetworkMapCache.kt:1-134)."""
        self._observers.append(cb)

    def _emit(self, change) -> None:
        for cb in list(self._observers):
            try:
                cb(change)
            except Exception:
                pass

    def get_node_by_legal_name(self, name: str) -> NodeInfo | None:
        return self._nodes.get(str(name))

    def party_from_name(self, name: str) -> Party | None:
        info = self._nodes.get(str(name))
        return info.legal_identity if info else None

    def notary_nodes(self) -> list[NodeInfo]:
        return [n for n in self._nodes.values()
                if any(s.type.startswith("corda.notary") for s in n.advertised_services)]

    def all_nodes(self) -> list[NodeInfo]:
        return list(self._nodes.values())


class ServiceHub:
    """The hub handed to flows (`flow.service_hub`) and services."""

    def __init__(self, my_info: NodeInfo, network_service,
                 key_pairs=(), verifier_service=None, device=DEFAULT_DEVICE):
        from ..observability import get_profiler, get_tracer
        from ..utils.metrics import MetricRegistry
        # the device this node's own device work runs on (flows' SIMM
        # margins, the rates oracle's bulk tear-off check): "cuda" unless the
        # caller asks for the CPU; raises without CUDA. The verifier service
        # carries its own device.
        self.device = resolve_device(device)
        self.my_info = my_info
        self.network_service = network_service
        # the node-wide metric registry (MonitoringService.kt:11 parity);
        # the verifier service and SMM publish into it, /metrics exports it
        self.monitoring = MetricRegistry()
        # span-ring accounting: how many spans the bounded ring has evicted
        # (a scraper seeing this grow knows /traces is lossy right now) and
        # how many it holds. Read through get_tracer per call so
        # enable/disable_tracing swaps take effect; the no-op tracer has no
        # ring → both read 0.
        self.monitoring.gauge(
            "Tracing.SpansDropped",
            lambda: getattr(getattr(get_tracer(), "ring", None),
                            "dropped", 0) or 0)
        self.monitoring.gauge(
            "Tracing.SpansBuffered",
            lambda: len(getattr(get_tracer(), "ring", None) or ()))
        # resource accounting plane (soak observatory): the span ring and
        # its cumulative drop counter register size probes with the
        # process-global registry, so any sampler (harness soak observer,
        # an operator scraping /debug/soak) gets their leak verdicts and
        # the windowed drop RATE for free. Registration is by-name
        # idempotent — a fleet of hubs in one process re-registers the
        # same process-wide structures harmlessly.
        from ..observability.resprof import get_resources, process_rss_bytes
        _resources = get_resources()
        _resources.register(
            "Tracing.SpanRing",
            lambda: len(getattr(get_tracer(), "ring", None) or ()),
            kind="bounded")
        _resources.register(
            "Tracing.SpansDropped",
            lambda: getattr(getattr(get_tracer(), "ring", None),
                            "dropped", 0) or 0,
            kind="grows", rate=True)
        _resources.register("Process.RSSBytes", process_rss_bytes,
                            kind="grows")
        # kernel flight recorder (observability/profiling): compile/
        # occupancy/overlap gauges + the shared dispatch histograms
        get_profiler().publish(self.monitoring)
        # set by NotaryService.__init__ on notary nodes; the readiness
        # probe checks its commit-log backend
        self.notary_service = None
        # optional observability/slo.SLOTracker — /readyz surfaces its
        # burn-rate alerts as degraded.slo (set by the ledger harness or
        # an operator wiring SLOs onto a node)
        self.slo_tracker = None
        from .audit import InMemoryAuditService
        self.audit = InMemoryAuditService()
        self.storage = TransactionStorage()
        self.key_management = KeyManagementService(key_pairs)
        self.identity_service = InMemoryIdentityService([my_info.legal_identity])
        self.attachments = InMemoryAttachmentStorage()
        self.network_map_cache = NetworkMapCache()
        self.network_map_cache.add_node(my_info)
        self.verifier_service = verifier_service
        self.smm = None  # set by the node after SMM construction
        from .vault import NodeVaultService
        self.vault = NodeVaultService(self)
        # typed projections of vault states into custom schema tables
        # (NodeSchemaService + HibernateObserver role; node/schemas.py)
        from .schemas import SchemaService
        self.schema_service = SchemaService(self).start()

    # -- identity / directory -----------------------------------------------
    def well_known_party(self, name) -> Party | None:
        return self.network_map_cache.party_from_name(name)

    # -- state resolution (WireTransaction.toLedgerTransaction seam) ---------
    def load_state(self, ref):
        stx = self.storage.get_transaction(ref.txhash)
        if stx is None:
            return None
        wtx = stx.tx if hasattr(stx, "tx") else stx
        if ref.index >= len(wtx.outputs):
            return None
        return wtx.outputs[ref.index]

    # -- verification (the TransactionVerifierService seam) ------------------
    def verify_transaction(self, stx,
                           check_sufficient_signatures: bool = True) -> None:
        """BLOCKING verify through the node's configured
        TransactionVerifierService (Services.kt:544-550) — for callers that
        may block their thread (RPC handlers, tests, tools). Flows do NOT
        call this: they `yield flows.api.Verify(stx)` and the SMM parks them
        on the service future (the reference's fiber suspension,
        FlowStateMachineImpl.kt:379-393), which is what lets Tpu/OutOfProcess
        backends batch across concurrently-suspended flows."""
        svc = self.verifier_service
        # ONLY services whose futures resolve OFF the node thread may be
        # blocked on here: e.g. the OutOfProcess service's responses arrive
        # on the node's SerialExecutor — a caller ON that executor blocking
        # for them would deadlock. (The flow path has no such restriction:
        # Verify parks instead of blocking.)
        if svc is not None and hasattr(svc, "verify_signed") and \
                getattr(svc, "resolves_off_node_thread", False):
            svc.verify_signed(
                stx, self,
                check_sufficient_signatures=check_sufficient_signatures
            ).result()
            return
        stx.verify(self, check_sufficient_signatures=check_sufficient_signatures)

    # -- ledger recording (ServiceHub.recordTransactions) --------------------
    def record_transactions(self, *stxs) -> None:
        import time as _time

        from ..observability import get_tracer
        # vault updates land before ledger-commit waiters wake, so a resumed
        # flow observes a consistent vault (HibernateObserver ordering analog)
        fresh = [stx for stx in stxs
                 if self.storage.add_transaction(stx, notify=False)]
        if fresh:
            smm = getattr(self, "smm", None)
            fsm = smm.current_fsm if smm is not None else None
            ctx = getattr(fsm, "trace_ctx", None)
            # vault.update: the last commit-path stage — consumed/produced
            # bookkeeping plus observer fan-out, under the recording flow's
            # trace so /traces shows flow.run → ... → vault.update whole
            with get_tracer().span("vault.update", parent=ctx,
                                   n_txs=len(fresh)) as sp:
                t0 = _time.perf_counter()
                try:
                    self.vault.notify_all(fresh)
                    for stx in fresh:
                        self.storage.notify_listeners(stx)
                finally:
                    trace_id = getattr(sp.context() or ctx, "trace_id", None)
                    self.monitoring.histogram("vault_update_seconds").update(
                        _time.perf_counter() - t0, trace_id=trace_id)
            # flow → transaction mapping for the RPC mapping feed
            # (StateMachineRecordedTransactionMapping)
            if smm is not None and fsm is not None:
                for stx in fresh:
                    smm.record_tx_mapping(fsm.run_id, stx.id)

    # -- signing -------------------------------------------------------------
    def sign(self, content: bytes, key: PublicKey | None = None
             ) -> DigitalSignatureWithKey:
        key = key or self.my_info.legal_identity.owning_key
        return self.key_management.sign(content, key)

    def sign_initial_transaction(self, wtx, key: PublicKey | None = None):
        from ..core.transactions.signed import SignedTransaction
        key = key or self.my_info.legal_identity.owning_key
        return SignedTransaction.of(wtx, [self.sign(wtx.id.bytes, key)])
