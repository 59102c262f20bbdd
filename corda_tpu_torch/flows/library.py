"""Library flows: notarisation, finality, broadcast, resolution, signing.

Reference parity (core/src/main/kotlin/net/corda/core/flows/):
- NotaryFlow.Client/Service (NotaryFlow.kt:31-120)
- FinalityFlow (FinalityFlow.kt:36,86-98): notarise → record → broadcast
- BroadcastTransactionFlow + NotifyTransactionHandler (CoreFlowHandlers.kt)
- FetchTransactionsFlow / FetchDataFlow (hash-addressed download + check)
- ResolveTransactionsFlow (dependency-graph walk, topological order, 5000-tx
  cap — ResolveTransactionsFlow.kt:31,40,98,134)
- CollectSignaturesFlow / SignTransactionFlow (CollectSignaturesFlow.kt:1-258)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..core.crypto.signatures import DigitalSignatureWithKey
from ..core.serialization import register_type
from ..core.transactions.signed import SignedTransaction
from .api import (AwaitFuture, FlowException, FlowLogic, Receive, Send,
                  SendAndReceive, Verify, VerifyMany, initiating_flow)

MAX_RESOLVE_TRANSACTIONS = 5000  # ResolveTransactionsFlow.kt partial-tx cap


# ---------------------------------------------------------------------------
# Wire payloads
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NotarisationRequest:
    stx: Any                  # SignedTransaction (validating) or filtered form


@dataclass(frozen=True)
class FetchTransactionsRequest:
    tx_ids: tuple             # SecureHash...


@dataclass(frozen=True)
class FetchAttachmentsRequest:
    att_ids: tuple           # SecureHash...


@dataclass(frozen=True)
class NotifyTxRequest:
    stx: Any


@dataclass(frozen=True)
class SignTransactionRequest:
    stx: Any


for _cls in (NotarisationRequest, FetchTransactionsRequest,
             FetchAttachmentsRequest, NotifyTxRequest, SignTransactionRequest):
    register_type(f"flows.{_cls.__name__}", _cls)


class NotaryException(FlowException):
    """Conflict or rejection from the notary (NotaryException.Conflict)."""


# ---------------------------------------------------------------------------
# Notarisation
# ---------------------------------------------------------------------------

@initiating_flow
class NotaryFlow(FlowLogic):
    """Client side (NotaryFlow.Client, NotaryFlow.kt:31-44): request a notary
    signature over the transaction; raises NotaryException on conflict."""

    def __init__(self, stx: SignedTransaction):
        self.stx = stx

    def call(self):
        notary = self.stx.notary
        if notary is None:
            raise FlowException("Transaction has no notary set")
        try:
            resp = yield SendAndReceive(notary, NotarisationRequest(self.stx),
                                        DigitalSignatureWithKey)
        except FlowException as e:
            raise NotaryException(str(e)) from e

        def validate(sig):
            if not isinstance(sig, DigitalSignatureWithKey):
                raise FlowException(f"Notary returned {type(sig).__name__}")
            if not notary.owning_key.is_fulfilled_by(sig.by):
                raise FlowException("Notary signature by an unexpected key")
            sig.verify(self.stx.id.bytes)
            return sig

        return [resp.unwrap(validate)]


class NotaryServiceFlow(FlowLogic):
    """Service side (NotaryFlow.Service, NotaryFlow.kt:95-120), instantiated
    per request by the notary node's installed NotaryService. Validating
    services fully verify first (ValidatingNotaryFlow); both check the time
    window and commit input uniqueness before signing."""

    def __init__(self, peer, service):
        self.peer = peer
        self.notary_service = service

    @property
    def service(self):
        """The notary service that started this flow: the node's own, so a
        checkpoint leaves it out (the codec writes no live service) and a
        flow restored from one finds it on its hub."""
        svc = self.__dict__.get("notary_service")
        return svc if svc is not None else self.service_hub.notary_service

    def call(self):
        req = yield Receive(self.peer, NotarisationRequest)
        stx = req.unwrap(lambda r: r.stx if isinstance(r, NotarisationRequest)
                         else _reject("Expected a NotarisationRequest"))
        if self.service.validating:
            # resolve dependencies from the requester, then fully verify
            yield from self.sub_flow(ResolveTransactionsFlow(
                self.peer, stx=stx))
            yield Verify(stx, check_sufficient_signatures=False)
        if not self.service.time_window_checker.is_valid(stx.tx.time_window):
            raise FlowException("Transaction time-window is outside tolerance")
        try:
            if getattr(self.service, "supports_async_commit", False):
                # group-commit path: park the flow on the GroupCommitter's
                # future instead of blocking the notary node thread for a
                # full consensus round — concurrently suspended requests
                # coalesce into one put_all_batch raft append
                trace_ctx = getattr(self.state_machine, "trace_ctx", None)
                yield AwaitFuture(lambda: self.service.commit_async(
                    stx.inputs, stx.id, str(self.peer.name),
                    trace_ctx=trace_ctx), purpose="notary.commit")
            elif getattr(self.service, "supports_trace_ctx", False):
                self.service.commit(
                    stx.inputs, stx.id, str(self.peer.name),
                    trace_ctx=getattr(self.state_machine, "trace_ctx", None))
            else:
                self.service.commit(stx.inputs, stx.id, str(self.peer.name))
        except Exception as e:
            raise FlowException(str(e)) from e
        sig = self.service.sign_tx_id(stx.id)
        yield Send(self.peer, sig)
        return None


def _reject(msg: str):
    raise FlowException(msg)


# ---------------------------------------------------------------------------
# Fetch / resolve
# ---------------------------------------------------------------------------

@initiating_flow
class FetchTransactionsFlow(FlowLogic):
    """Download transactions by id from a peer, verifying each returned blob
    hashes to its requested id (FetchDataFlow's maybeCheckHash)."""

    def __init__(self, peer, tx_ids):
        self.peer = peer
        self.tx_ids = tuple(tx_ids)

    def call(self):
        from_disk, to_fetch = [], []
        for tx_id in self.tx_ids:
            stx = self.service_hub.storage.get_transaction(tx_id)
            (from_disk if stx is not None else to_fetch).append(stx or tx_id)
        if not to_fetch:
            return from_disk
        resp = yield SendAndReceive(self.peer,
                                    FetchTransactionsRequest(tuple(to_fetch)),
                                    list)

        def validate(stxs):
            if len(stxs) != len(to_fetch):
                raise FlowException("Peer returned wrong number of transactions")
            for tx_id, stx in zip(to_fetch, stxs):
                if not isinstance(stx, SignedTransaction) or stx.id != tx_id:
                    raise FlowException(
                        f"Peer returned a transaction that hashes to {stx.id} "
                        f"instead of the requested {tx_id}")
            return list(stxs)

        return from_disk + resp.unwrap(validate)


class FetchTransactionsHandler(FlowLogic):
    """Serves FetchTransactionsFlow requests from local storage — installed on
    every node (installCoreFlows, AbstractNode.kt:285)."""

    def __init__(self, peer):
        self.peer = peer

    def call(self):
        req = yield Receive(self.peer, FetchTransactionsRequest)
        tx_ids = req.unwrap(lambda r: r.tx_ids)
        out = []
        for tx_id in tx_ids:
            stx = self.service_hub.storage.get_transaction(tx_id)
            if stx is None:
                raise FlowException(f"Transaction {tx_id} not found")
            out.append(stx)
        yield Send(self.peer, out)
        return None


@initiating_flow
class FetchAttachmentsFlow(FlowLogic):
    """Download attachments by hash from a peer, verifying content hashes
    (FetchAttachmentsFlow: the hash IS the id, so tampering is detectable)."""

    def __init__(self, peer, att_ids):
        self.peer = peer
        self.att_ids = tuple(att_ids)

    def call(self):
        hub = self.service_hub
        to_fetch = [a for a in self.att_ids if not hub.attachments.has_attachment(a)]
        if to_fetch:
            resp = yield SendAndReceive(
                self.peer, FetchAttachmentsRequest(tuple(to_fetch)), list)

            def validate(blobs):
                if len(blobs) != len(to_fetch):
                    raise FlowException("Peer returned wrong attachment count")
                from ..core.crypto.secure_hash import SecureHash
                for att_id, blob in zip(to_fetch, blobs):
                    if SecureHash.sha256(blob) != att_id:
                        raise FlowException(
                            f"Attachment content does not hash to {att_id}")
                return blobs

            for blob in resp.unwrap(validate):
                hub.attachments.import_attachment(blob)
        return [hub.attachments.open_attachment(a) for a in self.att_ids]


class FetchAttachmentsHandler(FlowLogic):
    def __init__(self, peer):
        self.peer = peer

    def call(self):
        req = yield Receive(self.peer, FetchAttachmentsRequest)
        att_ids = req.unwrap(lambda r: r.att_ids)
        hub = self.service_hub
        blobs = []
        for att_id in att_ids:
            att = hub.attachments.open_attachment(att_id)
            if att is None:
                raise FlowException(f"Attachment {att_id} not found")
            blobs.append(att.data)
        yield Send(self.peer, blobs)
        return None


FETCH_PAGE = 500  # tx ids per FetchTransactionsFlow request within a wave


@initiating_flow
class ResolveTransactionsFlow(FlowLogic):
    """Wave-based dependency download + verify+record
    (ResolveTransactionsFlow.kt:31-134, vectorized): instead of walking the
    graph link-by-link, each round fetches the ENTIRE unseen frontier as
    one batched request (paged at FETCH_PAGE ids), so a depth-D chain costs
    D round trips, not D×(chain width). Verification then runs in
    topological WAVES — every member of a wave has its dependencies already
    recorded, so the whole wave is submitted to the verifier service at
    once (VerifyMany) and its signatures coalesce into shared device
    batches. Hard cap of 5000 transactions per walk."""

    def __init__(self, peer, tx_ids=None, stx: SignedTransaction | None = None):
        self.peer = peer
        self.tx_ids = tuple(tx_ids) if tx_ids else ()
        self.stx = stx

    def call(self):
        hub = self.service_hub
        frontier = list(self.tx_ids)
        if self.stx is not None:
            frontier.extend(ref.txhash for ref in self.stx.inputs)
        fetched: dict = {}
        seen = set(frontier)
        queue = [tx_id for tx_id in frontier
                 if hub.storage.get_transaction(tx_id) is None]
        while queue:
            if len(fetched) + len(queue) > MAX_RESOLVE_TRANSACTIONS:
                raise FlowException(
                    f"Transaction resolution exceeds the {MAX_RESOLVE_TRANSACTIONS} limit")
            # one wave = the whole current frontier; page only to bound the
            # size of a single wire message
            wave, queue = queue, []
            stxs = []
            for i in range(0, len(wave), FETCH_PAGE):
                page = yield from self.sub_flow(
                    FetchTransactionsFlow(self.peer, wave[i:i + FETCH_PAGE]))
                stxs.extend(page)
            for stx in stxs:
                fetched[stx.id] = stx
                for ref in stx.inputs:
                    dep = ref.txhash
                    if dep not in seen:
                        seen.add(dep)
                        if hub.storage.get_transaction(dep) is None:
                            queue.append(dep)
        # attachments referenced anywhere in the resolved set must be local
        # before verification can open them (FetchAttachmentsFlow leg of
        # ResolveTransactionsFlow.kt)
        att_ids = {a for stx in fetched.values() for a in stx.tx.attachments}
        if self.stx is not None:
            att_ids |= set(self.stx.tx.attachments)
        missing = [a for a in att_ids if not hub.attachments.has_attachment(a)]
        if missing:
            yield from self.sub_flow(FetchAttachmentsFlow(self.peer, missing))
        # verify in topological waves: all of wave N's dependencies were
        # recorded by waves < N, and within a wave the transactions are
        # independent — so the whole wave verifies concurrently
        ordered = []
        for wave in _topological_waves(fetched):
            yield VerifyMany(tuple(wave), check_sufficient_signatures=False)
            for stx in wave:
                hub.record_transactions(stx)
                ordered.append(stx)
        return [stx.id for stx in ordered]


def _topological_waves(txs: dict) -> list:
    """Kahn's algorithm by levels: wave k = every tx whose dependencies all
    live in waves < k (dependency-free members first). Flattening the waves
    yields a valid topological order."""
    pending = dict(txs)
    waves = []
    while pending:
        wave = [stx for tx_id, stx in pending.items()
                if all(ref.txhash not in pending for ref in stx.inputs)]
        if not wave:
            raise FlowException("Transaction dependency cycle detected")
        for stx in wave:
            del pending[stx.id]
        waves.append(wave)
    return waves


def _topological_order(txs: dict) -> list:
    """Dependencies-first flat order (kept for callers/tests that assert on
    the order directly)."""
    return [stx for wave in _topological_waves(txs) for stx in wave]


# ---------------------------------------------------------------------------
# Broadcast / finality
# ---------------------------------------------------------------------------

@initiating_flow
class BroadcastTransactionFlow(FlowLogic):
    """Send a finalised transaction to each participant
    (BroadcastTransactionFlow → NotifyTransactionHandler)."""

    def __init__(self, stx: SignedTransaction, participants):
        self.stx = stx
        self.participants = tuple(participants)

    def call(self):
        me = str(self.service_hub.my_info.legal_identity.name)
        sent = {me}
        undelivered = []
        for party in self.participants:
            if str(party.name) in sent:
                continue
            sent.add(str(party.name))
            # ACKNOWLEDGED delivery: the reference rides durable broker
            # queues, so a recipient that is down still gets the broadcast
            # on recovery; the TCP plane has no such durability, so the
            # sender waits until the recipient has RECORDED the transaction
            # — a finalised payment can no longer vanish with a crashed
            # recipient's in-flight frame. A failed recipient must not
            # starve the REMAINING recipients (the transaction is already
            # final): every delivery is attempted, then the undelivered
            # set surfaces as one error.
            try:
                resp = yield SendAndReceive(party, NotifyTxRequest(self.stx),
                                            bytes)
                resp.unwrap(lambda ack: ack)
            except FlowException as e:
                undelivered.append((party, str(e)))
        if undelivered:
            detail = "; ".join(f"{p.name}: {reason}"
                               for p, reason in undelivered)
            raise FlowException(
                f"transaction {self.stx.id.prefix_chars()} is FINAL but "
                f"could not be delivered to: {detail}")
        return None


class NotifyTransactionHandler(FlowLogic):
    """Receives a broadcast transaction: resolve deps from the sender, verify,
    record, acknowledge (CoreFlowHandlers.kt NotifyTransactionHandler)."""

    def __init__(self, peer):
        self.peer = peer

    def call(self):
        req = yield Receive(self.peer, NotifyTxRequest)
        stx = req.unwrap(lambda r: r.stx)
        yield from self.sub_flow(ResolveTransactionsFlow(self.peer, stx=stx))
        yield Verify(stx, check_sufficient_signatures=False)
        self.service_hub.record_transactions(stx)
        yield Send(self.peer, b"ack")
        return None


@initiating_flow
class FinalityFlow(FlowLogic):
    """Notarise (if needed), record locally, broadcast to participants
    (FinalityFlow.kt:36,86-98)."""

    def __init__(self, stx: SignedTransaction, extra_recipients=()):
        self.stx = stx
        self.extra_recipients = tuple(extra_recipients)

    def call(self):
        import time as _time
        hub = self.service_hub
        stx = self.stx
        needs_notary = stx.notary is not None and (
            len(stx.inputs) > 0 or stx.tx.time_window is not None)
        if needs_notary:
            # client-observed notarisation round trip (request → notary
            # uniqueness/raft commit → signature back) — the commit path's
            # dominant wait, so it gets its own node histogram alongside
            # the notary-side notary_uniqueness_seconds stage
            t0 = _time.perf_counter()
            notary_sigs = yield from self.sub_flow(NotaryFlow(stx))
            stx = stx.plus(*notary_sigs)
            monitoring = getattr(hub, "monitoring", None)
            if monitoring is not None:
                sm = getattr(self, "state_machine", None)
                ctx = getattr(sm, "trace_ctx", None)
                monitoring.histogram("notarise_seconds").update(
                    _time.perf_counter() - t0,
                    trace_id=getattr(ctx, "trace_id", None))
        hub.record_transactions(stx)
        participants = self._participant_parties(stx)
        yield from self.sub_flow(
            BroadcastTransactionFlow(stx, participants + list(self.extra_recipients)))
        return stx

    def _participant_parties(self, stx):
        hub = self.service_hub
        parties = []
        seen = set()
        for out in stx.tx.outputs:
            for key in getattr(out.data, "participants", []):
                owning = getattr(key, "owning_key", key)
                party = hub.identity_service.party_from_key(owning) \
                    if hasattr(hub.identity_service, "party_from_key") else None
                if party is None:
                    party = _party_by_key(hub, owning)
                if party is not None and party.owning_key not in seen:
                    seen.add(party.owning_key)
                    parties.append(party)
        return parties


@initiating_flow
class ManualFinalityFlow(FinalityFlow):
    """FinalityFlow that broadcasts ONLY to the explicitly named recipients —
    no participant derivation (core ManualFinalityFlow: used when states'
    participants cannot be resolved to well-known parties, e.g. anonymous
    or externally-held keys)."""

    def __init__(self, stx: SignedTransaction, recipients):
        super().__init__(stx, extra_recipients=recipients)

    def _participant_parties(self, stx):
        return []


def _party_by_key(hub, key):
    for info in hub.network_map_cache.all_nodes():
        if info.legal_identity.owning_key == key:
            return info.legal_identity
    return None


# ---------------------------------------------------------------------------
# Signature collection
# ---------------------------------------------------------------------------

@initiating_flow
class CollectSignaturesFlow(FlowLogic):
    """Collect signatures from every required signer other than ourselves and
    the notary (CollectSignaturesFlow.kt:1-258)."""

    def __init__(self, stx: SignedTransaction):
        self.stx = stx

    def call(self):
        hub = self.service_hub
        our_keys = hub.key_management.keys
        notary_key = stx_notary_key = None
        if self.stx.notary is not None:
            notary_key = self.stx.notary.owning_key
        stx = self.stx
        for key in stx.tx.must_sign:
            if key == notary_key or any(k in our_keys for k in key.keys):
                continue
            # a signature already attached (e.g. an oracle's tear-off
            # signature collected before this flow) is not re-requested
            if key.is_fulfilled_by({s.by for s in stx.sigs}):
                continue
            party = _party_by_key(hub, key)
            if party is None:
                raise FlowException(
                    f"No well-known party found for signer {key.to_string_short()}")
            resp = yield SendAndReceive(party, SignTransactionRequest(stx),
                                        DigitalSignatureWithKey)

            def validate(sig, _key=key):
                sig.verify(stx.id.bytes)
                if not _key.is_fulfilled_by({sig.by}):
                    raise FlowException("Signature from an unexpected key")
                return sig

            stx = stx.plus(resp.unwrap(validate))
        return stx


def install_core_flows(smm) -> None:
    """Register the always-on service handlers every node must serve
    (AbstractNode.installCoreFlows, AbstractNode.kt:285)."""
    from .api import flow_name
    smm.register_flow_factory(flow_name(FetchTransactionsFlow),
                              FetchTransactionsHandler)
    smm.register_flow_factory(flow_name(FetchAttachmentsFlow),
                              FetchAttachmentsHandler)
    smm.register_flow_factory(flow_name(BroadcastTransactionFlow),
                              NotifyTransactionHandler)


class SignTransactionFlow(FlowLogic):
    """Counter-signer side (abstract in the reference; subclass and override
    `check_transaction` to add business validation)."""

    def __init__(self, peer):
        self.peer = peer

    def check_transaction(self, stx: SignedTransaction) -> None:
        """Override for business checks; raise FlowException to refuse."""

    def call(self):
        req = yield Receive(self.peer, SignTransactionRequest)
        stx = req.unwrap(lambda r: r.stx)
        # the initiator must already have signed it
        stx.check_signatures_are_valid()
        self.check_transaction(stx)
        hub = self.service_hub
        our_key = next((k for k in stx.tx.must_sign
                        for leaf in k.keys
                        if leaf in hub.key_management.keys), None)
        if our_key is None:
            raise FlowException("Transaction does not require our signature")
        leaf = next(k for k in our_key.keys if k in hub.key_management.keys)
        sig = hub.key_management.sign(stx.id.bytes, leaf)
        yield Send(self.peer, sig)
        return None
