"""FlowLogic API: generator-based flows, IO request types, registries.

Reference parity:
- `FlowLogic` surface: send (FlowLogic.kt:142), receive/sendAndReceive
  (:87-106), subFlow (:156-168), waitForLedgerCommit (:231), progressTracker
  (:203).
- `UntrustworthyData` receive wrapper (type-checked unwrap).
- `@InitiatingFlow` / `@InitiatedBy` / `@StartableByRPC` annotations and the
  initiated-flow registry (AbstractNode.registerInitiatedFlows :292-342).

A flow body is written as a generator:

    @initiating_flow
    class Ping(FlowLogic):
        def __init__(self, peer): self.peer = peer
        def call(self):
            answer = yield SendAndReceive(self.peer, b"ping", bytes)
            return answer.unwrap(lambda d: d)

`yield` suspends the flow (a checkpoint is written); the state machine
resumes it with the response. Sub-flows compose with `yield from`:

    result = yield from self.sub_flow(OtherFlow(...))
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Generator

from ..core.identity import Party


class FlowException(Exception):
    """Error that propagates across a session to the counterparty
    (reference FlowException — surfaces at the peer's receive)."""


class FlowTimeoutException(FlowException):
    """A Receive/SendAndReceive with ``timeout_s`` expired before the peer
    replied (thrown at the yield site; the session stays usable)."""


# ---------------------------------------------------------------------------
# IO request types (FlowIORequest.kt analog)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Send:
    party: Party
    payload: Any


@dataclass(frozen=True)
class Receive:
    party: Party
    expected_type: type = object
    #: optional deadline (seconds on the node's clock): on expiry a
    #: FlowTimeoutException is thrown at the yield site instead of parking
    #: forever (ClockUtils fiber-aware deadline parity)
    timeout_s: float | None = None


@dataclass(frozen=True)
class SendAndReceive:
    party: Party
    payload: Any
    expected_type: type = object
    timeout_s: float | None = None   # see Receive.timeout_s


@dataclass(frozen=True)
class WaitForLedgerCommit:
    tx_id: Any  # SecureHash


@dataclass(frozen=True)
class Sleep:
    """Suspend the flow for ``seconds`` on the NODE's clock without blocking
    the node thread (the reference's fiber-aware ClockUtils.awaitWithDeadline,
    ClockUtils.kt): a timer — or a test clock advance — resumes it. A sleep
    interrupted by a restart restarts in full on restore (the deadline is
    re-armed relative to the restored clock)."""

    seconds: float


@dataclass(frozen=True)
class Verify:
    """Suspend until the node's TransactionVerifierService resolves the
    verification of ``stx`` — the reference parks the flow fiber on the
    verifier future (FlowStateMachineImpl.kt:379-393 via Services.kt:544-550),
    so a Tpu- or OutOfProcess-backed node verifies OFF the node thread and
    concurrently-suspended flows' signatures coalesce into shared device
    batches. The flow resumes with None on success; a verification failure
    is thrown at the yield site with its original type (preserved across
    checkpoint replay via the typed error log entry)."""

    stx: Any
    check_sufficient_signatures: bool = True


@dataclass(frozen=True)
class VerifyMany:
    """Suspend until the verifier service resolves ALL of ``stxs`` — one
    yield site submits the whole wave, so N transactions' signatures land
    in the batcher concurrently instead of one service round-trip per
    link (the wave-based ResolveTransactionsFlow discipline). Resumes with
    None when every verification succeeds; the FIRST failure (submission
    order) is thrown at the yield site with its original type."""

    stxs: tuple
    check_sufficient_signatures: bool = True


@dataclass(frozen=True)
class AwaitFuture:
    """Suspend until the Future returned by ``producer()`` resolves — the
    generic park-on-a-future primitive (the reference parks fibers on
    ListenableFutures). ``producer`` runs on the node thread at the yield
    site; it must return a concurrent.futures.Future (or None, which
    resumes immediately with None). The flow resumes with the future's
    (checkpoint-serializable) result, or the future's exception is thrown
    at the yield site with its original type preserved across replay.

    On checkpoint replay the producer is RE-EXECUTED, so it must be
    idempotent — the group-commit path qualifies: re-submitting a
    committed transaction's refs is absorbed by find_conflicts' same-tx
    rule.

    ``purpose`` names what the flow is waiting FOR — it becomes the
    ``wait_kind`` tag on the park's wait-state span, so the critical-path
    extractor can attribute the parked time to a component instead of an
    anonymous future."""

    producer: Callable[[], Any]
    purpose: str = "future"


@dataclass(frozen=True)
class ExecuteOnce:
    """Run a local, possibly non-deterministic computation exactly once and
    checkpoint its (serializable) result: on replay the recorded value is
    returned instead of re-running the producer. Required for anything that
    reads mutable node state before a suspension — vault coin selection,
    fresh-key generation, clock reads (the replay-determinism contract,
    flows package docstring)."""

    producer: Callable[[], Any]


class UntrustworthyData:
    """Wrapper forcing explicit unwrap of peer-supplied data
    (core FlowLogic receive semantics)."""

    __slots__ = ("_data",)

    def __init__(self, data):
        self._data = data

    def unwrap(self, validator: Callable[[Any], Any]):
        return validator(self._data)

    def __repr__(self):
        return f"UntrustworthyData({type(self._data).__name__})"


# ---------------------------------------------------------------------------
# FlowLogic
# ---------------------------------------------------------------------------

class FlowLogic:
    """Base class for all flows. Subclasses implement `call()` as a generator
    (or a plain function for purely-local flows)."""

    # injected by the state machine before `call()` runs
    state_machine = None  # FlowStateMachine
    service_hub = None    # ServiceHub

    progress_tracker = None

    def call(self) -> Generator:
        raise NotImplementedError

    # -- composition ---------------------------------------------------------
    def sub_flow(self, flow: "FlowLogic") -> Generator:
        """Run a sub-flow inline on the same state machine
        (FlowLogic.kt:156-168). Use as `yield from self.sub_flow(f)`.

        An @initiating_flow sub-flow gets its own *session group*: sessions it
        opens are distinct from the parent's even toward the same party, and
        its SessionInits carry the sub-flow's class name so the peer picks the
        right handler — the reference's (FlowLogic, Party) session keying.
        The group id is a deterministic counter, so replay-based restore
        reconstructs identical keys."""
        flow.state_machine = self.state_machine
        flow.service_hub = self.service_hub
        gen = flow.call()
        if not hasattr(gen, "send"):  # non-generator call(): plain result
            return gen
        fsm = self.state_machine
        own_group = getattr(type(flow), "_initiating", False) and fsm is not None
        if own_group:
            fsm.session_group_counter += 1
            fsm.session_group_stack.append(
                (fsm.session_group_counter, flow_name(type(flow))))
        try:
            result = yield from gen
        finally:
            if own_group:
                fsm.session_group_stack.pop()
        return result

    # -- convenience wrappers (each is a single yield site) ------------------
    def send(self, party: Party, payload) -> Generator:
        yield Send(party, payload)

    def receive(self, party: Party, expected_type: type = object) -> Generator:
        data = yield Receive(party, expected_type)
        return data

    def send_and_receive(self, party: Party, payload,
                         expected_type: type = object) -> Generator:
        data = yield SendAndReceive(party, payload, expected_type)
        return data

    def send_and_receive_with_retry(self, party: Party, payload,
                                    expected_type: type = object,
                                    attempts: int = 3) -> Generator:
        """Retry the exchange on session failure — for IDEMPOTENT requests to
        clustered services whose members may fail over mid-request
        (FlowLogic.kt:106-113 sendAndReceiveWithRetry)."""
        last: Exception | None = None
        for _ in range(attempts):
            try:
                data = yield SendAndReceive(party, payload, expected_type)
                return data
            except FlowException as e:
                last = e
                # the failed session is dead; drop it (routing index included)
                # so the retry opens a FRESH one and a straggler reply on the
                # old session id can't be mistaken for the new attempt's
                fsm = self.state_machine
                if fsm is not None:
                    fsm.smm.discard_session(fsm, fsm.current_group[0],
                                            str(party.name))
        raise last if last is not None else FlowException("retry exhausted")

    def wait_for_ledger_commit(self, tx_id) -> Generator:
        stx = yield WaitForLedgerCommit(tx_id)
        return stx

    def record(self, producer: Callable[[], Any]) -> Generator:
        """`value = yield from self.record(fn)` — run fn once, checkpoint the
        result (see ExecuteOnce)."""
        value = yield ExecuteOnce(producer)
        return value

    @property
    def run_id(self):
        return self.state_machine.run_id if self.state_machine else None

    @property
    def our_identity(self) -> Party:
        return self.service_hub.my_info.legal_identity


# ---------------------------------------------------------------------------
# Annotations / registries
# ---------------------------------------------------------------------------

_INITIATED_BY: dict[str, Callable[[Party], FlowLogic]] = {}
_RPC_STARTABLE: dict[str, type] = {}


def flow_name(cls: type) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


def initiating_flow(cls: type) -> type:
    """@InitiatingFlow — marks a flow that opens sessions with new peers."""
    cls._initiating = True
    return cls


def InitiatingFlow(cls: type) -> type:  # reference-style alias
    return initiating_flow(cls)


def initiated_by(initiator_cls: type):
    """@InitiatedBy(Initiator) — registers a responder factory keyed by the
    initiator's flow name (AbstractNode.kt:292-342 registration)."""

    def decorate(cls: type) -> type:
        _INITIATED_BY[flow_name(initiator_cls)] = cls
        cls._initiated_by = initiator_cls
        return cls

    return decorate


def startable_by_rpc(cls: type) -> type:
    _RPC_STARTABLE[flow_name(cls)] = cls
    cls._startable_by_rpc = True
    return cls


def get_initiated_flow_factory(initiator_name: str):
    return _INITIATED_BY.get(initiator_name)


def rpc_startable_flows() -> dict[str, type]:
    return dict(_RPC_STARTABLE)


# ---------------------------------------------------------------------------
# Session handle used by the state machine
# ---------------------------------------------------------------------------

def _fresh_session_id() -> int:
    """Random 63-bit session id (reference random63BitValue — restart-safe,
    unlike a process-local counter)."""
    import secrets
    return secrets.randbits(63)


@dataclass
class FlowSession:
    """One side of a flow session (statemachine session state)."""

    peer: Party
    our_session_id: int = field(default_factory=_fresh_session_id)
    peer_session_id: int | None = None
    state: str = "initiating"  # initiating | open | ended | errored
    received: list = field(default_factory=list)  # queued inbound payloads
    error: Exception | None = None
    group: int = 0                                # sub-flow session group
    pending_out: list = field(default_factory=list)  # buffered pre-confirm sends
