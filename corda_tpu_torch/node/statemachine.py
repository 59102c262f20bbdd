"""Flow state machine manager: sessions, suspension, checkpoint-by-replay.

Reference parity (node/services/statemachine/):
- StateMachineManager.add/onSessionMessage/onSessionInit
  (StateMachineManager.kt:307-405, 504-524)
- session message set ported semantically verbatim from SessionMessage.kt:14-41
  (SessionInit/Confirm/Reject/Data/NormalSessionEnd/ErrorSessionEnd)
- restore-and-resume (StateMachineManager.kt:257-305) — here via deterministic
  replay of the checkpointed response log instead of Quasar deserialization
  (design rationale: the flows package docstring).

Execution model: flows run cooperatively on the caller's thread until they
block (the single-threaded AffinityExecutor discipline of the reference node,
AbstractNode serverThread — and exactly MockNetwork's deterministic pumping).
"""
from __future__ import annotations

import logging
import queue
import time as _time
import uuid
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any

from ..core.serialization import deserialize, register_type, serialize
from ..flows.api import (AwaitFuture, ExecuteOnce, FlowException, FlowLogic,
                         FlowSession, FlowTimeoutException, Receive, Send,
                         SendAndReceive, Sleep, UntrustworthyData, Verify,
                         VerifyMany, WaitForLedgerCommit, flow_name,
                         get_initiated_flow_factory)
from ..network.messaging import TOPIC_P2P, TopicSession
from ..observability import get_tracer, jlog
from ..utils.faults import DROP, fault_point
from .checkpoints import Checkpoint, CheckpointStorage, SessionSnapshot

_log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Session protocol wire messages (SessionMessage.kt:14-41)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SessionInit:
    initiator_session_id: int
    initiator_party: str
    flow_name: str
    first_payload: Any = None


@dataclass(frozen=True)
class SessionConfirm:
    initiator_session_id: int
    initiated_session_id: int


@dataclass(frozen=True)
class SessionReject:
    initiator_session_id: int
    error_message: str


@dataclass(frozen=True)
class SessionData:
    recipient_session_id: int
    payload: Any


@dataclass(frozen=True)
class NormalSessionEnd:
    recipient_session_id: int


@dataclass(frozen=True)
class ErrorSessionEnd:
    recipient_session_id: int
    error_message: str


for _cls in (SessionInit, SessionConfirm, SessionReject, SessionData,
             NormalSessionEnd, ErrorSessionEnd):
    register_type(f"session.{_cls.__name__}", _cls)


# ---------------------------------------------------------------------------
# Flow state machine
# ---------------------------------------------------------------------------

class FlowStateMachine:
    """One running flow (FlowStateMachineImpl analog, no fibers)."""

    def __init__(self, run_id: str, flow: FlowLogic, smm: "StateMachineManager"):
        self.run_id = run_id
        self.flow = flow
        self.smm = smm
        self.generator = None
        self.response_log: list = []     # entries: (kind, value)
        self.replay_queue: list = []     # prefix of response_log on restore
        # (session group, peer name) -> session; group 0 = the top-level flow,
        # each @initiating_flow sub-flow gets a deterministic fresh group
        # (FlowLogic.sub_flow) — the reference's (FlowLogic, Party) keying.
        self.sessions: dict[tuple[int, str], FlowSession] = {}
        self.session_group_stack: list = [(0, flow_name(type(flow)))]
        self.session_group_counter: int = 0
        self.parked_on = None            # pending Receive/SendAndReceive/Wait
        self.parked_group: int = 0       # session group active at park time
        self.result_future: Future = Future()
        self.done = False
        # observability: the flow's root span (opened in _register, closed in
        # _finalize); trace_ctx rides into verifier submits and P2P sends
        self.trace_span = None
        self.trace_ctx = None
        # wall-clock stamp of the current external park (Verify /
        # AwaitFuture) — the wait-state span's start once the flow resumes
        self.park_t0 = None

    @property
    def current_group(self) -> tuple[int, str]:
        return self.session_group_stack[-1]

    @property
    def replaying(self) -> bool:
        return bool(self.replay_queue)

    def __repr__(self):
        return f"FlowStateMachine({self.run_id[:8]}, {type(self.flow).__name__})"


class StateMachineManager:
    def __init__(self, service_hub, checkpoint_storage: CheckpointStorage | None = None):
        self.hub = service_hub
        self.checkpoints = checkpoint_storage if checkpoint_storage is not None \
            else CheckpointStorage()
        self.flows: dict[str, FlowStateMachine] = {}
        self._session_index: dict[int, tuple[FlowStateMachine, FlowSession]] = {}
        self._commit_waiters: dict[Any, list[FlowStateMachine]] = {}
        self.changes: list = []  # callbacks: (event, fsm) — RPC feed hook
        # Node-LOCAL initiated-flow factories (a notary's service flows live
        # only on the notary node); falls back to the global @initiated_by
        # registry — AbstractNode.registerInitiatedFlows / installCoreFlows.
        self.flow_factories: dict[str, Any] = {}
        # flow → recorded-transaction mapping (the reference's
        # stateMachineRecordedTransactionMappingFeed source): the hub calls
        # record_tx_mapping while current_fsm identifies the recording flow
        self.current_fsm: FlowStateMachine | None = None
        self.tx_mappings: list[tuple[str, Any]] = []   # (run_id, tx_id)
        self._mapping_observers: list = []
        # Async-completion seam (the Verify suspension point): completions
        # arriving on foreign threads (verifier pool, device batcher) are
        # queued here and executed on the node thread via drain_external().
        # scheduler_poke is installed by the runtime that owns the node
        # thread — the real Node posts drain_external to its SerialExecutor,
        # MockNetwork polls it from run_network().
        self._external: "queue.Queue" = queue.Queue()
        self._awaiting_external = 0
        self.scheduler_poke = None
        # Flow timers (Sleep + Receive timeouts — ClockUtils parity): the
        # clock is injectable (seconds; tests install a TestClock) and
        # timer_driver(delay_s, fire) is how a real-time runtime schedules
        # the wake (the Node wires a threading.Timer that re-enters via the
        # SerialExecutor); deterministic tests advance the clock and call
        # wake_timers() instead. MONOTONIC by default: deadlines are
        # relative, and a wall clock stepping backwards (NTP) would leave a
        # due timer unfired forever.
        self.clock = _time.monotonic
        self.timer_driver = None
        self._timers: list[tuple[float, str, Any]] = []  # (deadline, run_id, request)
        self._next_wake: float | None = None   # soonest scheduled driver wake

    @property
    def awaiting_external(self) -> int:
        """Flows parked on an off-node-thread future (e.g. Verify)."""
        return self._awaiting_external

    def _record_wait(self, fsm: FlowStateMachine, name: str, kind: str,
                     t0, **tags) -> None:
        """Retroactive wait-state span: the time a flow spent parked at a
        commit-path queue, recorded under the flow's root span once the
        wait resolves. ``wait_kind`` makes "time not doing work" first-
        class in the trace tree — observability/critpath.py attributes it
        to a blame component instead of leaving an unexplained gap."""
        if t0 is None or fsm.trace_ctx is None:
            return
        dur = _time.time() - t0
        if dur > 0.0:
            get_tracer().record(name, parent=fsm.trace_ctx, start_s=t0,
                                duration_s=dur, wait_kind=kind, **tags)

    def _post_external(self, fn) -> None:
        """Thread-safe: queue a completion for the node thread."""
        self._external.put(fn)
        poke = self.scheduler_poke
        if poke is not None:
            poke()

    def drain_external(self) -> bool:
        """Run queued async completions. MUST be called on the node thread
        (the real Node's poke hook guarantees it; MockNetwork.run_network
        polls from its single driving thread). Returns True if any ran."""
        ran = False
        while True:
            try:
                fn = self._external.get_nowait()
            except queue.Empty:
                return ran
            ran = True
            fn()

    def record_tx_mapping(self, run_id: str, tx_id) -> None:
        mapping = (run_id, tx_id)
        self.tx_mappings.append(mapping)
        for cb in list(self._mapping_observers):
            try:
                cb(mapping)
            except Exception:
                pass

    def add_mapping_observer(self, cb) -> None:
        self._mapping_observers.append(cb)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Register the P2P handler and restore checkpointed flows
        (StateMachineManager.kt:197-270)."""
        self._p2p_registration = self.hub.network_service.add_message_handler(
            TopicSession(TOPIC_P2P), self._on_message)
        if hasattr(self.hub, "storage"):
            self.hub.storage.add_commit_listener(self._on_tx_committed)
        for cp in self.checkpoints.get_all_checkpoints():
            self._restore(cp)

    def stop(self) -> None:
        """Detach from messaging (node shutdown; checkpoints remain for the
        next start — the restart path of the reference SMM)."""
        reg = getattr(self, "_p2p_registration", None)
        if reg is not None:
            self.hub.network_service.remove_message_handler(reg)
            self._p2p_registration = None

    def add(self, flow: FlowLogic) -> FlowStateMachine:
        """Start a new top-level flow (StateMachineManager.kt:504-524)."""
        fsm = FlowStateMachine(uuid.uuid4().hex, flow, self)
        self._register(fsm)
        self._notify("add", fsm)
        self._start_generator(fsm)
        self._advance(fsm, first=True)
        return fsm

    def _register(self, fsm: FlowStateMachine) -> None:
        # wall-clock anchor for the flow_run commit-path stage histogram
        # (observability/stages.LEDGER_STAGE_METRICS), closed in _finalize
        fsm.started_at = _time.perf_counter()
        monitoring = getattr(self.hub, "monitoring", None)
        if monitoring is not None:   # Flows.StartedPerSecond analog
            monitoring.meter("Flows.Started").mark()
            monitoring.counter("Flows.InFlight").inc()
        audit = getattr(self.hub, "audit", None)
        if audit is not None:
            from .audit import FlowStartEvent
            audit.record_audit_event(FlowStartEvent(
                description="flow started",
                flow_type=flow_name(type(fsm.flow)), flow_id=fsm.run_id))
        tracer = get_tracer()
        if tracer.enabled and fsm.trace_span is None:
            fsm.trace_span = tracer.span(
                "flow.run", parent=fsm.trace_ctx,
                flow_type=flow_name(type(fsm.flow)), flow_id=fsm.run_id)
            fsm.trace_ctx = fsm.trace_span.context()
        jlog(_log, "flow.start", ctx=fsm.trace_ctx,
             flow_type=flow_name(type(fsm.flow)), flow_id=fsm.run_id)
        self.flows[fsm.run_id] = fsm
        fsm.flow.state_machine = fsm
        fsm.flow.service_hub = self.hub

    def _start_generator(self, fsm: FlowStateMachine) -> None:
        gen = fsm.flow.call()
        if not hasattr(gen, "send"):
            # plain function: completed synchronously with its return value
            fsm.generator = None
            self._complete(fsm, gen)
            return
        fsm.generator = gen

    def _notify(self, event: str, fsm: FlowStateMachine) -> None:
        for cb in list(self.changes):
            cb(event, fsm)

    # -- the drive loop ------------------------------------------------------
    def _advance(self, fsm: FlowStateMachine, first: bool = False,
                 resume_value: Any = None, resume_error: Exception | None = None
                 ) -> None:
        """Run the generator until it parks or finishes. Each iteration feeds
        the previous response and receives the next FlowIORequest."""
        previous = self.current_fsm
        self.current_fsm = fsm   # attribute hub.record_transactions to us
        try:
            self._advance_inner(fsm, first, resume_value, resume_error)
        finally:
            self.current_fsm = previous

    def _advance_inner(self, fsm: FlowStateMachine, first: bool = False,
                       resume_value: Any = None,
                       resume_error: Exception | None = None) -> None:
        if fsm.generator is None or fsm.done:
            return
        gen = fsm.generator
        try:
            if first:
                request = next(gen)
            elif resume_error is not None:
                request = gen.throw(resume_error)
            else:
                request = gen.send(resume_value)
        except StopIteration as stop:
            self._complete(fsm, stop.value)
            return
        except Exception as e:
            self._fail(fsm, e)
            return

        while True:
            try:
                if fsm.replaying:
                    action = self._replay_step(fsm, request)
                elif getattr(fsm, "restoring", False):
                    # First live request after replay = the request the flow was
                    # parked on when checkpointed. Its send side already ran
                    # before the restart — only re-arm the wait side.
                    fsm.restoring = False
                    action = self._reexecute_parked(fsm, request)
                else:
                    action = self._execute_request(fsm, request)
            except FlowException as e:
                # session-state errors surface AT THE CALL SITE so flow code
                # (e.g. sendAndReceiveWithRetry) can catch and recover —
                # reference FlowLogic semantics
                fsm.response_log.append(("error", str(e)))
                try:
                    request = gen.throw(e)
                    continue
                except StopIteration as stop:
                    self._complete(fsm, stop.value)
                    return
                except Exception as e2:
                    self._fail(fsm, e2)
                    return
            except Exception as e:
                self._fail(fsm, e)
                return
            if action is _PARK:
                fsm.parked_on = request
                fsm.parked_group = fsm.current_group[0]
                self._arm_timer(fsm, request)
                self._checkpoint(fsm)
                return
            kind, value, error = action
            try:
                if error is not None:
                    request = gen.throw(error)
                else:
                    request = gen.send(value)
            except StopIteration as stop:
                self._complete(fsm, stop.value)
                return
            except Exception as e:
                self._fail(fsm, e)
                return

    def _resume(self, fsm: FlowStateMachine, value: Any = None,
                error: Exception | None = None) -> None:
        if self._timers:
            # any timer armed for the park being resumed is dead: pruning
            # here (a) stops a re-yielded identical request object from
            # inheriting the previous park's deadline and (b) keeps the
            # timer list from accumulating already-resumed flows' entries
            self._timers = [t for t in self._timers if t[1] != fsm.run_id]
        fsm.parked_on = None
        self._advance(fsm, resume_value=value, resume_error=error)

    # -- request execution ---------------------------------------------------
    def _execute_request(self, fsm: FlowStateMachine, request):
        if isinstance(request, Send):
            self._do_send(fsm, request.party, request.payload)
            return self._log(fsm, ("send", None))
        if isinstance(request, SendAndReceive):
            self._do_send(fsm, request.party, request.payload)
            return self._try_receive(fsm, request.party)
        if isinstance(request, Receive):
            self._ensure_session(fsm, request.party, first_payload=None)
            return self._try_receive(fsm, request.party)
        if isinstance(request, WaitForLedgerCommit):
            stx = self.hub.storage.get_transaction(request.tx_id)
            if stx is not None:
                return self._log(fsm, ("commit", request.tx_id))
            self._commit_waiters.setdefault(request.tx_id, []).append(fsm)
            return _PARK
        if isinstance(request, ExecuteOnce):
            return self._log(fsm, ("value", request.producer()))
        if isinstance(request, Verify):
            return self._do_verify(fsm, request)
        if isinstance(request, VerifyMany):
            return self._do_verify_many(fsm, request)
        if isinstance(request, AwaitFuture):
            return self._do_await_future(fsm, request)
        if isinstance(request, Sleep):
            return _PARK        # woken only by its timer (see _arm_timer)
        raise TypeError(f"Flow yielded a non-request value: {request!r}")

    # -- flow timers (Sleep / receive timeouts, ClockUtils parity) -----------
    def _arm_timer(self, fsm: FlowStateMachine, request) -> None:
        if isinstance(request, Sleep):
            delay = max(0.0, float(request.seconds))
        elif isinstance(request, (Receive, SendAndReceive)) and \
                getattr(request, "timeout_s", None) is not None:
            delay = max(0.0, float(request.timeout_s))
        else:
            return
        deadline = self.clock() + delay
        self._timers.append((deadline, fsm.run_id, request))
        self._request_wake(deadline)

    def _request_wake(self, deadline: float) -> None:
        """Schedule ONE driver wake for the soonest deadline (not one OS
        timer per armed request — N concurrent timeouts would mean N live
        threads under Node's threading.Timer driver)."""
        if self.timer_driver is None:
            return
        if self._next_wake is not None and self._next_wake <= deadline:
            return
        self._next_wake = deadline
        self.timer_driver(max(0.0, deadline - self.clock()),
                          self._on_timer_wake)

    def _on_timer_wake(self) -> None:
        self._next_wake = None
        self.wake_timers()
        nxt = self.next_timer_deadline()
        if nxt is not None:
            self._request_wake(nxt)

    def wake_timers(self, now: float | None = None) -> int:
        """Fire every due timer (node thread). Stale timers — their flow
        already resumed, failed, or parked on a LATER request — are dropped
        by the identity check against the live parked request."""
        now = self.clock() if now is None else now
        due = [t for t in self._timers if t[0] <= now]
        if not due:
            return 0
        self._timers = [t for t in self._timers if t[0] > now]
        fired = 0
        for _, run_id, request in due:
            fsm = self.flows.get(run_id)
            if fsm is None or fsm.done or fsm.parked_on is not request:
                continue
            fired += 1
            if isinstance(request, Sleep):
                fsm.response_log.append(("value", None))
                self._resume(fsm, value=None)
            else:
                err = FlowTimeoutException(
                    f"Timed out after {request.timeout_s}s waiting for "
                    f"{request.party.name}")
                fsm.response_log.append(("error", _error_payload(err)))
                self._resume(fsm, error=err)
        return fired

    def next_timer_deadline(self) -> float | None:
        return min((t[0] for t in self._timers), default=None)

    def _do_verify(self, fsm: FlowStateMachine, request: Verify):
        """The Verify suspension point (FlowStateMachineImpl.kt:379-393): park
        the flow on the configured TransactionVerifierService's future and
        resume it on the node thread when the future resolves — so Tpu /
        OutOfProcess backends verify off the node thread and N suspended
        flows' signatures coalesce into shared device batches. Without an
        async-capable service the verification runs synchronously here (the
        no-service fallback of Services.kt)."""
        svc = self.hub.verifier_service
        if svc is None or not hasattr(svc, "verify_signed"):
            try:
                request.stx.verify(
                    self.hub,
                    check_sufficient_signatures=request.check_sufficient_signatures)
            except Exception as e:
                # same yield-site contract as the async path: the failure is
                # thrown INTO the flow with its type preserved (a flow may
                # catch SignatureException and recover), not routed to _fail
                return self._log(fsm, ("error", _error_payload(e)))
            return self._log(fsm, ("value", None))
        kwargs = {}
        if getattr(svc, "supports_trace_ctx", False) and fsm.trace_ctx is not None:
            kwargs["trace_ctx"] = fsm.trace_ctx
        fut = svc.verify_signed(
            request.stx, self.hub,
            check_sufficient_signatures=request.check_sufficient_signatures,
            **kwargs)
        self._awaiting_external += 1
        fsm.park_t0 = _time.time()
        fut.add_done_callback(
            lambda f: self._post_external(
                lambda: self._on_verify_done(fsm, f, request)))
        return _PARK

    def _on_verify_done(self, fsm: FlowStateMachine, fut: Future,
                        request: Verify) -> None:
        """Node-thread continuation of a Verify park (via drain_external)."""
        self._awaiting_external -= 1
        if fsm.done or fsm.run_id not in self.flows:
            return   # flow failed/completed meanwhile (e.g. session error)
        if fsm.parked_on is not request:
            # Same identity guard as wake_timers: a stale or duplicate
            # future completion (double-invoked callback, flow already
            # resumed by another path) must not resume at the wrong yield.
            return
        self._record_wait(fsm, "wait.verify_park", "verify.park",
                          fsm.park_t0)
        err = fut.exception()
        if err is None:
            fsm.response_log.append(("value", None))
            self._resume(fsm, value=None)
        else:
            # the log records the type too, so a flow that CAUGHT this
            # error and continued replays identically after a restart
            fsm.response_log.append(("error", _error_payload(err)))
            self._resume(fsm, error=err)

    def _do_verify_many(self, fsm: FlowStateMachine, request: VerifyMany):
        """One yield site, N verifier submissions: the whole wave of a
        dependency-resolution frontier lands in the batcher concurrently
        (the group-commit analog on the verify side). Resumes with None
        when every verification succeeds; the first failure in submission
        order is thrown at the yield site. A node without an async
        verifier service falls back to verifying the wave synchronously."""
        stxs = list(request.stxs)
        if not stxs:
            return self._log(fsm, ("value", None))
        svc = self.hub.verifier_service
        if svc is None or not hasattr(svc, "verify_signed"):
            for stx in stxs:
                try:
                    stx.verify(self.hub, check_sufficient_signatures=
                               request.check_sufficient_signatures)
                except Exception as e:
                    return self._log(fsm, ("error", _error_payload(e)))
            return self._log(fsm, ("value", None))
        kwargs = {}
        if getattr(svc, "supports_trace_ctx", False) and fsm.trace_ctx is not None:
            kwargs["trace_ctx"] = fsm.trace_ctx
        futs = [svc.verify_signed(
                    stx, self.hub, check_sufficient_signatures=
                    request.check_sufficient_signatures, **kwargs)
                for stx in stxs]
        # ONE external-wait slot for the whole wave: the flow resumes once,
        # when the slowest member resolves
        self._awaiting_external += 1
        state = {"remaining": len(futs), "errors": {},
                 "n": len(futs), "t0": _time.time()}
        for i, fut in enumerate(futs):
            fut.add_done_callback(
                lambda f, i=i: self._post_external(
                    lambda: self._on_verify_many_one(fsm, f, i, state,
                                                     request)))
        return _PARK

    def _on_verify_many_one(self, fsm: FlowStateMachine, fut: Future,
                            index: int, state: dict,
                            request: VerifyMany) -> None:
        """Node-thread continuation for ONE member of a VerifyMany wave;
        the last arrival resumes the flow."""
        err = fut.exception()
        if err is not None:
            state["errors"][index] = err
        state["remaining"] -= 1
        if state["remaining"] > 0:
            return
        self._awaiting_external -= 1
        if fsm.done or fsm.run_id not in self.flows:
            return
        if fsm.parked_on is not request:
            return
        self._record_wait(fsm, "wait.verify_gather", "verify.gather",
                          state["t0"], wave=state["n"])
        if state["errors"]:
            first = state["errors"][min(state["errors"])]
            fsm.response_log.append(("error", _error_payload(first)))
            self._resume(fsm, error=first)
        else:
            fsm.response_log.append(("value", None))
            self._resume(fsm, value=None)

    def _do_await_future(self, fsm: FlowStateMachine, request: AwaitFuture):
        """Generic park-on-a-future (the notary-wait suspension point for
        the group-commit path): the producer runs on the node thread and
        returns a Future; the flow parks until it resolves and resumes
        with its result (which must be checkpoint-serializable) or its
        exception, type preserved across replay."""
        fut = request.producer()
        if fut is None:
            return self._log(fsm, ("value", None))
        if fut.done():   # fast path — no external wait, no extra drain turn
            err = fut.exception()
            if err is None:
                return self._log(fsm, ("value", fut.result()))
            return self._log(fsm, ("error", _error_payload(err)))
        self._awaiting_external += 1
        fsm.park_t0 = _time.time()
        fut.add_done_callback(
            lambda f: self._post_external(
                lambda: self._on_await_done(fsm, f, request)))
        return _PARK

    def _on_await_done(self, fsm: FlowStateMachine, fut: Future,
                       request: AwaitFuture) -> None:
        """Node-thread continuation of an AwaitFuture park."""
        self._awaiting_external -= 1
        if fsm.done or fsm.run_id not in self.flows:
            return
        if fsm.parked_on is not request:
            return
        self._record_wait(fsm, "wait.await_future",
                          getattr(request, "purpose", "future"),
                          fsm.park_t0)
        err = fut.exception()
        if err is None:
            fsm.response_log.append(("value", fut.result()))
            self._resume(fsm, value=fut.result())
        else:
            fsm.response_log.append(("error", _error_payload(err)))
            self._resume(fsm, error=err)

    def _log(self, fsm: FlowStateMachine, entry):
        """Append to the response log and produce the resume action."""
        fsm.response_log.append(entry)
        kind, value = entry
        if kind == "send":
            return (kind, None, None)
        if kind == "data":
            return (kind, UntrustworthyData(value), None)
        if kind == "value":
            return (kind, value, None)
        if kind == "commit":
            return (kind, self.hub.storage.get_transaction(value), None)
        if kind == "error":
            return (kind, None, _rebuild_error(value))
        raise AssertionError(entry)

    def _reexecute_parked(self, fsm: FlowStateMachine, request):
        """Re-arm a request that was pending when the checkpoint was written:
        receives re-check the (restored) inbound queue; ledger waits re-check
        storage; sends never park so never appear here."""
        if isinstance(request, (Receive, SendAndReceive)):
            return self._try_receive(fsm, request.party)
        return self._execute_request(fsm, request)

    def _replay_step(self, fsm: FlowStateMachine, request):
        """Consume one recorded response instead of performing IO
        (restore-and-resume: the IO already happened before the restart)."""
        entry = fsm.replay_queue.pop(0)
        kind, value = entry
        if kind == "send":
            return (kind, None, None)
        if kind == "data":
            return (kind, UntrustworthyData(value), None)
        if kind == "value":
            return (kind, value, None)
        if kind == "commit":
            return (kind, self.hub.storage.get_transaction(value), None)
        if kind == "error":
            return (kind, None, _rebuild_error(value))
        raise AssertionError(entry)

    def _try_receive(self, fsm: FlowStateMachine, party):
        sess = fsm.sessions[(fsm.current_group[0], str(party.name))]
        if sess.received:
            payload = sess.received.pop(0)
            return self._log(fsm, ("data", payload))
        if sess.error is not None:
            err, sess.error = sess.error, None
            sess.state = "ended"  # the session is dead; later receives must
            return self._log(fsm, ("error", str(err)))  # fail, not hang
        if sess.state in ("ended", "errored"):
            return self._log(fsm, ("error",
                                   f"Session with {party.name} has ended"))
        return _PARK

    # -- session plumbing ----------------------------------------------------
    def _ensure_session(self, fsm: FlowStateMachine, party,
                        first_payload) -> FlowSession:
        group, initiator_name = fsm.current_group
        key = (group, str(party.name))
        sess = fsm.sessions.get(key)
        if sess is not None:
            return sess
        sess = FlowSession(peer=party)
        sess.group = group
        fsm.sessions[key] = sess
        self._session_index[sess.our_session_id] = (fsm, sess)
        init = SessionInit(sess.our_session_id,
                           str(self.hub.my_info.legal_identity.name),
                           initiator_name, first_payload)
        self._post(party, init)
        sess._init_payload_sent = first_payload is not None
        return sess

    def _do_send(self, fsm: FlowStateMachine, party, payload) -> None:
        sess = fsm.sessions.get((fsm.current_group[0], str(party.name)))
        if sess is None:
            self._ensure_session(fsm, party, first_payload=payload)
            return
        if sess.state == "initiating":
            if not hasattr(sess, "pending_out"):
                sess.pending_out = []
            sess.pending_out.append(payload)
            return
        if sess.state in ("ended", "errored"):
            raise FlowException(f"Session with {party.name} is {sess.state}")
        self._post(party, SessionData(sess.peer_session_id, payload))

    def _post(self, party, message) -> None:
        svc = self.hub.network_service
        fsm = self.current_fsm
        if getattr(svc, "supports_trace", False) and fsm is not None \
                and fsm.trace_ctx is not None:
            ctx = fsm.trace_ctx
            # ctx is a SpanContext once _register ran under a live tracer,
            # but may still be the raw wire tuple of an initiating message
            ids = ctx if isinstance(ctx, tuple) else (ctx.trace_id, ctx.span_id)
            get_tracer().record(
                "session.send", parent=ctx, peer=str(party.name),
                kind=type(message).__name__)
            svc.send(TopicSession(TOPIC_P2P), serialize(message),
                     str(party.name), trace=ids)
            return
        svc.send(TopicSession(TOPIC_P2P), serialize(message), str(party.name))

    def on_peer_unreachable(self, peer_name: str) -> None:
        """Transport-level delivery failure (the TCP plane's
        on_send_failure hook): every live session toward that peer errors,
        waking parked flows with a FlowException at their yield site — the
        analog of the reference's undeliverable-message surfacing. Without
        this a flow awaiting a dead peer's reply parks forever."""
        for fsm in list(self.flows.values()):
            for sess in list(fsm.sessions.values()):
                if str(sess.peer.name) != str(peer_name) or \
                        sess.state in ("ended", "errored"):
                    continue
                sess.state = "errored"
                sess.error = FlowException(
                    f"peer {peer_name} is unreachable")
                self._maybe_deliver(fsm, sess)

    # -- inbound dispatch (onSessionMessage, StateMachineManager.kt:307+) ----
    def _on_message(self, msg) -> None:
        sm = deserialize(msg.data)
        trace = getattr(msg, "trace", None)
        if trace is not None:
            get_tracer().record("session.receive", parent=trace,
                                sender=str(getattr(msg, "sender", None)),
                                kind=type(sm).__name__)
        if isinstance(sm, SessionInit):
            self._on_session_init(sm, trace=trace)
            return
        if isinstance(sm, SessionConfirm):
            entry = self._session_index.get(sm.initiator_session_id)
            if entry is None:
                return
            fsm, sess = entry
            sess.peer_session_id = sm.initiated_session_id
            sess.state = "open"
            for payload in getattr(sess, "pending_out", []):
                self._post(sess.peer, SessionData(sess.peer_session_id, payload))
            if hasattr(sess, "pending_out"):
                sess.pending_out = []
            return
        entry = self._session_index.get(sm.recipient_session_id
                                        if not isinstance(sm, SessionReject)
                                        else sm.initiator_session_id)
        if entry is None:
            return
        fsm, sess = entry
        if isinstance(sm, SessionReject):
            sess.state = "errored"
            sess.error = FlowException(sm.error_message)
        elif isinstance(sm, SessionData):
            sess.received.append(sm.payload)
        elif isinstance(sm, NormalSessionEnd):
            sess.state = "ended"
        elif isinstance(sm, ErrorSessionEnd):
            sess.state = "errored"
            sess.error = FlowException(sm.error_message)
        self._maybe_deliver(fsm, sess)

    def _maybe_deliver(self, fsm: FlowStateMachine, sess: FlowSession) -> None:
        req = fsm.parked_on
        if req is None or not isinstance(req, (Receive, SendAndReceive)):
            return
        if str(req.party.name) != str(sess.peer.name):
            return
        if fsm.parked_group != getattr(sess, "group", 0):
            return  # data for a different sub-flow's session
        if sess.received:
            payload = sess.received.pop(0)
            fsm.response_log.append(("data", payload))
            self._resume(fsm, value=UntrustworthyData(payload))
        elif sess.error is not None:
            err, sess.error = sess.error, None
            sess.state = "ended"
            fsm.response_log.append(("error", str(err)))
            self._resume(fsm, error=FlowException(str(err)))
        elif sess.state == "ended":
            msg = f"Session with {sess.peer.name} has ended"
            fsm.response_log.append(("error", msg))
            self._resume(fsm, error=FlowException(msg))

    def register_flow_factory(self, initiator_name: str, factory) -> None:
        self.flow_factories[initiator_name] = factory

    def discard_session(self, fsm: FlowStateMachine, group: int,
                        party_name: str) -> None:
        """Forget a (dead) session entirely — including its inbound-routing
        index entry, so a late message on the old session id can never reach
        the flow again (the retry helper's fresh-session semantics).

        No-op during checkpoint replay: the logged error that triggered the
        original discard is being replayed from the response log, but the
        session in the table is the *restored* (live) one — popping it would
        orphan the flow's later exchanges with the same party (same principle
        as ExecuteOnce: side effects must not re-run during replay)."""
        if fsm.replaying:
            return
        sess = fsm.sessions.pop((group, party_name), None)
        if sess is not None:
            self._session_index.pop(sess.our_session_id, None)

    def _on_session_init(self, init: SessionInit,
                         trace: tuple | None = None) -> None:
        factory = (self.flow_factories.get(init.flow_name)
                   or get_initiated_flow_factory(init.flow_name))
        peer = self.hub.well_known_party(init.initiator_party)
        if factory is None or peer is None:
            reason = (f"No initiated flow registered for {init.flow_name}"
                      if factory is None else
                      f"Unknown party {init.initiator_party}")
            if peer is not None:
                self._post(peer, SessionReject(init.initiator_session_id, reason))
            return
        flow = factory(peer)
        fsm = FlowStateMachine(uuid.uuid4().hex, flow, self)
        # the responder flow's span joins the initiator's trace — the wire
        # carried (trace_id, span_id), so the whole P2P exchange is one trace
        fsm.trace_ctx = trace
        self._register(fsm)
        sess = FlowSession(peer=peer,
                           peer_session_id=init.initiator_session_id,
                           state="open")
        sess.group = 0  # the responder's top-level session
        fsm.sessions[(0, str(peer.name))] = sess
        self._session_index[sess.our_session_id] = (fsm, sess)
        if init.first_payload is not None:
            sess.received.append(init.first_payload)
        self._post(peer, SessionConfirm(init.initiator_session_id,
                                        sess.our_session_id))
        self._notify("add", fsm)
        self._start_generator(fsm)
        self._advance(fsm, first=True)

    # -- ledger-commit wakeups ----------------------------------------------
    def _on_tx_committed(self, stx) -> None:
        for fsm in self._commit_waiters.pop(stx.id, []):
            fsm.response_log.append(("commit", stx.id))
            self._resume(fsm, value=stx)

    # -- completion ----------------------------------------------------------
    def _complete(self, fsm: FlowStateMachine, result) -> None:
        fsm.done = True
        self._end_sessions(fsm, error=None)
        self._finalize(fsm)
        fsm.result_future.set_result(result)
        self._notify("remove", fsm)

    def _fail(self, fsm: FlowStateMachine, error: Exception) -> None:
        fsm.done = True
        audit = getattr(self.hub, "audit", None)
        if audit is not None:
            from .audit import FlowErrorAuditEvent
            audit.record_audit_event(FlowErrorAuditEvent(
                description="flow failed",
                flow_type=flow_name(type(fsm.flow)), flow_id=fsm.run_id,
                error=f"{type(error).__name__}: {error}"))
        self._end_sessions(fsm, error=error)
        self._finalize(fsm)
        fsm.result_future.set_exception(error)
        self._notify("remove", fsm)

    def _finalize(self, fsm: FlowStateMachine) -> None:
        if fsm.trace_span is not None:
            fsm.trace_span.finish()
            fsm.trace_span = None
        jlog(_log, "flow.end", ctx=fsm.trace_ctx,
             flow_type=flow_name(type(fsm.flow)), flow_id=fsm.run_id)
        monitoring = getattr(self.hub, "monitoring", None)
        if monitoring is not None and fsm.run_id in self.flows:
            monitoring.meter("Flows.Finished").mark()
            monitoring.counter("Flows.InFlight").dec()
            started = getattr(fsm, "started_at", None)
            if started is not None:
                trace_id = getattr(fsm.trace_ctx, "trace_id", None)
                monitoring.histogram("flow_run_seconds").update(
                    _time.perf_counter() - started, trace_id=trace_id)
        # crash-consistency seam: a "drop" rule here models a process kill
        # AFTER the flow's sends went out but BEFORE the checkpoint was
        # removed — the surviving artifact of exactly that crash window.
        # Restart must replay the checkpoint idempotently (no re-sends).
        if fault_point("smm.checkpoint_remove", detail=fsm.run_id) != DROP:
            self.checkpoints.remove_checkpoint(fsm.run_id)
        self.flows.pop(fsm.run_id, None)
        self._cleanup_sessions(fsm)
        # auto-release any vault soft locks held under this flow's id —
        # VaultSoftLockManager parity (locks must not outlive their flow)
        vault = getattr(self.hub, "vault", None)
        if vault is not None:
            vault.soft_lock_release(fsm.run_id)

    def _end_sessions(self, fsm: FlowStateMachine, error) -> None:
        for sess in fsm.sessions.values():
            if sess.state not in ("open", "initiating") or sess.peer_session_id is None:
                continue
            if error is None:
                self._post(sess.peer, NormalSessionEnd(sess.peer_session_id))
            else:
                self._post(sess.peer,
                           ErrorSessionEnd(sess.peer_session_id, str(error)))

    def _cleanup_sessions(self, fsm: FlowStateMachine) -> None:
        for sess in fsm.sessions.values():
            self._session_index.pop(sess.our_session_id, None)

    # -- checkpointing -------------------------------------------------------
    def _checkpoint(self, fsm: FlowStateMachine) -> None:
        """Atomic checkpoint at suspension (updateCheckpoint,
        StateMachineManager.kt:526-543)."""
        # live handles, not state: the hub, the machine, and a notary
        # flow's service (the node's own, found on the hub on restore)
        fields = {k: v for k, v in vars(fsm.flow).items()
                  if k not in ("state_machine", "service_hub",
                               "notary_service")}
        sessions = [SessionSnapshot(
            peer_name=str(s.peer.name), our_session_id=s.our_session_id,
            peer_session_id=s.peer_session_id, state=s.state,
            received=list(s.received),
            pending_out=list(getattr(s, "pending_out", [])),
            group=getattr(s, "group", 0))
            for s in fsm.sessions.values()]
        cp = Checkpoint(run_id=fsm.run_id,
                        flow_class=flow_name(type(fsm.flow)),
                        flow_fields=fields,
                        response_log=list(fsm.response_log),
                        sessions=sessions)
        self.checkpoints.add_checkpoint(cp)

    def _restore(self, cp: Checkpoint) -> None:
        """Rebuild a flow from its checkpoint and replay it to its suspension
        point (restoreFibersFromCheckpoints semantics via replay)."""
        cls = _import_flow_class(cp.flow_class)
        flow = cls.__new__(cls)
        for k, v in cp.flow_fields.items():
            setattr(flow, k, v)
        fsm = FlowStateMachine(cp.run_id, flow, self)
        fsm.response_log = list(cp.response_log)
        fsm.replay_queue = list(cp.response_log)
        self._register(fsm)
        for snap in cp.sessions:
            peer = self.hub.well_known_party(snap.peer_name)
            sess = FlowSession(peer=peer, our_session_id=snap.our_session_id,
                               peer_session_id=snap.peer_session_id,
                               state=snap.state, received=list(snap.received))
            sess.pending_out = list(snap.pending_out)
            sess.group = snap.group
            fsm.sessions[(snap.group, snap.peer_name)] = sess
            self._session_index[sess.our_session_id] = (fsm, sess)
        fsm.restoring = True
        self._notify("add", fsm)
        self._start_generator(fsm)
        self._advance(fsm, first=True)


class FlowScheduler:
    """Bounded-concurrency flow launcher for one node — the cooperative
    multi-flow discipline (reference: thousands of Quasar fibers per node,
    PAPER.md L5b). Flows already interleave on the node thread by parking
    at send/receive/verify/notary-wait; what serialized them was the
    caller launching one flow and joining it end-to-end. The scheduler
    keeps up to ``max_concurrent`` flows in flight so a node continuously
    feeds the verifier batcher's and the GroupCommitter's bulk classes.

    Node-thread only: ``submit`` enqueues a factory and returns a proxy
    Future; each completion launches the next waiter via the external
    queue (never recursively inside the finishing flow's stack), so
    MockNetwork pumping and checkpoint replay stay deterministic."""

    def __init__(self, smm: StateMachineManager, max_concurrent: int = 8):
        self.smm = smm
        self.max_concurrent = max_concurrent
        self._waiting: list = []      # (flow factory, proxy, submit wall ts)
        self._in_flight = 0
        self.high_water = 0           # max concurrent in-flight observed
        self.launched = 0

    @property
    def in_flight(self) -> int:
        return self._in_flight

    @property
    def waiting(self) -> int:
        return len(self._waiting)

    def submit(self, flow_factory) -> Future:
        """Queue a flow for launch; returns a Future mirroring the flow's
        result_future (result or exception)."""
        proxy: Future = Future()
        self._waiting.append((flow_factory, proxy, _time.time()))
        self._pump()
        return proxy

    def _pump(self) -> None:
        while self._waiting and self._in_flight < self.max_concurrent:
            factory, proxy, t_sub = self._waiting.pop(0)
            self._in_flight += 1
            self.launched += 1
            if self._in_flight > self.high_water:
                self.high_water = self._in_flight
            try:
                fsm = self.smm.add(factory())
            except Exception as e:
                self._in_flight -= 1
                proxy.set_exception(e)
                continue
            # admission wait: submit-to-launch time spent in _waiting. The
            # flow's root span only exists from launch, so the wait span
            # is recorded retroactively, starting BEFORE its parent — the
            # critical-path extractor prepends it to the blocking chain.
            self.smm._record_wait(fsm, "wait.scheduler_admission",
                                  "scheduler.admission", t_sub)
            fsm.result_future.add_done_callback(
                lambda f, proxy=proxy: self._on_done(f, proxy))

    def _on_done(self, fut: Future, proxy: Future) -> None:
        # result_future resolves on the node thread (_complete/_fail), so
        # launching the next waiter here would recursively advance a new
        # flow inside the finishing flow's stack — defer the pump through
        # the external queue to keep the drive loop's discipline
        self._in_flight -= 1
        err = fut.exception()
        if err is None:
            proxy.set_result(fut.result())
        else:
            proxy.set_exception(err)
        if self._waiting:
            self.smm._post_external(self._pump)


_PARK = object()


def _error_payload(exc: Exception):
    """Checkpointable encoding of a flow-visible error that preserves the
    TYPE across replay: flows legitimately catch specific exceptions
    (FlowTimeoutException, SignatureException from Verify) and continue —
    replaying them as bare FlowException would make a recovered flow
    diverge after a restart. Plain FlowExceptions stay strings (legacy
    log-entry format, still accepted by _rebuild_error)."""
    if type(exc) is FlowException:
        return str(exc)
    return [f"{type(exc).__module__}:{type(exc).__qualname__}", str(exc)]


#: Modules whose Exception types may be reconstructed from a checkpoint
#: log. A fixed list (not a dynamic import of whatever 'module:qualname'
#: the payload names): checkpoint storage or a session error must not be
#: able to trigger arbitrary import side effects or invoke arbitrary
#: one-string-arg callables — mirrors the reference's checkpoint class
#: restrictions (CheckpointSerializationScheme).
#: Only this package's modules.
_ERROR_MODULES = (
    "corda_tpu_torch.flows.api",
    "corda_tpu_torch.flows.library",
    "corda_tpu_torch.flows.state_replacement",
    "corda_tpu_torch.flows.contract_upgrade",
    "corda_tpu_torch.core.contracts.exceptions",
    "corda_tpu_torch.core.crypto.signatures",
    "corda_tpu_torch.core.crypto.merkle",
    "corda_tpu_torch.core.transactions.signed",
    "corda_tpu_torch.core.serialization.codec",
    "corda_tpu_torch.node.notary",
)
_ERROR_REGISTRY: dict[str, type] | None = None


def _error_registry() -> dict[str, type]:
    global _ERROR_REGISTRY
    if _ERROR_REGISTRY is None:
        import importlib

        reg: dict[str, type] = {}
        for mod_name in _ERROR_MODULES:
            mod = importlib.import_module(mod_name)
            for obj in vars(mod).values():
                # defining module only — re-exports register under their
                # home module, matching _error_payload's encoding
                if (isinstance(obj, type) and issubclass(obj, Exception)
                        and obj.__module__ == mod_name):
                    reg[f"{mod_name}:{obj.__qualname__}"] = obj
        for obj in (ValueError, KeyError, RuntimeError, TimeoutError):
            reg[f"builtins:{obj.__qualname__}"] = obj
        _ERROR_REGISTRY = reg
    return _ERROR_REGISTRY


def _rebuild_error(payload) -> Exception:
    if isinstance(payload, str):
        return FlowException(payload)
    type_path, msg = payload
    cls = _error_registry().get(type_path)
    if cls is None:
        return FlowException(msg)
    try:
        return cls(msg)
    except Exception:
        return FlowException(msg)


def _import_flow_class(name: str) -> type:
    import importlib

    # flow_name() produces module.QualName where QualName may be dotted
    parts = name.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        obj = mod
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"Cannot resolve flow class {name!r}")
