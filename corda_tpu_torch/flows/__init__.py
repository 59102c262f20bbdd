"""The flow framework — the ledger's programming model.

Reference parity: FlowLogic (core/flows/FlowLogic.kt:37 — send/receive/
sendAndReceive/subFlow/waitForLedgerCommit), @InitiatingFlow/@InitiatedBy/
@StartableByRPC annotations, and the session protocol semantics of
node/services/statemachine.

Host-native redesign (SURVEY.md §7 phase 3): flows are Python
*generators* — `call()` yields FlowIORequest objects and receives responses
at the yield site. Checkpointing uses **deterministic replay** (an
event-sourced response log) instead of continuation serialization: a
checkpoint is (flow reference, constructor args, ordered responses consumed
so far); resume re-executes `call()` feeding the log back until it catches
up, then continues live. No bytecode weaving, no frame capture — the
at-suspend atomic checkpoint+effects semantics of
FlowStateMachineImpl.kt:379-393 are kept, the mechanism is idiomatic Python.
The determinism contract this imposes on flow code matches what the
reference already demands of @Suspendable methods (resumable on another JVM).

Own copies of the reference package's flow modules of the same names. A
flow's name (``api.flow_name``) is its module path, so this package's flows
are named ``corda_tpu_torch.flows...``: a node of this package answers only
its own package's session inits and restores only its own checkpoints.
"""
from .api import (  # noqa: F401
    FlowException,
    FlowLogic,
    FlowSession,
    InitiatingFlow,
    Receive,
    Send,
    SendAndReceive,
    UntrustworthyData,
    WaitForLedgerCommit,
    initiated_by,
    initiating_flow,
    startable_by_rpc,
    get_initiated_flow_factory,
    rpc_startable_flows,
)
from .confidential import (  # noqa: F401
    TransactionKeyFlow,
    TransactionKeyHandler,
)
