"""Node runtime: state machine manager, service hub, checkpoint storage.

Reference parity: the node "kernel" layer (node/internal/AbstractNode.kt:160+,
services/statemachine/StateMachineManager.kt) rebuilt host-side around the
generator/replay flow model (see the flows package).
"""
from .checkpoints import CheckpointStorage, Checkpoint  # noqa: F401
from .services import NodeInfo, ServiceHub, TransactionStorage  # noqa: F401
from .statemachine import StateMachineManager, FlowStateMachine  # noqa: F401
