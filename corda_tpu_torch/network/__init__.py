"""Messaging plane: the service interface, topics and the deterministic
in-memory bus (own copies of corda_tpu.network's modules of the same
names). The TCP plane is not ported yet.

Reference parity: MessagingService (node/services/messaging/Messaging.kt:1-230)
and the deterministic InMemoryMessagingNetwork used by MockNetwork
(test-utils/.../InMemoryMessagingNetwork.kt:47-79).
"""
from .messaging import Message, MessagingService, TopicSession  # noqa: F401
from .inmemory import InMemoryMessagingNetwork  # noqa: F401
