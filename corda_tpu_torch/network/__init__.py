"""Messaging plane: the service interface, topics, the deterministic
in-memory bus, the TCP plane with its mutual-TLS identity, the network map
and the doorman's certificate enrolment (own copies of the reference
package's network modules of the same names).

Reference parity: MessagingService (node/services/messaging/Messaging.kt:1-230)
and the deterministic InMemoryMessagingNetwork used by MockNetwork
(test-utils/.../InMemoryMessagingNetwork.kt:47-79).
"""
from .messaging import Message, MessagingService, TopicSession  # noqa: F401
from .inmemory import InMemoryMessagingNetwork  # noqa: F401
