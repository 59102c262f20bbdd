"""Network map service: the node directory with registration + push updates.

Reference parity: NetworkMapService topics platform.network_map.{fetch,
register, subscribe, push} (node/services/network/NetworkMapService.kt:65-71),
AbstractNetworkMapService/PersistentNetworkMapService, and the client-side
registration in AbstractNode.registerWithNetworkMapIfConfigured
(AbstractNode.kt:587-620). Registrations are SIGNED by the registering node's
identity key and verified before acceptance (the reference's
NodeRegistration.toWire signature model).

A copy of the reference's module; the client's ``fetched`` event is set once
the map has answered a fetch, so a restarting node can restore its
checkpoints after its directory arrived.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

from ..core.crypto.signatures import Crypto, DigitalSignatureWithKey
from ..core.serialization import deserialize, register_type, serialize
from .messaging import (TOPIC_NETWORK_MAP_FETCH, TOPIC_NETWORK_MAP_PUSH,
                        TOPIC_NETWORK_MAP_REGISTER, TOPIC_NETWORK_MAP_SUBSCRIBE,
                        TopicSession)

ADD = "ADD"
REMOVE = "REMOVE"


def _signed_payload(node_info_bytes: bytes, serial: int) -> bytes:
    """What a registration signature covers: the info bytes AND the full
    serial (a truncated serial would let an attacker replay old info under a
    higher serial with a matching low byte)."""
    return node_info_bytes + serial.to_bytes(8, "big")


def make_registration(hub, info, serial: int, reg_type: str) -> "NodeRegistration":
    """Build a signed NodeRegistration with this node's identity key — the
    single signing convention shared by clients and the map node itself."""
    info_bytes = serialize(info)
    sig = hub.key_management.sign(_signed_payload(info_bytes, serial),
                                  info.legal_identity.owning_key)
    return NodeRegistration(info_bytes, serial, reg_type, sig)


@dataclass(frozen=True)
class NodeRegistration:
    """A signed add/remove request (NetworkMapService.NodeRegistration)."""

    node_info_bytes: bytes      # canonical NodeInfo wire form (what's signed)
    serial: int                 # monotonic per-node version
    type: str                   # ADD | REMOVE
    signature: DigitalSignatureWithKey


@dataclass(frozen=True)
class FetchMapResponse:
    registrations: tuple


@dataclass(frozen=True)
class Update:
    registration: NodeRegistration


for _cls in (NodeRegistration, FetchMapResponse, Update):
    register_type(f"netmap.{_cls.__name__}", _cls)

# NodeInfo/ServiceInfo must cross the wire for fetch/push
from ..node.services import NodeInfo, ServiceInfo  # noqa: E402

register_type("ServiceInfo", ServiceInfo)
register_type(
    "NodeInfo", NodeInfo,
    to_fields=lambda n: [n.address, n.legal_identity, list(n.advertised_services)],
    from_fields=lambda f: NodeInfo(f[0], f[1], tuple(f[2])))


class NetworkMapService:
    """The directory node's service half. Attach to a node's messaging."""

    def __init__(self, network_service, local_cache=None):
        self.network_service = network_service
        self.local_cache = local_cache  # the hosting node's own map cache
        self._registrations: dict[str, NodeRegistration] = {}  # name -> latest
        self._serials: dict[str, int] = {}
        self._subscribers: set[str] = set()
        network_service.add_message_handler(
            TopicSession(TOPIC_NETWORK_MAP_REGISTER), self._on_register)
        network_service.add_message_handler(
            TopicSession(TOPIC_NETWORK_MAP_FETCH), self._on_fetch)
        network_service.add_message_handler(
            TopicSession(TOPIC_NETWORK_MAP_SUBSCRIBE), self._on_subscribe)

    # -- handlers ------------------------------------------------------------
    def _on_register(self, msg) -> None:
        self.apply_registration(deserialize(msg.data))

    def apply_registration(self, reg: NodeRegistration) -> None:
        """Validate + apply a signed registration (also used by the map node
        to publish its own identity at startup)."""
        info: NodeInfo = deserialize(reg.node_info_bytes)
        name = str(info.legal_identity.name)
        # signature must be by the node's own identity key over the info bytes
        if reg.signature.by != info.legal_identity.owning_key:
            return
        if not reg.signature.is_valid(_signed_payload(reg.node_info_bytes,
                                                      reg.serial)):
            return
        if reg.serial <= self._serials.get(name, -1):
            return  # stale
        self._serials[name] = reg.serial
        if reg.type == ADD:
            self._registrations[name] = reg
        else:
            self._registrations.pop(name, None)
        if self.local_cache is not None:
            if reg.type == ADD:
                self.local_cache.add_node(info)
            else:
                self.local_cache.remove_node(name)
        self._push(reg)

    def _on_fetch(self, msg) -> None:
        # the requester's private reply session rides in the request payload
        # (the reference's replyTo/sessionID request fields)
        reply_session = deserialize(msg.data)
        resp = FetchMapResponse(tuple(self._registrations.values()))
        self.network_service.send(
            TopicSession(TOPIC_NETWORK_MAP_FETCH, reply_session),
            serialize(resp), msg.sender)

    def _on_subscribe(self, msg) -> None:
        self._subscribers.add(msg.sender)

    def _push(self, reg: NodeRegistration) -> None:
        for name in list(self._subscribers):
            self.network_service.send(TopicSession(TOPIC_NETWORK_MAP_PUSH),
                                      serialize(Update(reg)), name)


class NetworkMapClient:
    """The node-side half: register ourselves, fetch and track the map
    (AbstractNode.registerWithNetworkMapIfConfigured + InMemoryNetworkMapCache
    update wiring)."""

    def __init__(self, hub, map_node_name: str):
        self.hub = hub
        self.map_node_name = map_node_name
        # epoch-millis base so a restarted node (serial counter reset) still
        # outranks its previous registrations at the map service
        import time
        self._serial = int(time.time() * 1000)
        self._fetch_session = 7001  # private response session
        self.fetched = threading.Event()   # the map answered a fetch
        hub.network_service.add_message_handler(
            TopicSession(TOPIC_NETWORK_MAP_PUSH), self._on_push)
        hub.network_service.add_message_handler(
            TopicSession(TOPIC_NETWORK_MAP_FETCH, self._fetch_session),
            self._on_fetch_response)

    def register(self) -> None:
        self._serial += 1
        reg = make_registration(self.hub, self.hub.my_info, self._serial, ADD)
        self.hub.network_service.send(TopicSession(TOPIC_NETWORK_MAP_REGISTER),
                                      serialize(reg), self.map_node_name)

    def fetch(self) -> None:
        self.hub.network_service.send(
            TopicSession(TOPIC_NETWORK_MAP_FETCH),
            serialize(self._fetch_session), self.map_node_name)

    def subscribe(self) -> None:
        self.hub.network_service.send(TopicSession(TOPIC_NETWORK_MAP_SUBSCRIBE),
                                      b"", self.map_node_name)

    # -- inbound -------------------------------------------------------------
    def _apply(self, reg: NodeRegistration) -> None:
        info: NodeInfo = deserialize(reg.node_info_bytes)
        if reg.type == ADD:
            self.hub.network_map_cache.add_node(info)
        else:
            self.hub.network_map_cache.remove_node(str(info.legal_identity.name))

    def _on_push(self, msg) -> None:
        self._apply(deserialize(msg.data).registration)

    def _on_fetch_response(self, msg) -> None:
        for reg in deserialize(msg.data).registrations:
            self._apply(reg)
        self.fetched.set()
