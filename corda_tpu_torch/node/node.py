"""Node — the production runtime assembling every service over TCP.

Reference parity: AbstractNode.start (node/internal/AbstractNode.kt:160-222 —
services assembled in dependency order), Node's messaging/RPC wiring
(internal/Node.kt:83), NodeStartup CLI entry (internal/NodeStartup.kt), the
typed configuration layer (config/NodeConfiguration.kt:34-94 incl.
`verifierType`), and the RPC server request/response protocol (RPCServer.kt +
RPCApi.kt — here framed over the TCP plane with a reply address carried in
the request, observables served as polled snapshots).

A copy of the reference's module. ``NodeConfiguration.device`` (default
"cuda", raising without CUDA) is the device the node's own device work and
its ``verifier_type="Tpu"`` service run on; the default cordapp is the port's
finance package. An RPC result the codec refuses (floats: metric and
profiler snapshots) goes to the client as its JSON text (``JsonResult``),
where the reference's node answers with an error. A node with checkpoints
restores them once the network map has answered its fetch (the reference's
restores at once, and a flow that ends a session with a peer the directory
does not hold yet fails the boot).
"""
from __future__ import annotations

import json
import logging
import os
import uuid
from dataclasses import dataclass, field

from ..core.crypto.keys import KeyPair, PrivateKey, PublicKey, generate_keypair
from ..core.identity import Party
from ..core.serialization import (SerializationError, deserialize,
                                  register_type, serialize)
from ..flows.library import install_core_flows
from ..network.messaging import TopicSession
from ..network.netmap import NetworkMapClient, NetworkMapService
from ..network.tcp import TcpMessagingService
from ..utils.affinity import SerialExecutor
from .checkpoints import FileCheckpointStorage  # noqa: F401 (public re-export)
from .notary import (FileUniquenessProvider, SimpleNotaryService,
                     ValidatingNotaryService)
from .rpc import CordaRPCOps
from .services import NodeInfo, ServiceHub, ServiceInfo
from .statemachine import StateMachineManager

log = logging.getLogger(__name__)

TOPIC_RPC = "rpc.requests"
#: how long a restarting node waits for the network map's directory before
#: it restores its checkpoints
MAP_FETCH_WAIT_S = 30.0


@dataclass
class NodeConfiguration:
    """Typed config (NodeConfiguration.kt parity). Loadable from JSON —
    the HOCON layering analog is defaults-in-dataclass + file overrides."""

    my_legal_name: str
    host: str = "127.0.0.1"
    port: int = 0                      # 0 = ephemeral
    base_directory: str = "."
    network_map_name: str | None = None
    network_map_address: str | None = None   # "host:port"
    notary: str | None = None          # None | "simple" | "validating"
    verifier_type: str = "InMemory"    # InMemory | Tpu | OutOfProcess
    # with verifier_type=Tpu: shard every device batch over the first N
    # local CUDA devices (a corda_tpu_torch.parallel Mesh: one CUDA stream a
    # shard, the results gathered on the first device) — the config-driven
    # scale-out seam (the reference scales out by launching N verifier
    # JVMs, Verifier.kt:42-79; a host with several cards scales across
    # them instead). None = one device.
    mesh_devices: int | None = None
    # the device the node's own device work and its Tpu verifier run on
    # ("cuda" by default; "cpu" runs the plain kernels). With mesh_devices
    # on "cpu", the mesh's shards are that many CPU devices.
    device: str = "cuda"
    # with verifier_type=OutOfProcess: how many fleet workers the operator
    # runs against this node's queue. The node works with any number
    # attached (competing consumers); /readyz reports fewer-than-expected
    # as a degraded fleet. None = no expectation.
    verifier_workers: int | None = None
    key_seed_hex: str | None = None    # deterministic identity (tests)
    tls: bool = False                  # mutual TLS on the TCP plane
    # shared dev-CA directory (all nodes of one network must agree);
    # default: a "dev-ca" sibling of base_directory
    tls_ca_directory: str | None = None
    # modules imported at boot so their @startable_by_rpc / @initiated_by
    # registrations load — the cordapp classpath scan (AbstractNode.kt:201-206)
    cordapps: list = field(default_factory=lambda: ["corda_tpu_torch.finance"])

    def __post_init__(self):
        # fail at CONSTRUCTION, before a misconfigured node binds sockets,
        # writes its identity or spawns threads: an OutOfProcess/InMemory
        # node silently ignoring mesh_devices would boot without the chips
        # the operator configured (workers take --mesh-devices instead)
        if self.mesh_devices is not None and self.verifier_type != "Tpu":
            raise ValueError(
                "mesh_devices requires verifier_type=Tpu "
                f"(got {self.verifier_type!r}; for OutOfProcess, "
                "pass --mesh-devices to the verifier worker)")
        if (self.verifier_workers is not None
                and self.verifier_type != "OutOfProcess"):
            raise ValueError(
                "verifier_workers requires verifier_type=OutOfProcess "
                f"(got {self.verifier_type!r}) — only the out-of-process "
                "queue has a worker fleet to expect")

    @staticmethod
    def load(path: str) -> "NodeConfiguration":
        with open(path) as f:
            return NodeConfiguration(**json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.__dict__, f, indent=2)


@dataclass(frozen=True)
class RpcRequest:
    request_id: str
    method: str
    args: list
    reply_to: str              # "host:port" of the caller


@dataclass(frozen=True)
class RpcResponse:
    request_id: str
    result: object = None
    error: str | None = None


@dataclass(frozen=True)
class FeedHandle:
    """A server-assigned observable id + the snapshot (the reference
    serializes Observables as ids on the RPC wire, RPCApi.kt:27-60)."""

    feed_id: str
    snapshot: object


@dataclass(frozen=True)
class Observation:
    """One pushed observation for a subscribed feed (RPCApi Observation)."""

    feed_id: str
    payload: object


@dataclass(frozen=True)
class JsonResult:
    """An RPC result the codec cannot carry, as its JSON text: the codec
    refuses floats (consensus data), and metric and profiler snapshots and
    the /debug reports hold rates and durations. The port's CordaRPCClient
    returns the parsed value."""

    text: str


register_type("rpc.RpcRequest", RpcRequest,
              to_fields=lambda r: [r.request_id, r.method, list(r.args), r.reply_to],
              from_fields=lambda f: RpcRequest(f[0], f[1], list(f[2]), f[3]))
register_type("rpc.RpcResponse", RpcResponse)
register_type("rpc.FeedHandle", FeedHandle)
register_type("rpc.Observation", Observation)
register_type("rpc.JsonResult", JsonResult)


class Node:
    def __init__(self, config: NodeConfiguration):
        self.config = config
        # cordapps must load BEFORE the durable stores open: a restarted
        # node deserializes its recorded transactions at construction, and
        # their state/command types live in the cordapp modules
        import importlib
        for module in config.cordapps:
            importlib.import_module(module)
        os.makedirs(config.base_directory, exist_ok=True)
        self.key_pair = self._load_or_create_identity()
        self.party = Party(config.my_legal_name, self.key_pair.public)
        self.executor = SerialExecutor(f"node-thread({config.my_legal_name})")
        tls_config = None
        if config.tls:
            from ..network.tls import TlsConfig
            ca_dir = config.tls_ca_directory or os.path.join(
                os.path.dirname(os.path.abspath(config.base_directory)), "dev-ca")
            tls_config = TlsConfig.dev(config.base_directory,
                                       str(self.party.name), ca_dir)
        self.messaging = TcpMessagingService(
            str(self.party.name), config.host, config.port,
            self._resolve_address, executor=self.executor, tls=tls_config)

        services = ()
        if config.notary == "simple":
            services = (ServiceInfo(SimpleNotaryService.type_id),)
        elif config.notary == "validating":
            services = (ServiceInfo(ValidatingNotaryService.type_id),)
        self.info = NodeInfo(address=f"{config.host}:{self.messaging.port}",
                             legal_identity=self.party,
                             advertised_services=services)
        self.services = ServiceHub(self.info, self.messaging,
                                   key_pairs=[self.key_pair],
                                   device=config.device)
        # fresh (confidential-identity) keys must survive restarts, or the
        # vault replay below would drop states they own as irrelevant
        from .services import KeyManagementService
        self.services.key_management = KeyManagementService(
            [self.key_pair],
            store_path=os.path.join(config.base_directory, "fresh-keys.jsonl"))
        # durable storage on the kvlog engine (native C++ when built, the
        # format-identical Python engine otherwise) — transactions AND
        # checkpoints persist together, or resumed flows would reference
        # transactions a restart forgot
        from .checkpoints import KvCheckpointStorage
        from .services import DurableTransactionStorage
        self.services.storage = DurableTransactionStorage(
            os.path.join(config.base_directory, "transactions.kv"))
        # RESTART path: the vault (and its observers — schema tables,
        # scheduler) is an in-memory index over the durable store; replay
        # the recorded transactions in order so a restarted node still
        # holds its pre-crash states (spends re-consume as they replay)
        stored = self.services.storage.transactions
        if stored:
            self.services.vault.notify_all(stored)
        checkpoint_storage = KvCheckpointStorage(
            os.path.join(config.base_directory, "checkpoints.kv"))
        self.services.verifier_service = self._make_verifier()
        self.smm = StateMachineManager(self.services, checkpoint_storage)
        self.services.smm = self.smm
        # async verify completions (the Verify suspension point) re-enter
        # flows on the node thread, serialized with message handling. A
        # completion may resolve on the node thread itself, inside the step
        # that parks its flow (a verify already done when its callback is
        # added): it is queued behind that step, never run inline
        self.smm.scheduler_poke = \
            lambda: self.executor.post(self.smm.drain_external)
        # flow timers (Sleep / receive timeouts) fire back onto the node
        # thread the same way
        self.smm.timer_driver = self._schedule_flow_timer
        install_core_flows(self.smm)
        self.notary_service = self._make_notary()
        self.rpc_ops = CordaRPCOps(self.services, self.smm)
        self._rpc_flows: dict[str, object] = {}
        # observable streaming (RPCServer.kt + RPCApi.kt:27-60): feed_id →
        # (client address, alive flag); per-client index for disconnect
        # cleanup — a client whose address stops accepting frames has every
        # feed dropped (the artemis binding-removal cleanup analog)
        self._feeds: dict[str, tuple[str, dict]] = {}
        self._client_feeds: dict[str, set] = {}
        self.messaging.on_send_failure = self._on_client_unreachable
        self.network_map_service = None
        self.network_map_client = None

    def _schedule_flow_timer(self, delay_s: float, fire) -> None:
        import threading
        t = threading.Timer(delay_s, lambda: self.executor.execute(fire))
        t.daemon = True
        t.start()

    # -- assembly ------------------------------------------------------------
    def _load_or_create_identity(self) -> KeyPair:
        if self.config.key_seed_hex:
            return generate_keypair(entropy=bytes.fromhex(self.config.key_seed_hex))
        key_file = os.path.join(self.config.base_directory, "identity.key")
        if os.path.exists(key_file):
            with open(key_file, "rb") as f:
                seed = f.read()
        else:
            seed = os.urandom(32)
            with open(key_file, "wb") as f:
                f.write(seed)
        return generate_keypair(entropy=seed)

    def _make_verifier(self):
        # mesh_devices/verifier_type consistency is enforced at
        # NodeConfiguration construction (__post_init__)
        from ..verifier.service import make_verifier_service
        metrics = self.services.monitoring
        if self.config.verifier_type == "OutOfProcess":
            from ..verifier.out_of_process import (
                OutOfProcessTransactionVerifierService)
            return OutOfProcessTransactionVerifierService(
                self.messaging, metrics=metrics,
                expected_workers=self.config.verifier_workers)
        kwargs = {"metrics": metrics}
        if self.config.verifier_type == "Tpu":
            device = self.services.device
            if self.config.mesh_devices is None:
                kwargs["device"] = device
            else:
                from ..parallel import make_mesh
                kwargs["mesh"] = (
                    make_mesh(self.config.mesh_devices)
                    if device.type == "cuda"
                    else make_mesh(devices=[device] * self.config.mesh_devices))
        return make_verifier_service(self.config.verifier_type, **kwargs)

    def _make_notary(self):
        if self.config.notary is None:
            return None
        cls = (SimpleNotaryService if self.config.notary == "simple"
               else ValidatingNotaryService)
        commit_log = FileUniquenessProvider(
            os.path.join(self.config.base_directory, "commit.log"))
        svc = cls(self.services, uniqueness=commit_log)
        svc.install(self.smm)
        return svc

    def _resolve_address(self, recipient: str):
        """Directory lookup; bare "host:port" strings resolve literally
        (RPC reply addresses)."""
        info = self.services.network_map_cache.get_node_by_legal_name(recipient)
        if info is not None:
            host, _, port = info.address.rpartition(":")
            return host, int(port)
        if ":" in recipient:
            host, _, port = recipient.rpartition(":")
            try:
                return host, int(port)
            except ValueError:
                return None
        return None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Node":
        self.messaging.add_message_handler(TopicSession(TOPIC_RPC),
                                           self._on_rpc)
        if self.config.network_map_name is None:
            # we ARE the network map node: serve the directory and publish our
            # own signed registration so peers learn our real identity key
            import time
            from ..network.netmap import ADD, make_registration
            self.network_map_service = NetworkMapService(
                self.messaging, local_cache=self.services.network_map_cache)
            self.network_map_service.apply_registration(make_registration(
                self.services, self.info, int(time.time() * 1000), ADD))
        else:
            if self.config.network_map_address is None:
                raise ValueError(
                    "network_map_name is set but network_map_address is not")
            # seed the directory with the map node so sends resolve pre-fetch
            map_host, _, map_port = self.config.network_map_address.rpartition(":")
            placeholder = NodeInfo(
                address=f"{map_host}:{map_port}",
                legal_identity=Party(self.config.network_map_name,
                                     _PLACEHOLDER_KEY))
            self.services.network_map_cache.add_node(placeholder)
            self.network_map_client = NetworkMapClient(
                self.services, str(placeholder.legal_identity.name))
            self.network_map_client.subscribe()
            self.network_map_client.register()
            self.network_map_client.fetch()
            # a restored flow may end its sessions at once, and a session's
            # peer resolves through the directory: restore checkpoints only
            # once the map has answered the fetch
            if (self.smm.checkpoints.get_all_checkpoints()
                    and not self.network_map_client.fetched.wait(
                        MAP_FETCH_WAIT_S)):
                log.warning("network map %s did not answer in %.0f s; "
                            "restoring checkpoints without its directory",
                            self.config.network_map_name, MAP_FETCH_WAIT_S)
        self.smm.start()
        log.info("node %s started on %s:%s", self.party.name,
                 self.config.host, self.messaging.port)
        return self

    def stop(self) -> None:
        self.smm.stop()
        self.messaging.stop()
        self.executor.shutdown()
        for store in (self.smm.checkpoints, self.services.storage):
            close = getattr(store, "close", None)
            if close is not None:
                close()

    # -- RPC server ----------------------------------------------------------
    def _on_rpc(self, msg) -> None:
        try:
            req: RpcRequest = deserialize(msg.data)
        except Exception:
            log.exception("malformed RPC request dropped")
            return
        try:
            result = self._dispatch_rpc(req)
            try:
                resp_bytes = serialize(
                    RpcResponse(req.request_id, result, None))
            except SerializationError as refused:
                # floats: a snapshot of rates and durations goes as JSON
                try:
                    text = json.dumps(result)
                except (TypeError, ValueError):
                    raise refused from None
                resp_bytes = serialize(
                    RpcResponse(req.request_id, JsonResult(text), None))
        except Exception as e:
            # serialization of the RESULT may fail too — the client must still
            # get a typed error instead of a silent timeout
            resp_bytes = serialize(
                RpcResponse(req.request_id, None, f"{type(e).__name__}: {e}"))
        self.messaging.send(TopicSession(TOPIC_RPC, 1), resp_bytes,
                            req.reply_to)

    # -- observable streaming ------------------------------------------------
    def _register_feed(self, feed, client_addr: str) -> FeedHandle:
        """Turn a DataFeed into a server-held subscription that pushes each
        observation to the client's address; the wire sees only the id +
        snapshot (the reference's observable-as-id serialization)."""
        feed_id = uuid.uuid4().hex
        alive = {"on": True}
        self._feeds[feed_id] = (client_addr, alive)
        self._client_feeds.setdefault(client_addr, set()).add(feed_id)

        def push(update):
            if not alive["on"]:
                return
            try:
                payload = serialize(Observation(feed_id, update))
            except Exception as e:
                try:
                    payload = serialize(Observation(
                        feed_id, ("error", f"unserializable update: {e}")))
                except Exception:
                    return
            self.messaging.send(TopicSession(TOPIC_RPC, 2), payload,
                                client_addr)

        feed.subscribe(push)
        return FeedHandle(feed_id, feed.snapshot)

    def _unsubscribe_feed(self, feed_id: str) -> None:
        entry = self._feeds.pop(feed_id, None)
        if entry is not None:
            client_addr, alive = entry
            alive["on"] = False
            self._client_feeds.get(client_addr, set()).discard(feed_id)

    def _on_client_unreachable(self, recipient: str) -> None:
        """Transport gave up on this address: drop all its feeds so dead
        clients do not leak subscriptions (disconnect cleanup), and error
        any flow session awaiting that peer (a parked flow must not wait
        forever on a dead counterparty)."""
        for feed_id in list(self._client_feeds.get(recipient, ())):
            self._unsubscribe_feed(feed_id)
        self._client_feeds.pop(recipient, None)
        self.smm.on_peer_unreachable(recipient)

    def _dispatch_rpc(self, req: RpcRequest):
        if req.method == "unsubscribe_feed":
            self._unsubscribe_feed(req.args[0])
            return None
        if req.method == "start_flow_tracked":
            flow_name, args = req.args[0], req.args[1:]
            fsm, feed = self.rpc_ops.start_tracked_flow_dynamic(
                flow_name, *args)
            self._rpc_flows[fsm.run_id] = fsm
            return self._register_feed(feed, req.reply_to)
        if req.method == "start_flow":
            flow_name, args = req.args[0], req.args[1:]
            fsm = self.rpc_ops.start_flow_dynamic(flow_name, *args)
            self._rpc_flows[fsm.run_id] = fsm
            return fsm.run_id
        if req.method == "flow_result":
            fsm = self._rpc_flows.get(req.args[0])
            if fsm is None:
                raise KeyError(f"unknown flow {req.args[0]}")
            if not fsm.result_future.done():
                return ["running", None]
            try:
                return ["done", fsm.result_future.result()]
            except Exception as e:
                return ["failed", f"{type(e).__name__}: {e}"]
        method = getattr(self.rpc_ops, req.method, None)
        if method is None or req.method.startswith("_"):
            raise AttributeError(f"no such RPC op: {req.method}")
        result = method(*req.args)
        from .rpc import DataFeed
        if isinstance(result, DataFeed):
            # feeds cross the wire as id + snapshot; observations are pushed
            return self._register_feed(result, req.reply_to)
        return result


_PLACEHOLDER_KEY = generate_keypair(entropy=b"\x00" * 32).public
