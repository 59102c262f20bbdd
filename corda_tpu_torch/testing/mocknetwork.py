"""MockNetwork: N in-process nodes over the deterministic in-memory bus.

Reference parity: MockNetwork/MockNode (test-utils/.../node/MockNode.kt:41-66)
— nodes share one InMemoryMessagingNetwork; `run_network()` pumps messages
manually so protocol interleavings are reproducible single-threaded.

``MockNetwork(device=...)`` (default "cuda", which raises without CUDA)
hands its device to every node's ServiceHub: the device the nodes' own
device work runs on (the SIMM margin, the rates oracle's bulk tear-off
check). Nodes keep ``verifier_service = None`` (flows verify in-flow on the
host) until a caller installs a verifier service on them.
"""
from __future__ import annotations

from ..core.crypto.keys import KeyPair, generate_keypair
from ..core.identity import Party
from ..device import DEFAULT_DEVICE, resolve_device
from ..network.inmemory import InMemoryMessagingNetwork
from ..node.checkpoints import CheckpointStorage
from ..node.services import NodeInfo, ServiceHub, ServiceInfo
from ..node.statemachine import StateMachineManager


class TestClock:
    """Deterministic flow-timer clock (reference TestClock semantics): flows
    sleeping or receiving-with-timeout wake only when a test advances it
    (MockNetwork.advance_clock)."""

    def __init__(self, start: float = 1_000_000.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        self._now += seconds


class MockNode:
    def __init__(self, mock_net: "MockNetwork", name: str, key_pair: KeyPair,
                 advertised_services: tuple[ServiceInfo, ...] = (),
                 checkpoint_storage: CheckpointStorage | None = None,
                 messaging=None, storage=None):
        self.mock_net = mock_net
        self.key_pair = key_pair
        self.messaging = messaging if messaging is not None \
            else mock_net.bus.create_node(name)
        self.info = NodeInfo(address=name,
                             legal_identity=Party(name, key_pair.public),
                             advertised_services=tuple(advertised_services))
        self.services = ServiceHub(self.info, self.messaging,
                                   key_pairs=[key_pair],
                                   device=mock_net.device)
        if storage is not None:
            # restart path: the transaction DB survives; rebuild the vault's
            # in-memory view from it (the persistent-vault analog)
            self.services.storage = storage
            self.services.vault.notify_all(storage.transactions)
        self.smm = StateMachineManager(self.services, checkpoint_storage)
        self.smm.clock = mock_net.clock.now   # flow timers on the test clock
        self.services.smm = self.smm
        self.notary_service = None
        from ..flows.library import install_core_flows
        install_core_flows(self.smm)

    def install_notary(self, notary_service_cls, **kwargs) -> None:
        """Install a NotaryService (SimpleNotaryService/ValidatingNotaryService)."""
        self.notary_service = notary_service_cls(self.services, **kwargs)
        self.notary_service.install(self.smm)

    def start(self) -> None:
        self.smm.start()

    def start_flow(self, flow):
        return self.smm.add(flow)

    @property
    def party(self) -> Party:
        return self.info.legal_identity

    def stop(self) -> None:
        """Simulate node death: drop off the bus handlers (checkpoints stay)."""
        self.smm.stop()
        self.smm.flows.clear()

    def restart(self) -> "MockNode":
        """Simulate restart-with-checkpoints: a fresh node reusing this node's
        checkpoint storage, transaction DB, bus endpoint and identity
        (TwoPartyTradeFlowTests mid-flow-restart analog). Core flows are
        reinstalled and an installed notary service is re-installed, exactly
        as a real node boot would (AbstractNode.start)."""
        self.stop()
        node = MockNode(self.mock_net, str(self.info.legal_identity.name),
                        self.key_pair,
                        advertised_services=self.info.advertised_services,
                        checkpoint_storage=self.smm.checkpoints,
                        messaging=self.messaging,
                        storage=self.services.storage)
        if self.notary_service is not None:
            node.install_notary(type(self.notary_service),
                                uniqueness=self.notary_service.uniqueness)
        self.mock_net.nodes[self.mock_net.nodes.index(self)] = node
        for other in self.mock_net.nodes:
            node.services.network_map_cache.add_node(other.info)
        return node


class MockNetwork:
    def __init__(self, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.bus = InMemoryMessagingNetwork()
        self.nodes: list[MockNode] = []
        self._counter = 0
        self.clock = TestClock()

    def advance_clock(self, seconds: float) -> int:
        """Advance the shared test clock, fire every due flow timer, then
        pump the network to quiescence. Returns fired timer count."""
        self.clock.advance(seconds)
        fired = sum(n.smm.wake_timers() for n in self.nodes)
        self.run_network()
        return fired

    def create_node(self, name: str | None = None,
                    advertised_services: tuple[ServiceInfo, ...] = (),
                    key_pair: KeyPair | None = None,
                    checkpoint_storage: CheckpointStorage | None = None
                    ) -> MockNode:
        self._counter += 1
        if name is None:
            name = f"O=Mock Company {self._counter}, L=London, C=GB"
        if key_pair is None:
            key_pair = generate_keypair(
                entropy=self._counter.to_bytes(32, "big"))
        node = MockNode(self, name, key_pair, advertised_services,
                        checkpoint_storage)
        self.nodes.append(node)
        # full-mesh directory (the network-map push analog for tests)
        for a in self.nodes:
            for b in self.nodes:
                a.services.network_map_cache.add_node(b.info)
        return node

    def create_notary_node(self, name: str | None = None, validating: bool = False,
                           **kwargs) -> MockNode:
        from ..node.notary import SimpleNotaryService, ValidatingNotaryService
        from ..node.services import ServiceInfo
        cls = ValidatingNotaryService if validating else SimpleNotaryService
        node = self.create_node(
            name or "O=Notary Service, L=Zurich, C=CH",
            advertised_services=(ServiceInfo(cls.type_id),), **kwargs)
        node.install_notary(cls)
        return node

    def start_nodes(self) -> None:
        for node in self.nodes:
            node.start()

    def run_network(self, rounds: int = -1, exclude=(),
                    idle_timeout: float = 120.0) -> int:
        """Pump until quiescent. Beyond message delivery, this also drains
        each node's async verify completions (the Verify suspension point:
        device/pool futures resolve on foreign threads and re-enter the flow
        on this driving thread via smm.drain_external), waiting — bounded by
        ``idle_timeout`` — while any flow is parked on such a future.
        The default is generous because a parked flow's batch may be paying
        a first kernel build (seconds on the card's machine) or a batch of
        the plain kernels on the CPU (seconds each) — that is progress the
        driving thread cannot see."""
        total = self.bus.run_network(rounds, exclude=exclude)
        if rounds != -1:
            return total
        import time as _time
        excluded = set(exclude)
        deadline = _time.monotonic() + idle_timeout
        while True:
            live = [n for n in self.nodes
                    if str(n.info.address) not in excluded]
            drained = False
            for n in live:
                drained |= n.smm.drain_external()
            pumped = self.bus.run_network(-1, exclude=exclude)
            total += pumped
            if drained or pumped:
                deadline = _time.monotonic() + idle_timeout
                continue
            if not any(n.smm.awaiting_external for n in live):
                return total
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    "flows awaiting async verification made no progress "
                    f"for {idle_timeout}s")
            _time.sleep(0.002)
