"""CordaRPCClient — connect to a node's RPC surface over the TCP plane.

Reference parity: client/rpc CordaRPCClient → proxy of CordaRPCOps
(RPCClient.kt / RPCClientProxyHandler.kt): the client opens its own transport
endpoint, sends framed requests carrying a reply address, correlates
responses by request id, and surfaces server-side exceptions.

Observable streaming (RPCClientProxyHandler.kt:1-421 / RPCApi.kt:27-60):
a server method returning a feed comes back as a FeedHandle (server-assigned
feed id + snapshot); subsequent observations are PUSHED to this client's
address and demuxed by id into ``ClientDataFeed`` callbacks/queues — no
polling. ``start_flow_and_wait`` rides a tracked-flow feed: progress steps
and the terminal result arrive as pushes.

A copy of the reference's module, but for results the codec cannot carry
(floats: metric and profiler snapshots, the /debug reports): the port's node
sends them as JSON text (``node.node.JsonResult``), which ``call`` parses, so
a NodeWebServer over this client serves ``/metrics`` and ``/debug/*``.
"""
from __future__ import annotations

import json
import queue as _queue
import threading
import time
import uuid

from ..core.serialization import deserialize, serialize
from ..network.messaging import TopicSession
from ..network.tcp import TcpMessagingService
from ..node.node import (TOPIC_RPC, FeedHandle, JsonResult, Observation,
                         RpcRequest, RpcResponse)


class RPCException(Exception):
    pass


class FlowFailedException(RPCException):
    pass


class ClientDataFeed:
    """Client half of a streamed feed: snapshot + pushed observations
    (demuxed by the server-assigned feed id)."""

    def __init__(self, client: "CordaRPCClient", feed_id: str, snapshot):
        self._client = client
        self.feed_id = feed_id
        self.snapshot = snapshot
        self.events: "_queue.Queue" = _queue.Queue()
        self._callbacks: list = []

    def subscribe(self, callback) -> None:
        self._callbacks.append(callback)

    def next_event(self, timeout_s: float = 30.0):
        """Block for the next pushed observation."""
        try:
            return self.events.get(timeout=timeout_s)
        except _queue.Empty:
            raise RPCException(
                f"no observation on feed {self.feed_id} in {timeout_s}s")

    def _on_observation(self, payload) -> None:
        self.events.put(payload)
        for cb in list(self._callbacks):
            try:
                cb(payload)
            except Exception:
                pass

    def close(self) -> None:
        self._client._close_feed(self)


class CordaRPCClient:
    def __init__(self, host: str, port: int, client_host: str = "127.0.0.1",
                 timeout_s: float = 30.0, tls_ca_directory: str | None = None):
        """``tls_ca_directory``: enable mutual TLS against a node whose plane
        runs the dev CA in that directory (the client auto-provisions its own
        CA-signed certificate there, like any other peer)."""
        self.node_addr = (host, port)
        self.timeout_s = timeout_s
        self._pending: dict[str, object] = {}
        self._cond = threading.Condition()
        name = f"rpc-client-{uuid.uuid4().hex[:8]}"
        tls = None
        if tls_ca_directory is not None:
            import tempfile
            from ..network.tls import TlsConfig
            tls = TlsConfig.dev(tempfile.mkdtemp(prefix="rpc-tls-"), name,
                                tls_ca_directory)
        self._messaging = TcpMessagingService(
            name, client_host, 0, lambda name: self.node_addr, tls=tls)
        self._messaging.add_message_handler(TopicSession(TOPIC_RPC, 1),
                                            self._on_response)
        self._feeds: dict[str, ClientDataFeed] = {}
        self._orphan_observations: dict[str, list] = {}
        self._messaging.add_message_handler(TopicSession(TOPIC_RPC, 2),
                                            self._on_observation)
        self.reply_to = f"{client_host}:{self._messaging.port}"

    # -- plumbing ------------------------------------------------------------
    def _on_response(self, msg) -> None:
        resp: RpcResponse = deserialize(msg.data)
        with self._cond:
            self._pending[resp.request_id] = resp
            self._cond.notify_all()

    def _on_observation(self, msg) -> None:
        obs: Observation = deserialize(msg.data)
        with self._cond:
            feed = self._feeds.get(obs.feed_id)
            if feed is None or obs.feed_id in self._orphan_observations:
                # observation raced ahead of the FeedHandle response (or a
                # replay of earlier parked observations is still running) —
                # park it so delivery order matches push order
                self._orphan_observations.setdefault(
                    obs.feed_id, []).append(obs.payload)
                return
        feed._on_observation(obs.payload)

    def call(self, method: str, *args):
        rid = uuid.uuid4().hex
        req = RpcRequest(rid, method, list(args), self.reply_to)
        self._messaging.send(TopicSession(TOPIC_RPC), serialize(req), "node")
        deadline = time.monotonic() + self.timeout_s
        with self._cond:
            while rid not in self._pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RPCException(f"RPC {method} timed out")
                self._cond.wait(timeout=remaining)
            resp = self._pending.pop(rid)
        if resp.error is not None:
            raise RPCException(resp.error)
        if isinstance(resp.result, JsonResult):
            return json.loads(resp.result.text)
        if isinstance(resp.result, FeedHandle):
            feed = ClientDataFeed(self, resp.result.feed_id,
                                  resp.result.snapshot)
            with self._cond:
                self._feeds[feed.feed_id] = feed
                had_orphans = feed.feed_id in self._orphan_observations
            # replay parked observations IN ORDER: new pushes keep parking
            # behind them (see _on_observation) until the list drains empty
            while had_orphans:
                with self._cond:
                    parked = self._orphan_observations.get(feed.feed_id, [])
                    if not parked:
                        self._orphan_observations.pop(feed.feed_id, None)
                        break
                    payload = parked.pop(0)
                feed._on_observation(payload)
            return feed
        return resp.result

    def _close_feed(self, feed: ClientDataFeed) -> None:
        self._feeds.pop(feed.feed_id, None)
        try:
            self.call("unsubscribe_feed", feed.feed_id)
        except RPCException:
            pass

    # -- the proxy surface ---------------------------------------------------
    def start_flow(self, flow_name: str, *args) -> str:
        return self.call("start_flow", flow_name, *args)

    def flow_result(self, run_id: str):
        return self.call("flow_result", run_id)

    def start_tracked_flow(self, flow_name: str, *args) -> ClientDataFeed:
        """startTrackedFlowDynamic: the returned feed's snapshot is the run
        id; pushed events are ("progress", step) and the terminal
        ("removed", [status, value])."""
        return self.call("start_flow_tracked", flow_name, *args)

    def start_flow_and_wait(self, flow_name: str, *args,
                            timeout_s: float = 60.0, poll_s: float = 0.2):
        """Start a flow and wait for its result — PUSHED over the tracked
        feed (no polling); falls back to result polling against servers
        without the streaming protocol."""
        try:
            feed = self.start_tracked_flow(flow_name, *args)
        except RPCException:
            feed = None
        if isinstance(feed, ClientDataFeed):
            deadline = time.monotonic() + timeout_s
            try:
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise RPCException(
                            f"flow {feed.snapshot} did not finish in "
                            f"{timeout_s}s")
                    event = feed.next_event(timeout_s=remaining)
                    if event[0] == "removed":
                        status, value = event[1]
                        if status == "failed":
                            raise FlowFailedException(value)
                        return value
            finally:
                feed.close()
        run_id = self.start_flow(flow_name, *args)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status, value = self.flow_result(run_id)
            if status == "done":
                return value
            if status == "failed":
                raise FlowFailedException(value)
            time.sleep(poll_s)
        raise RPCException(f"flow {run_id} did not finish in {timeout_s}s")

    def wait_until_registered_with_network_map(self,
                                               timeout_s: float = 60.0):
        """Genuine FUTURE semantics (CordaRPCOps.kt:275 returns a
        ListenableFuture): completes when the node reports itself
        registered, with the initial probe short-circuiting an
        already-registered node. Network-map pushes ACCELERATE a dedicated
        waiter thread, which does all the re-probing itself: an RPC from
        inside the feed callback would deadlock (callbacks run on the one
        messaging thread that also delivers RPC responses), and the single
        setter thread means no missed-event or set_result races."""
        from concurrent.futures import Future as _Future
        fut: _Future = _Future()
        if self.call("wait_until_registered_with_network_map"):
            fut.set_result(True)
            return fut
        feed = self.network_map_feed()
        kick = threading.Event()
        feed.subscribe(lambda _event: kick.set())

        def waiter():
            deadline = time.monotonic() + timeout_s
            try:
                while True:
                    if self.call("wait_until_registered_with_network_map"):
                        fut.set_result(True)
                        return
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        fut.set_exception(RPCException(
                            "not registered with the network map in "
                            f"{timeout_s}s"))
                        return
                    # push-accelerated, 1s-bounded poll: a change pushed
                    # BEFORE the subscription landed is still caught
                    kick.wait(timeout=min(remaining, 1.0))
                    kick.clear()
            finally:
                try:
                    feed.close()
                except Exception:
                    pass
        threading.Thread(target=waiter, daemon=True,
                         name="rpc-registration-wait").start()
        return fut

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *args: self.call(name, *args)

    def close(self) -> None:
        for feed in list(self._feeds.values()):
            try:
                feed.close()
            except Exception:
                pass
        self._messaging.stop()
