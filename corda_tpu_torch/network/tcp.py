"""TCP messaging plane — the production DCN transport between node hosts.

Reference parity: the Artemis broker + TCP transport role
(ArtemisMessagingServer.kt:88 + ArtemisTcpTransport) re-designed for the
node-host topology: each node listens on one TCP port; peers connect lazily
and frames carry (topic, session, sender, payload). Handlers dispatch onto
the node's SerialExecutor (the single node-thread discipline,
AffinityExecutor parity) so the state machine never sees concurrent calls.

Wire frame: 4-byte big-endian length + canonical-codec bytes of
[topic, session_id, sender_name, payload] with an OPTIONAL fifth element
[trace_id, span_id] when the sender propagates a trace context
(observability.tracing) — absent on untraced sends, and old four-element
frames still decode, so mixed-version planes interoperate. Undeliverable
messages are parked
and replayed on handler registration (NodeMessagingClient retention), and
sends to unreachable peers are retried with a delay
(messageRedeliveryDelaySeconds analog).

Security: pass a ``network.tls.TlsConfig`` to run the plane over mutual TLS —
both sides must present certificates chained to the shared CA
(ArtemisTcpTransport parity). Backpressure: per-peer outbound queues are
bounded; when a peer falls MAX_PENDING_FRAMES behind, the *sending* thread
blocks (the broker-producer-blocking semantics) until space frees or the
overflow timeout trips, at which point the frame is dropped with an error.
"""
from __future__ import annotations

import asyncio
import logging
import threading
from typing import Callable

from ..core.serialization import deserialize, serialize
from ..utils import retry
from ..utils.affinity import SerialExecutor
from ..utils.faults import DROP, DUPLICATE, fault_point
from .messaging import (HandlerTable, Message, MessagingService,
                        MessageHandlerRegistration, TopicSession)

log = logging.getLogger(__name__)

#: Default max wire frame (message/attachment cap) — reference parity with
#: Artemis' 10 MiB maxMessageSize (ArtemisMessagingServer.kt:95).
MAX_FRAME = 10 * 1024 * 1024
REDELIVERY_DELAY_S = 0.5


class MessageSizeExceededError(ValueError):
    """A frame exceeded the plane's max_frame cap. Raised synchronously to
    LOCAL senders; an oversized INBOUND length header closes the connection
    (the length cannot be trusted, so the stream is unrecoverable)."""


class MessagingStartupError(RuntimeError):
    """The messaging plane's listener failed to come up (port already
    bound, bad TLS material, loop thread wedged). Raised from the
    CONSTRUCTOR so a node never runs on a half-started transport; the
    underlying OS error rides ``__cause__``."""


MAX_SEND_ATTEMPTS = 10
MAX_PENDING_FRAMES = 10_000       # per-peer outbound bound (backpressure)
BACKPRESSURE_TIMEOUT_S = 30.0


class TcpMessagingService(MessagingService):
    """One node's transport endpoint: a TCP server + lazy client connections.

    ``resolve_address(name) -> (host, port) | None`` supplies the directory
    (fed by the network map cache). All sends/receives run on a private
    asyncio loop thread; inbound handler callbacks run on ``executor``.
    """

    supports_trace = True

    def __init__(self, my_name: str, host: str, port: int,
                 resolve_address: Callable[[str], tuple | None],
                 executor: SerialExecutor | None = None, tls=None,
                 max_frame: int = MAX_FRAME):
        self._name = my_name
        self.host = host
        self.port = port
        self.max_frame = max_frame
        self.tls = tls                      # network.tls.TlsConfig | None
        self.resolve_address = resolve_address
        self.executor = executor if executor is not None else SerialExecutor(
            f"node-thread({my_name})")
        self._handlers = HandlerTable()
        self._undelivered: list[Message] = []
        # called (on executor) with the recipient name after a send is
        # abandoned — lets the RPC server drop dead clients' subscriptions
        self.on_send_failure: Callable[[str], None] | None = None
        self._writers: dict[str, asyncio.StreamWriter] = {}
        self._inbound: set[asyncio.StreamWriter] = set()
        self._send_queues: dict[str, "asyncio.Queue"] = {}
        self._sender_tasks: dict[str, "asyncio.Task"] = {}
        self._stopping = False
        self._loop = asyncio.new_event_loop()
        self._server = None
        self._started = threading.Event()
        self._startup_error: BaseException | None = None
        self._thread = threading.Thread(target=self._run_loop, daemon=True,
                                        name=f"tcp-messaging({my_name})")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise MessagingStartupError(
                f"messaging plane for {my_name} did not start within 10s")
        if self._startup_error is not None:
            raise MessagingStartupError(
                f"messaging plane for {my_name} failed to bind "
                f"{host}:{port}: {self._startup_error}"
            ) from self._startup_error

    # -- loop plumbing -------------------------------------------------------
    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._start_server())
        except BaseException as e:
            # a bind/TLS failure must reach the constructor, not die in a
            # daemon thread with the caller holding a zombie service
            self._startup_error = e
            self._started.set()
            return
        self._started.set()
        self._loop.run_forever()

    async def _start_server(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port,
            ssl=self.tls.server_ctx if self.tls is not None else None)
        if self.port == 0:  # ephemeral: learn the kernel-assigned port
            self.port = self._server.sockets[0].getsockname()[1]

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        # under mTLS the authenticated identity is the peer certificate's CN
        # — it overrides whatever sender the frame body claims, so consumers
        # of Message.sender (e.g. BFT state-transfer vote tallies) see a
        # transport-authenticated name, not an attacker-chosen string
        self._inbound.add(writer)   # closed on stop() so peers see EOF
        cert_cn = None
        if self.tls is not None:
            from .tls import peer_common_name
            cert_cn = peer_common_name(writer.get_extra_info("ssl_object"))
            if cert_cn is None:
                # a verified cert without a CN (e.g. SAN-only) must not
                # silently downgrade to the frame's self-declared sender —
                # the transport-authenticated identity is what BFT
                # state-transfer tallies trust (ADVICE r2). Refuse the
                # connection instead of falling back.
                log.warning("TLS peer certificate has no CN; closing")
                writer.close()
                return
        try:
            while True:
                header = await reader.readexactly(4)
                length = int.from_bytes(header, "big")
                if length > self.max_frame:
                    # a hostile/buggy peer: one giant length header must not
                    # make this node buffer unbounded bytes — drop the
                    # connection (the Artemis max-message-size refusal)
                    log.warning(
                        "closing connection from %s: frame of %d bytes "
                        "exceeds max_frame=%d",
                        cert_cn or writer.get_extra_info("peername"),
                        length, self.max_frame)
                    raise MessageSizeExceededError(
                        f"inbound frame too large: {length}")
                body = await reader.readexactly(length)
                topic, session_id, sender, payload, *rest = deserialize(body)
                trace = tuple(rest[0]) if rest and rest[0] else None
                msg = Message(TopicSession(topic, session_id), payload,
                              sender=cert_cn if cert_cn is not None
                              else sender, trace=trace)
                self.executor.execute(lambda m=msg: self._deliver(m))
        except (asyncio.IncompleteReadError, ConnectionResetError,
                MessageSizeExceededError):
            pass
        finally:
            self._inbound.discard(writer)
            writer.close()

    # -- inbound dispatch ----------------------------------------------------
    def _deliver(self, msg: Message) -> None:
        handlers = self._handlers.matching(msg)
        if not handlers:
            self._undelivered.append(msg)
            return
        for h in handlers:
            try:
                h.callback(msg)
            except Exception:
                log.exception("message handler failed for %s", msg.topic_session)

    # -- MessagingService ----------------------------------------------------
    @property
    def my_address(self) -> str:
        return self._name

    def send(self, topic_session: TopicSession, payload: bytes,
             recipient: str, trace: tuple | None = None) -> None:
        body = [topic_session.topic, topic_session.session_id,
                self._name, payload]
        if trace is not None:
            body.append(list(trace))
        frame_body = serialize(body)
        if len(frame_body) > self.max_frame:
            # fail the producer synchronously with a typed error: a peer
            # would just sever the connection on the oversized header
            raise MessageSizeExceededError(
                f"outbound frame of {len(frame_body)} bytes exceeds "
                f"max_frame={self.max_frame} (10MiB Artemis parity cap)")
        frame = len(frame_body).to_bytes(4, "big") + frame_body
        fut = asyncio.run_coroutine_threadsafe(
            self._enqueue_send(recipient, frame), self._loop)
        try:
            # backpressure: a full per-peer queue blocks the producer here
            fut.result(timeout=BACKPRESSURE_TIMEOUT_S)
        except TimeoutError:
            fut.cancel()
            log.error("dropping frame to %s: outbound queue full for %.0fs",
                      recipient, BACKPRESSURE_TIMEOUT_S)

    async def _enqueue_send(self, recipient: str, frame: bytes) -> None:
        """One *bounded* outbound queue + sender task per recipient: frames
        to a peer stay ordered (the per-peer broker queue semantics), exactly
        one connection per peer exists, and a slow peer eventually blocks its
        producers instead of growing memory without bound."""
        if self._stopping:   # a send racing stop() must not respawn senders
            return
        q = self._send_queues.get(recipient)
        if q is None:
            q = self._send_queues[recipient] = asyncio.Queue(
                maxsize=MAX_PENDING_FRAMES)
            self._sender_tasks[recipient] = self._loop.create_task(
                self._sender(recipient, q))
        await q.put(frame)

    async def _sender(self, recipient: str, q: "asyncio.Queue") -> None:
        policy = retry.RetryPolicy(base_s=0.05, cap_s=REDELIVERY_DELAY_S,
                                   max_attempts=MAX_SEND_ATTEMPTS)
        retry_meter = retry.registry().meter("Retry.Attempts.tcp.send")
        retry_total = retry.registry().get_metric("Retry.Attempts")
        while True:
            frame = await q.get()
            # fresh decorrelated-jitter schedule per frame: retries back off
            # growing-and-jittered instead of in REDELIVERY_DELAY_S lockstep
            backoff = retry.delays(policy)
            for attempt in range(MAX_SEND_ATTEMPTS):
                try:
                    act = fault_point("tcp.send",
                                      detail=f"{self._name}->{recipient}")
                    if act == DROP:
                        break            # injected network loss: frame gone
                    writer = await self._writer_for(recipient)
                    writer.write(frame)
                    if act == DUPLICATE:
                        writer.write(frame)
                    await writer.drain()
                    break
                except (OSError, ConnectionError, LookupError) as e:
                    self._writers.pop(recipient, None)
                    if attempt == MAX_SEND_ATTEMPTS - 1:
                        log.error("giving up sending to %s: %s", recipient, e)
                        hook = self.on_send_failure
                        if hook is not None:
                            self.executor.execute(lambda: hook(recipient))
                        break
                    retry_meter.mark()
                    retry_total.mark()
                    await asyncio.sleep(next(backoff))

    async def _writer_for(self, recipient: str) -> asyncio.StreamWriter:
        writer = self._writers.get(recipient)
        if writer is not None and not writer.is_closing():
            return writer
        addr = self.resolve_address(recipient)
        if addr is None:
            raise LookupError(f"no address known for {recipient!r}")
        fault_point("tcp.connect", detail=f"{self._name}->{recipient}")
        host, port = addr
        reader, writer = await asyncio.open_connection(
            host, port, ssl=self.tls.client_ctx if self.tls is not None else None)
        self._writers[recipient] = writer
        # outbound connections are write-only in this protocol, so a read
        # completing means the peer closed; writes into a half-closed socket
        # "succeed" into the kernel buffer, which would leave dead peers
        # (e.g. crashed RPC clients holding feed subscriptions) undetected
        self._loop.create_task(
            self._watch_connection(recipient, reader, writer))
        return writer

    async def _watch_connection(self, recipient: str,
                                reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        try:
            await reader.read()          # EOF or reset = peer gone
        except Exception:
            pass
        if self._stopping:
            return
        # retire OUR writer only — the send retry loop may have already
        # replaced it with a fresh healthy connection — and close it so the
        # EOF'd socket doesn't linger in CLOSE_WAIT
        if self._writers.get(recipient) is writer:
            self._writers.pop(recipient, None)
        writer.close()
        # liveness probe: a transient drop reconnects; refusal means the
        # peer process is dead → surface to on_send_failure (feed cleanup).
        # Probed a few times with decorrelated-jitter backoff so a peer
        # mid-restart is not declared dead on its first refused dial.
        policy = retry.RetryPolicy(base_s=0.1, cap_s=0.4, max_attempts=3)
        backoff = retry.delays(policy)
        probe_meter = retry.registry().meter("Retry.Attempts.tcp.probe")
        probe_failed = True
        for _ in range(policy.max_attempts):
            await asyncio.sleep(next(backoff))
            addr = self.resolve_address(recipient)
            if addr is None:
                continue
            try:
                _, probe = await asyncio.open_connection(
                    addr[0], addr[1],
                    ssl=self.tls.client_ctx if self.tls is not None else None)
                probe.close()
                probe_failed = False
                break
            except Exception:
                probe_meter.mark()
                retry.registry().get_metric("Retry.Attempts").mark()
        if probe_failed:
            log.info("peer %s disconnected and is unreachable", recipient)
            hook = self.on_send_failure
            if hook is not None:
                self.executor.execute(lambda: hook(recipient))

    def add_message_handler(self, topic_session: TopicSession, callback
                            ) -> MessageHandlerRegistration:
        reg = self._handlers.add(topic_session, callback)

        def replay():
            still = []
            for msg in self._undelivered:
                if (msg.topic_session.topic == topic_session.topic and
                        msg.topic_session.session_id == topic_session.session_id):
                    callback(msg)
                else:
                    still.append(msg)
            self._undelivered[:] = still

        self.executor.execute(replay)
        return reg

    def remove_message_handler(self, reg: MessageHandlerRegistration) -> None:
        self._handlers.remove(reg)

    def stop(self) -> None:
        async def _shutdown():
            self._stopping = True   # set on the loop: gates _enqueue_send
            tasks = list(self._sender_tasks.values())
            for task in tasks:
                task.cancel()
            # await the cancellations so the loop retires them cleanly
            await asyncio.gather(*tasks, return_exceptions=True)
            # close inbound connections too: a stopped endpoint must look
            # DEAD to its peers (EOF fires their connection watchers), not
            # like a zombie holding sockets open. The close must FLUSH (FIN
            # actually sent) before the loop stops, hence wait_closed.
            closing = list(self._writers.values()) + list(self._inbound)
            for w in closing:
                w.close()
            await asyncio.wait_for(
                asyncio.gather(*(w.wait_closed() for w in closing),
                               return_exceptions=True), timeout=2.0)
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        asyncio.run_coroutine_threadsafe(_shutdown(), self._loop)
        self._thread.join(timeout=5)
