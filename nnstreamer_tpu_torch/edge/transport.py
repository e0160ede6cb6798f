"""Edge transports: in-process (by reference), TCP (wire-serialized) and
MQTT-hybrid (broker discovery, TCP data).

Counterpart of the JAX package's ``edge/transport.py``, with its three
connect types.  Parity target: the nnstreamer-edge
communication library the reference's L5 layer consumes
(``nns_edge_create_handle/start/send/event_cb``).

- ``inproc`` — client and server pipelines share the process: envelopes
  carry :class:`~nnstreamer_tpu_torch.core.Buffer` objects *by
  reference*, so card tensors never leave the card and offloading a
  stage costs a queue hop, not a serialize/deserialize round trip.
- ``tcp`` — cross-process and cross-host: envelopes serialize through
  :mod:`nnstreamer_tpu_torch.edge.wire` (MetaInfo-headed payloads) over a
  length-prefixed socket stream.  The same element graph works unchanged.
  Two endpoints of one process that pass the device-channel handshake
  (:mod:`.devicechannel`) keep card frames on the card and send only
  control frames.

- ``hybrid`` — broker-mediated discovery + TCP data (the reference's
  MQTT-hybrid): ``host:port`` addresses an MQTT broker where the server
  advertises its TCP data address under ``topic`` as a retained
  message; reconnecting clients re-query the broker, so a server that
  moved is found again mid-stream.

All present the same two interfaces: :class:`ServerTransport`
(accept + per-client send + topic publish) and :class:`ClientConn`
(send + blocking receive + caps query).  Every framed message passes the
process-wide fault plan's wire seam (``chaos/plan.py``) in both
directions and counts into the link's ``LinkMetrics``; the threads are
named through ``obs/prof.py``.
"""

from __future__ import annotations

import dataclasses
import queue
import socket
import struct
import threading
import time
import uuid
from typing import Callable, Dict, Optional, Tuple

from ..chaos import hooks as _chaos
from ..chaos.plan import apply_wire_op as _apply_wire_op
from ..core import Buffer
from ..utils.log import logd, logw
from . import devicechannel as _devch
from .wire import (
    EdgeMessage,
    MSG_CAPS_REQ,
    MSG_CAPS_RES,
    MSG_DEVCH_REQ,
    MSG_DEVCH_RES,
    MSG_SUBSCRIBE,
)


@dataclasses.dataclass
class Envelope:
    """Transport-neutral message: what the elements see.  ``buffer`` is
    by-reference for inproc and (de)serialized at the socket boundary for
    tcp.  ``trace`` is an optional trace context
    (:mod:`nnstreamer_tpu_torch.obs.tracectx`) riding the frame's
    extension area over the wire."""

    mtype: int
    client_id: int = 0
    seq: int = 0
    info: str = ""
    buffer: Optional[Buffer] = None
    trace: Optional[dict] = None


def _to_wire(env: Envelope, devch: bool = False,
             chan: object = "") -> bytes:
    if devch and env.buffer is not None and _devch.eligible(env.buffer):
        # device-channel fast path (edge/devicechannel.py): the frame's
        # tensors stay on the card, parked under a slot id scoped to this
        # connection's channel; only this control frame — descriptor,
        # routing, trace — rides the socket
        msg = EdgeMessage(mtype=env.mtype, client_id=env.client_id,
                          seq=env.seq, pts=env.buffer.pts, info=env.info)
        msg.devch = _devch.deposit_buffer(env.buffer, chan=chan)
    elif env.buffer is not None:
        msg = EdgeMessage.from_buffer(env.mtype, env.buffer,
                                      client_id=env.client_id, seq=env.seq,
                                      info=env.info)
    else:
        msg = EdgeMessage(mtype=env.mtype, client_id=env.client_id,
                          seq=env.seq, info=env.info)
    msg.trace = env.trace
    return msg.pack()


def _from_wire(data: bytes) -> Envelope:
    msg = EdgeMessage.unpack(data)
    if msg.devch is not None and not msg.payloads:
        # control-only frame: redeem the parked device-resident buffer
        # (None — surfaced upstream as a drop/timeout — when the slot
        # was evicted or the sender's device world is foreign)
        buf = _devch.take_buffer(msg.devch)
        if buf is not None:
            buf.meta["client_id"] = msg.client_id
            buf.meta["query_seq"] = msg.seq
    else:
        buf = msg.to_buffer() if msg.payloads else None
    return Envelope(mtype=msg.mtype, client_id=msg.client_id, seq=msg.seq,
                    info=msg.info, buffer=buf, trace=msg.trace)


# -- server side --------------------------------------------------------------


class ServerTransport:
    """Interface: accept clients, deliver inbound envelopes to
    ``on_message(client_id, env)``, send/publish outbound ones.

    ``metrics`` (an :class:`~nnstreamer_tpu_torch.obs.metrics.LinkMetrics`, or
    None) receives per-frame tx/rx byte counts from transports that
    actually frame bytes; owning elements assign it after construction."""

    def __init__(self):
        self.on_message: Optional[Callable[[int, Envelope], None]] = None
        self.caps_provider: Optional[Callable[[], str]] = None
        self.metrics = None
        # clients that proved (MSG_DEVCH_REQ handshake) they share this
        # process's device world: frames to them may ride the device
        # channel (control metadata only on the socket)
        self._devch_clients: set = set()

    def devch_capable(self, client_id: int) -> bool:
        return client_id in self._devch_clients

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def send(self, client_id: int, env: Envelope) -> bool:
        raise NotImplementedError

    def publish(self, env: Envelope) -> int:
        """Send to every subscriber whose topic matches ``env.info``
        (empty subscription = all topics).  Returns receiver count."""
        raise NotImplementedError

    # shared control-message handling
    def _dispatch(self, client_id: int, env: Envelope,
                  subscribe_cb: Callable[[int, str], None]) -> None:
        if env.mtype == MSG_CAPS_REQ:
            caps = self.caps_provider() if self.caps_provider else ""
            self.send(client_id, Envelope(
                MSG_CAPS_RES, client_id=client_id, seq=env.seq, info=caps))
        elif env.mtype == MSG_DEVCH_REQ:
            # device-channel handshake: ``info`` is the client's device
            # fingerprint — grant the fast path only on an exact match
            # with ours (same process, same card world); the reply tells the
            # client whether ITS sends may ride the channel too
            ok = _devch.handshake_ok(env.info)
            if ok:
                self._devch_clients.add(client_id)
            else:
                self._devch_clients.discard(client_id)
            self.send(client_id, Envelope(
                MSG_DEVCH_RES, client_id=client_id, seq=env.seq,
                info=_devch.DEVCH_OK if ok else ""))
        elif env.mtype == MSG_SUBSCRIBE:
            subscribe_cb(client_id, env.info)
        elif self.on_message is not None:
            self.on_message(client_id, env)


class ClientConn:
    """Interface: one client connection.  ``metrics`` as on
    :class:`ServerTransport`."""

    metrics = None
    #: True once :meth:`request_devch` confirmed the peer shares this
    #: process's device world — device-resident sends then ride the
    #: device channel (control metadata only on the socket)
    devch_ok = False

    def request_devch(self, timeout: float = 2.0) -> bool:
        """Run the device-channel handshake; returns (and records in
        :attr:`devch_ok`) whether the peer granted the fast path.
        Default: transports without a handshake stay on plain framing —
        the transparent-fallback contract."""
        return False

    def send(self, env: Envelope) -> bool:
        raise NotImplementedError

    def is_alive(self) -> bool:
        """False once the peer is gone — lets a pipelined caller
        distinguish "no data yet" from "connection dead" after a
        timed-out recv (mid-stream failover)."""
        return True

    def recv(self, timeout: Optional[float] = None) -> Optional[Envelope]:
        raise NotImplementedError

    def request_caps(self, timeout: float = 5.0) -> Optional[str]:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


# -- inproc -------------------------------------------------------------------

_HUB_LOCK = threading.Lock()
_HUB: Dict[Tuple[str, int], "InprocServer"] = {}


class InprocServer(ServerTransport):
    """Zero-copy in-process transport: a global hub maps (host, port) to
    the server; envelopes cross as Python references."""

    def __init__(self, host: str, port: int):
        super().__init__()
        self.addr = (host, int(port))
        self._clients: Dict[int, "InprocClientConn"] = {}
        self._subs: Dict[int, str] = {}  # client_id → topic
        self._next_id = 1
        self._lock = threading.Lock()

    def start(self) -> None:
        with _HUB_LOCK:
            if self.addr in _HUB:
                raise OSError(f"inproc address already bound: {self.addr}")
            _HUB[self.addr] = self

    def stop(self) -> None:
        with _HUB_LOCK:
            if _HUB.get(self.addr) is self:
                del _HUB[self.addr]
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
            self._subs.clear()
        for c in clients:
            c._closed.set()

    def _connect(self, conn: "InprocClientConn") -> int:
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            self._clients[cid] = conn
        return cid

    def _disconnect(self, client_id: int) -> None:
        with self._lock:
            self._clients.pop(client_id, None)
            self._subs.pop(client_id, None)

    def _receive(self, client_id: int, env: Envelope) -> None:
        env.client_id = client_id
        self._dispatch(client_id, env, self._subscribe)

    def _subscribe(self, client_id: int, topic: str) -> None:
        with self._lock:
            self._subs[client_id] = topic

    def send(self, client_id: int, env: Envelope) -> bool:
        with self._lock:
            conn = self._clients.get(client_id)
        if conn is None:
            return False
        ch = _chaos.plan
        if ch is not None:
            # inproc frames are the Envelope objects themselves — the
            # same fault schedule applies, minus corrupt (no wire bytes)
            op = ch.wire(_chaos_label(self.metrics, "inproc-server"),
                         "tx", env)
            if op is not None:
                def kill():
                    conn._closed.set()
                    self._disconnect(client_id)

                _apply_wire_op(op, conn._deliver, kill)
                return True
        conn._deliver(env)
        return True

    def publish(self, env: Envelope) -> int:
        with self._lock:
            targets = [cid for cid, topic in self._subs.items()
                       if not topic or topic == env.info]
        return sum(bool(self.send(cid, env)) for cid in targets)


class InprocClientConn(ClientConn):
    def __init__(self, host: str, port: int):
        with _HUB_LOCK:
            server = _HUB.get((host, int(port)))
        if server is None:
            raise ConnectionRefusedError(
                f"no inproc server at {host}:{port}")
        self._server = server
        self._inbox: "queue.Queue[Envelope]" = queue.Queue()
        self._caps: "queue.Queue[str]" = queue.Queue()
        self._closed = threading.Event()
        self.client_id = server._connect(self)

    def request_devch(self, timeout: float = 2.0) -> bool:
        # inproc envelopes already cross by reference — card-resident
        # buffers never leave the card here, so the channel is trivially on
        # (no wire exchange, no behavior change)
        self.devch_ok = True
        return True

    def _deliver(self, env: Envelope) -> None:
        # route control responses to their own queue so a caps handshake
        # never races with data replies
        if env.mtype == MSG_CAPS_RES:
            self._caps.put(env.info)
        else:
            self._inbox.put(env)

    def send(self, env: Envelope) -> bool:
        if self._closed.is_set():
            return False
        ch = _chaos.plan
        if ch is not None:
            op = ch.wire(_chaos_label(self.metrics, "inproc-client"),
                         "tx", env)
            if op is not None:
                _apply_wire_op(
                    op, lambda e: self._server._receive(self.client_id,
                                                        e),
                    self.close)
                return True
        self._server._receive(self.client_id, env)
        return True

    def recv(self, timeout: Optional[float] = None) -> Optional[Envelope]:
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def request_caps(self, timeout: float = 5.0) -> Optional[str]:
        self.send(Envelope(MSG_CAPS_REQ))
        try:
            return self._caps.get(timeout=timeout)
        except queue.Empty:
            return None

    def is_alive(self) -> bool:
        return not self._closed.is_set()

    def close(self) -> None:
        self._closed.set()
        self._server._disconnect(self.client_id)


# -- tcp ----------------------------------------------------------------------


def _chaos_label(metrics, fallback: str) -> str:
    """The seam label a FaultPlan's ``match=`` is tested against: the
    owning element + peer address when link metrics are attached, else
    the transport kind."""
    return f"{metrics.link}:{metrics.peer}" if metrics is not None \
        else fallback


def _shutdown_quiet(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def _send_frame(sock: socket.socket, data: bytes, lock: threading.Lock
                ) -> bool:
    try:
        with lock:
            # the per-connection write lock exists precisely so that
            # concurrent publishers emit whole frames (len-prefix +
            # payload) — interleaving would desync the length framing.
            # No recv ever runs under this or any
            # transport lock; readers live on their own threads and
            # take no lock around recv.
            # nns-lint: disable=NNS602 -- per-conn write leaf lock;
            # sendall under it IS the frame serialization
            sock.sendall(struct.pack("<I", len(data)) + data)
        return True
    except OSError:
        return False


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    try:
        hdr = _recv_exact(sock, 4)
        if hdr is None:
            return None
        (n,) = struct.unpack("<I", hdr)
        return _recv_exact(sock, n)
    except OSError:
        return None


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        c = sock.recv(n)
        if not c:
            return None
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


class TcpServer(ServerTransport):
    """Socket server: one reader thread per client connection."""

    def __init__(self, host: str, port: int):
        super().__init__()
        self.host, self.port = host, int(port)
        self._sock: Optional[socket.socket] = None
        self._conns: Dict[int, Tuple[socket.socket, threading.Lock]] = {}
        self._subs: Dict[int, str] = {}
        self._next_id = 1
        self._lock = threading.Lock()
        self._running = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        if self.port == 0:
            self.port = s.getsockname()[1]
        s.listen(16)
        self._sock = s
        self._running.set()
        from ..obs import prof as _prof

        self._accept_thread = _prof.named_thread(
            "edge-accept", str(self.port), self._accept_loop)
        self._accept_thread.start()

    def stop(self) -> None:
        self._running.clear()
        if self._sock is not None:
            # shutdown BEFORE close: close() alone does not wake a
            # thread blocked in accept() on Linux — the kernel socket
            # stays referenced by the blocked call, the accept join
            # below times out, and the port cannot be rebound (which
            # breaks restart-on-the-same-port self-healing)
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
            self._subs.clear()
        for sock, _ in conns:
            # shutdown first, for the same reason as the listener: a
            # bare close() neither wakes this server's blocked reader
            # thread nor sends the peer its FIN (the blocked recv
            # syscall keeps the kernel socket alive), so clients could
            # never detect the shutdown and fail over
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None

    def _accept_loop(self) -> None:
        while self._running.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                cid = self._next_id
                self._next_id += 1
                self._conns[cid] = (conn, threading.Lock())
            logd("edge: client %d connected from %s", cid, addr)
            from ..obs import prof as _prof

            _prof.named_thread("edge-read", str(cid), self._reader,
                               args=(cid, conn)).start()

    def _reader(self, cid: int, conn: socket.socket) -> None:
        while self._running.is_set():
            data = _recv_frame(conn)
            if data is None:
                break
            m = self.metrics
            if m is not None:
                m.on_rx(4 + len(data))
            ch = _chaos.plan
            if ch is not None:
                op = ch.wire(_chaos_label(m, "tcp-server"), "rx", data)
                if op is not None:
                    _apply_wire_op(op,
                                   lambda f: self._rx_deliver(cid, f))
                    if op.disconnect:
                        break
                    continue
            self._rx_deliver(cid, data)
        with self._lock:
            self._conns.pop(cid, None)
            self._subs.pop(cid, None)
        self._devch_clients.discard(cid)
        # parked device-channel frames for a dead client can never be
        # redeemed — free their card memory now, not at slot eviction
        _devch.release_chan((id(self), cid))
        try:
            conn.close()
        except OSError:
            pass

    def _rx_deliver(self, cid: int, data: bytes) -> None:
        try:
            env = _from_wire(data)
        except ValueError as e:
            logw("edge: dropping bad frame from client %d: %s", cid, e)
            m = self.metrics
            if m is not None:
                m.on_bad_frame()
            return
        env.client_id = cid
        self._dispatch(cid, env, self._subscribe)

    def _subscribe(self, client_id: int, topic: str) -> None:
        with self._lock:
            self._subs[client_id] = topic

    def send(self, client_id: int, env: Envelope) -> bool:
        with self._lock:
            entry = self._conns.get(client_id)
        if entry is None:
            return False
        data = _to_wire(env, devch=self.devch_capable(client_id),
                        chan=(id(self), client_id))
        ch = _chaos.plan
        if ch is not None:
            op = ch.wire(_chaos_label(self.metrics, "tcp-server"),
                         "tx", data)
            if op is not None:
                return self._apply_tx_op(entry, op)
        ok = _send_frame(entry[0], data, entry[1])
        m = self.metrics
        if ok and m is not None:
            m.on_tx(4 + len(data))
        return ok

    def _apply_tx_op(self, entry, op) -> bool:
        """Injected-fault send: lost frames still LOOK sent at this
        layer (that's the fault being simulated); a disconnect closes
        the client's socket so its reader sees a dead peer."""
        def send_one(f):
            sent = _send_frame(entry[0], f, entry[1])
            m = self.metrics
            if sent and m is not None:
                m.on_tx(4 + len(f))
            return sent

        return _apply_wire_op(op, send_one,
                              lambda: _shutdown_quiet(entry[0]))

    def publish(self, env: Envelope) -> int:
        with self._lock:
            targets = [cid for cid, topic in self._subs.items()
                       if not topic or topic == env.info]
        return sum(bool(self.send(cid, env)) for cid in targets)


class TcpClientConn(ClientConn):
    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._inbox: "queue.Queue[Envelope]" = queue.Queue()
        self._caps: "queue.Queue[str]" = queue.Queue()
        self._devch_q: "queue.Queue[str]" = queue.Queue()
        self._closed = threading.Event()
        self._dead = threading.Event()
        from ..obs import prof as _prof

        self._reader_thread = _prof.named_thread(
            "edge-client-read", "", self._reader)
        self._reader_thread.start()

    def request_devch(self, timeout: float = 2.0) -> bool:
        """Device-channel handshake over the live socket: send our
        fingerprint, wait for the peer's verdict.  A peer that never
        answers (an old binary dropping the unknown mtype, a dead link)
        leaves ``devch_ok`` False — plain TCP framing continues, the
        transparent fallback."""
        self.devch_ok = False
        if not self.send(Envelope(MSG_DEVCH_REQ,
                                  info=_devch.fingerprint())):
            return False
        try:
            self.devch_ok = self._devch_q.get(
                timeout=timeout) == _devch.DEVCH_OK
        except queue.Empty:
            pass
        return self.devch_ok

    def _reader(self) -> None:
        while not self._closed.is_set():
            data = _recv_frame(self._sock)
            if data is None:
                break
            m = self.metrics
            if m is not None:
                m.on_rx(4 + len(data))
            ch = _chaos.plan
            if ch is not None:
                op = ch.wire(_chaos_label(m, "tcp-client"), "rx", data)
                if op is not None:
                    _apply_wire_op(op, self._rx_deliver)
                    if op.disconnect:
                        break
                    continue
            self._rx_deliver(data)
        self._dead.set()

    def _rx_deliver(self, data: bytes) -> None:
        try:
            env = _from_wire(data)
        except ValueError as e:
            logw("edge: client dropping bad frame: %s", e)
            m = self.metrics
            if m is not None:
                m.on_bad_frame()
            return
        if env.mtype == MSG_CAPS_RES:
            self._caps.put(env.info)
        elif env.mtype == MSG_DEVCH_RES:
            self._devch_q.put(env.info)
        else:
            self._inbox.put(env)

    def send(self, env: Envelope) -> bool:
        if self._closed.is_set():
            return False
        data = _to_wire(env, devch=self.devch_ok, chan=id(self))
        ch = _chaos.plan
        if ch is not None:
            op = ch.wire(_chaos_label(self.metrics, "tcp-client"),
                         "tx", data)
            if op is not None:
                return self._apply_tx_op(op)
        ok = _send_frame(self._sock, data, self._wlock)
        m = self.metrics
        if ok and m is not None:
            m.on_tx(4 + len(data))
        return ok

    def _apply_tx_op(self, op) -> bool:
        """Injected-fault send: a dropped frame still reports success
        (it was lost ON the wire, not refused by it); a disconnect
        kills the socket so both ends see a dead connection."""
        def send_one(f):
            sent = _send_frame(self._sock, f, self._wlock)
            m = self.metrics
            if sent and m is not None:
                m.on_tx(4 + len(f))
            return sent

        return _apply_wire_op(op, send_one,
                              lambda: _shutdown_quiet(self._sock))

    def recv(self, timeout: Optional[float] = None) -> Optional[Envelope]:
        try:
            return self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None

    def request_caps(self, timeout: float = 5.0) -> Optional[str]:
        if not self.send(Envelope(MSG_CAPS_REQ)):
            return None
        try:
            return self._caps.get(timeout=timeout)
        except queue.Empty:
            return None

    def is_alive(self) -> bool:
        return not self._closed.is_set() and not self._dead.is_set()

    def close(self) -> None:
        self._closed.set()
        _devch.release_chan(id(self))
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# -- MQTT-hybrid: broker-mediated discovery, TCP data plane -------------------

# discovery topic grammar; the retained payload is "host:port" of the
# data-plane TcpServer (parity: nnstreamer-edge HYBRID publishes the
# server's TCP address through the broker, the reference's tensor_query
# README)
_HYBRID_TOPIC_FMT = "nns-edge/{topic}/address"


class HybridServer(ServerTransport):
    """``connect-type=hybrid``: the broker (at ``host:port``) carries
    only DISCOVERY — a retained MQTT message advertising this server's
    TCP data address under ``topic``; every tensor rides a plain
    :class:`TcpServer`.  Stopping clears the retained advertisement (if
    still ours), so a replacement server that registers the same topic
    takes over and reconnecting clients find it through the broker (the
    reference's reconnect-to-alternates story)."""

    def __init__(self, host: str, port: int, topic: str = "",
                 data_host: str = "127.0.0.1", data_port: int = 0,
                 advertise_host: str = ""):
        # the data plane must exist before super().__init__, whose
        # on_message/caps_provider defaults route through the proxies
        self._tcp = TcpServer(data_host, int(data_port))
        super().__init__()
        self._broker_addr = (host, int(port))
        self.topic = topic or "tensor-query"
        # cross-host: bind data_host=0.0.0.0 and advertise a reachable
        # address (explicit advertise_host, else the machine's primary
        # IP); the loopback default covers same-host deployments
        self._advertise_host = advertise_host
        self._mqtt = None
        self._adv_thread = None
        self._stop_evt = threading.Event()
        self._adv_addr: str = ""
        # broker outages back off through the shared edge retry policy
        # (one WARNING per outage instead of a logline every 2 s tick;
        # breaker state exports on the LINK row)
        from ..chaos.retrypolicy import RetryPolicy
        from ..obs.metrics import LinkMetrics

        self._retry = RetryPolicy(
            name=f"hybrid-adv:{self.topic}", base_s=2.0, max_s=15.0,
            fail_threshold=5, open_s=10.0,
            metrics=LinkMetrics.get(f"hybrid-adv:{self.topic}",
                                    f"{host}:{port}", kind="hybrid"))

    def _advertised_addr(self) -> str:
        # resolved ONCE (after the data port is bound): a flapping
        # resolver answer mid-life would re-advertise a different
        # address and break stop()'s retained-slot ownership check
        if self._adv_addr:
            return self._adv_addr
        host = self._advertise_host or self._tcp.host
        if host in ("0.0.0.0", "::", ""):
            # the UDP-connect trick: the local address on the route to
            # the broker is what clients (who reach the same broker) can
            # dial.  Preferred over gethostbyname(gethostname()), which
            # Debian-family /etc/hosts maps to 127.0.1.1 — but when the
            # broker itself is local (route → loopback) fall back to the
            # hostname lookup, which may still yield the LAN address.
            host = ""
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.connect((self._broker_addr[0], self._broker_addr[1]
                           or 1))  # no packets are sent
                host = s.getsockname()[0]
            except OSError:
                pass
            finally:
                s.close()
            if not host or host.startswith("127."):
                try:
                    resolved = socket.gethostbyname(socket.gethostname())
                    if not resolved.startswith("127."):
                        host = resolved
                except OSError:
                    pass
            if not host:
                host = "127.0.0.1"
            if host.startswith("127."):
                logw("hybrid server %r: wildcard bind advertises a "
                     "LOOPBACK address (%s) — cross-host clients cannot "
                     "dial it; set advertise-host= to the reachable IP",
                     self.topic, host)
        self._adv_addr = f"{host}:{self._tcp.port}"
        return self._adv_addr

    # the data plane owns dispatch: proxy the element-facing surface
    @property
    def on_message(self):
        return self._tcp.on_message

    @on_message.setter
    def on_message(self, cb) -> None:
        self._tcp.on_message = cb

    @property
    def caps_provider(self):
        return self._tcp.caps_provider

    @caps_provider.setter
    def caps_provider(self, cb) -> None:
        self._tcp.caps_provider = cb

    @property
    def metrics(self):
        return self._tcp.metrics

    @metrics.setter
    def metrics(self, m) -> None:
        self._tcp.metrics = m

    @property
    def port(self) -> int:  # the ephemeral DATA port (host:port is broker)
        return self._tcp.port

    def start(self) -> None:
        self._tcp.start()
        self._stop_evt = threading.Event()
        try:
            self._connect_mqtt_and_advertise()
        except Exception as e:  # noqa: BLE001 - broker briefly down
            # don't fail (and leak the started TcpServer): the advertise
            # loop below reconnects through broker outages, and clients
            # retry discovery — same tolerance at startup as mid-life
            self._retry.failure(e, what=f"broker advertise "
                                        f"({self.topic!r})")
            self._close_mqtt()
        # periodic re-advertisement: a broker restart without retained
        # persistence would otherwise de-advertise a healthy server
        # forever (the keepalive thread dies silently on the first
        # failed ping); this loop re-publishes and reconnects as needed
        from ..obs import prof as _prof

        self._adv_thread = _prof.named_thread(
            "edge-hybrid-adv", self.topic, self._advertise_loop)
        self._adv_thread.start()

    def _connect_mqtt_and_advertise(self) -> None:
        from .mqtt import MqttClient

        m = MqttClient(
            self._broker_addr[0], self._broker_addr[1],
            client_id=f"nns-hybrid-srv-{uuid.uuid4().hex[:12]}")
        try:
            m.publish(_HYBRID_TOPIC_FMT.format(topic=self.topic),
                      self._advertised_addr().encode(), retain=True)
        except Exception:
            m.close()
            raise
        self._mqtt = m

    def _close_mqtt(self) -> None:
        # atomic swap-then-close: stop() and the advertise thread both
        # call this concurrently — each takes its own reference, so
        # neither can observe a half-closed None and raise
        m, self._mqtt = self._mqtt, None
        if m is not None:
            try:
                m.close()
            except OSError:
                pass

    def _advertise_loop(self, interval: float = 2.0) -> None:
        while not self._stop_evt.wait(interval):
            try:
                if self._mqtt is None:
                    if not self._retry.allow():
                        continue  # breaker open: probe after open_s,
                        # not on every 2 s tick
                    self._connect_mqtt_and_advertise()
                    self._retry.success()
                else:
                    # refresh the retained slot (no-op for a healthy
                    # broker; restores it after a broker restart); local
                    # ref — stop() may swap self._mqtt to None mid-call
                    m = self._mqtt
                    if m is not None and not self._stop_evt.is_set():
                        m.publish(
                            _HYBRID_TOPIC_FMT.format(topic=self.topic),
                            self._advertised_addr().encode(), retain=True)
                # a reconnect or a blocked publish can outlive stop()
                # (socket calls block up to the client timeout, longer
                # than stop's join): never leave a fresh advertisement
                # for a dead server — or clobber a replacement's —
                # after teardown began
                if self._stop_evt.is_set():
                    self._clear_if_mine()
                    return
            except Exception as e:  # noqa: BLE001 - broker down: retry
                # first failure of the outage logs at WARNING, the rest
                # at debug (no per-tick spam); the breaker slows probes
                # on a dead broker
                self._retry.failure(e, what=f"broker advertise "
                                            f"({self.topic!r})")
                self._close_mqtt()

    def _clear_if_mine(self) -> None:
        """Clear the retained advertisement iff it is still OURS.  Uses
        a dedicated local MqttClient (one connection: subscribe → read
        retained → compare → clear) so it never races the advertise
        loop's ``self._mqtt`` — the loop may still be mid-reconnect when
        stop() runs, and its revival path calls this too.

        Rolling restarts are last-writer-wins by design: while old and
        new servers overlap, their 2 s refreshes alternate the retained
        slot, but every address advertised belongs to a then-healthy
        server, the ownership check here keeps the LAST stop from
        clearing the survivor, and the survivor's next refresh (≤2 s,
        well under the 5 s discovery timeout) converges the slot."""
        self._close_mqtt()  # best-effort; the loop's client is not used
        from .mqtt import MqttClient

        try:
            chk = MqttClient(self._broker_addr[0], self._broker_addr[1],
                             client_id=f"nns-hyb-clr-{uuid.uuid4().hex[:8]}",
                             timeout=1.0)
        except Exception:  # noqa: BLE001 - broker gone: nothing to clear
            return
        try:
            topic = _HYBRID_TOPIC_FMT.format(topic=self.topic)
            chk.subscribe(topic)
            got = chk.recv_publish()
            if got is not None and \
                    got[1].decode() == self._advertised_addr():
                chk.publish(topic, b"", retain=True)
        except Exception:  # noqa: BLE001
            pass
        finally:
            chk.close()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._adv_thread is not None:
            self._adv_thread.join(timeout=3)
            self._adv_thread = None
        # clear the retained advertisement — but only if it is still
        # OURS: in a rolling restart the replacement server has already
        # overwritten the slot, and clearing it would de-advertise the
        # healthy successor
        self._clear_if_mine()
        self._tcp.stop()

    def send(self, client_id: int, env: Envelope) -> bool:
        return self._tcp.send(client_id, env)

    def publish(self, env: Envelope) -> int:
        return self._tcp.publish(env)


def _hybrid_discover(host: str, port: int, topic: str,
                     timeout: float) -> Tuple[str, int]:
    """Ask the broker who serves ``topic``; returns the data address.
    All broker-level failures surface as OSError — connect callers
    (e.g. the query client's failover loop) treat them like any other
    unreachable-server condition."""
    from .mqtt import MqttClient

    try:
        mqtt = MqttClient(host, int(port),
                          client_id=f"nns-hybrid-cli-{uuid.uuid4().hex[:12]}",
                          timeout=timeout)
    except Exception as e:  # noqa: BLE001 - CONNACK refused is StreamError
        if isinstance(e, OSError):
            raise
        raise OSError(f"hybrid: broker handshake failed: {e}") from e
    try:
        mqtt.subscribe(_HYBRID_TOPIC_FMT.format(topic=topic))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            # cap each blocking read to the remaining budget, else a
            # stray publish near the deadline lets the next recv block a
            # full extra timeout
            mqtt.set_recv_timeout(deadline - time.monotonic())
            got = mqtt.recv_publish()
            if got is None:
                continue
            _t, payload = got
            if payload:
                h, _, p = payload.decode().rpartition(":")
                return h, int(p)
        raise OSError(
            f"hybrid: no server registered for topic {topic!r} at "
            f"broker {host}:{port} within {timeout}s")
    except OSError:
        raise
    except Exception as e:  # noqa: BLE001 - e.g. "no SUBACK" StreamError
        raise OSError(f"hybrid: discovery failed: {e}") from e
    finally:
        mqtt.close()


def connect_hybrid(host: str, port: int, topic: str = "",
                   timeout: float = 5.0) -> ClientConn:
    """Discover via broker, then open the TCP data connection.  Called
    again after a disconnect (the query client's failover path), the
    broker is re-queried — a server that moved re-registers its topic
    and the client finds the new address."""
    data_host, data_port = _hybrid_discover(
        host, port, topic or "tensor-query", timeout)
    return TcpClientConn(data_host, data_port, timeout=timeout)


# -- factories ----------------------------------------------------------------


def make_server(host: str, port: int, connect_type: str = "tcp",
                topic: str = "", data_host: str = "127.0.0.1",
                data_port: int = 0,
                advertise_host: str = "") -> ServerTransport:
    if connect_type == "inproc":
        return InprocServer(host, port)
    if connect_type == "tcp":
        return TcpServer(host, port)
    if connect_type == "hybrid":
        return HybridServer(host, port, topic=topic, data_host=data_host,
                            data_port=data_port,
                            advertise_host=advertise_host)
    raise ValueError(f"unknown connect-type {connect_type!r}")


def connect(host: str, port: int, connect_type: str = "tcp",
            timeout: float = 5.0, topic: str = "") -> ClientConn:
    if connect_type == "inproc":
        return InprocClientConn(host, port)
    if connect_type == "tcp":
        return TcpClientConn(host, port, timeout=timeout)
    if connect_type == "hybrid":
        return connect_hybrid(host, port, topic=topic, timeout=timeout)
    raise ValueError(f"unknown connect-type {connect_type!r}")
