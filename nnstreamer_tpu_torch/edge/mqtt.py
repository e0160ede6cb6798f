"""MQTT elements: ``mqttsrc`` / ``mqttsink`` + a loopback broker.

Counterpart of the JAX package's ``edge/mqtt.py``.  Parity targets: the
reference's ``gst/mqtt`` elements, which publish/subscribe whole tensor
buffers over MQTT topics; props host (127.0.0.1), port (1883),
client-id, pub-topic/sub-topic, num-buffers, mqtt-qos (0 =
fire-and-forget, the default), keep-alive.  The publisher prepends the
reference's ``GstMQTTMessageHdr`` idea — {num_mems, per-memory sizes,
base/sent epoch (for latency estimation; NTP-disciplined in the
reference, a pluggable clock here), duration, dts, pts, caps string} —
as fixed-width little-endian fields (``_HDR_FMT`` below), byte-equal to
the JAX package's header.

The MQTT 3.1.1 client (CONNECT/CONNACK, PUBLISH QoS0, SUBSCRIBE/SUBACK,
PING, DISCONNECT) is implemented directly over TCP — no paho dependency
— and :class:`MiniBroker` is an in-process broker for loopback pipelines
and tests.

On the card: ``mqttsink`` drains each card tensor once
(``Tensor.tobytes``, one ``d2h`` in the transfer ledger per tensor);
``mqttsrc`` puts out host tensors on a FLEXIBLE stream whose spec rides
in each message's caps string, and the first card element downstream
(``tensor_transform backend=cuda``) uploads them once.
"""

from __future__ import annotations

import os
import queue as _q
import select
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..chaos.retrypolicy import RetryPolicy
from ..core import Buffer, Caps, Tensor, TensorFormat, TensorSpec, TensorsSpec
from ..obs import hooks as _hooks
from ..obs import prof as _prof
from ..obs import tracectx
from ..obs.metrics import LinkMetrics
from ..obs.tracer import TRACE_META_KEY
from ..runtime.element import SinkElement, SourceElement, StreamError
from ..runtime.registry import register_element

# -- MQTT 3.1.1 packet codec -------------------------------------------------

_CONNECT, _CONNACK = 1, 2
_PUBLISH = 3
_SUBSCRIBE, _SUBACK = 8, 9
_PINGREQ, _PINGRESP = 12, 13
_DISCONNECT = 14


def _enc_varlen(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    data = bytearray()
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            raise ConnectionError("mqtt: peer closed")
        data += chunk
    return bytes(data)


def _read_packet(sock: socket.socket,
                 first_byte: Optional[int] = None) -> Tuple[int, int, bytes]:
    """→ (type, flags, payload)."""
    h = _read_exact(sock, 1)[0] if first_byte is None else first_byte
    length = shift = 0
    while True:
        b = _read_exact(sock, 1)[0]
        length |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 21:
            raise StreamError("mqtt: bad remaining-length")
    return h >> 4, h & 0x0F, _read_exact(sock, length) if length else b""


def _packet(ptype: int, flags: int, payload: bytes) -> bytes:
    return bytes([ptype << 4 | flags]) + _enc_varlen(len(payload)) + payload


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


class MqttClient:
    """Tiny MQTT 3.1.1 client: QoS0 publish/subscribe over TCP."""

    def __init__(self, host: str, port: int, client_id: str,
                 keep_alive: int = 60, timeout: float = 10.0):
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout)
        self._sock.settimeout(timeout)
        self._wlock = threading.Lock()
        self._closed = threading.Event()
        # PUBLISHes a spec-compliant broker may interleave before a
        # SUBACK (MQTT 3.1.1 §3.8.4) — parked here for recv_publish
        self._pending: List[Tuple[str, bytes]] = []
        var = _mqtt_str("MQTT") + bytes([4])  # protocol level 3.1.1
        var += bytes([0x02])                  # clean session
        var += struct.pack(">H", keep_alive)
        var += _mqtt_str(client_id)
        self._sock.sendall(_packet(_CONNECT, 0, var))
        t, _, p = _read_packet(self._sock)
        if t != _CONNACK or len(p) < 2 or p[1] != 0:
            raise StreamError(f"mqtt: CONNACK refused ({p!r})")
        # keep-alive discipline: CONNECT declared keep_alive, so a
        # spec-compliant broker drops us after 1.5x of idle — ping from
        # a background thread whenever no packet was sent for half of it
        self._last_send = time.monotonic()
        if keep_alive > 0:
            _prof.named_thread("edge-mqtt-keepalive", "",
                               self._keepalive_loop,
                               args=(keep_alive / 2.0,)).start()

    def _keepalive_loop(self, interval: float) -> None:
        while not self._closed.wait(min(interval / 4, 5.0)):
            if time.monotonic() - self._last_send >= interval:
                try:
                    self.ping()
                except OSError:
                    return

    def _send(self, pkt: bytes) -> None:
        with self._wlock:
            # _wlock exists to serialize whole packets onto the socket
            # (interleaved sendall would corrupt the MQTT framing); it
            # is a per-connection leaf never taken with another lock
            # nns-lint: disable=NNS602 -- write lock IS the packet
            # framing serialization point; nothing else nests under it
            self._sock.sendall(pkt)
            self._last_send = time.monotonic()

    def publish(self, topic: str, payload: bytes,
                retain: bool = False) -> None:
        # retain bit (MQTT 3.1.1 §3.3.1.3): broker keeps the message and
        # delivers it to future subscribers — the discovery mechanism of
        # the hybrid connect type (server address survives the publish)
        self._send(_packet(_PUBLISH, 0x01 if retain else 0,
                           _mqtt_str(topic) + payload))

    @staticmethod
    def _parse_publish(flags: int, p: bytes) -> Tuple[str, bytes]:
        tlen = struct.unpack(">H", p[:2])[0]
        topic = p[2:2 + tlen].decode()
        i = 2 + tlen
        if (flags >> 1) & 0x03:  # QoS>0 carries a packet id
            i += 2
        return topic, p[i:]

    def subscribe(self, topic: str) -> None:
        var = struct.pack(">H", 1) + _mqtt_str(topic) + bytes([0])
        self._send(_packet(_SUBSCRIBE, 0x02, var))
        # the broker MAY deliver matching (e.g. retained) PUBLISHes
        # before the SUBACK (MQTT 3.1.1 §3.8.4): park them.  PINGRESPs
        # from the keepalive thread are ignored; only unexpected packet
        # types count toward giving up, and the socket timeout bounds
        # the total wait.
        misc = 0
        while True:
            try:
                t, flags, p = _read_packet(self._sock)
            except socket.timeout as e:
                raise StreamError("mqtt: no SUBACK (timeout)") from e
            if t == _SUBACK:
                # payload: packet id (2) + per-topic return code; 0x80 =
                # subscription REFUSED (ACL / bad filter)
                if len(p) >= 3 and p[2] == 0x80:
                    raise StreamError(
                        f"mqtt: subscription to {topic!r} refused")
                return
            if t == _PUBLISH:
                self._pending.append(self._parse_publish(flags, p))
            elif t != _PINGRESP:
                misc += 1
                if misc > 8:
                    raise StreamError("mqtt: no SUBACK")

    def recv_publish(self) -> Optional[Tuple[str, bytes]]:
        """Next PUBLISH → (topic, payload); None on idle timeout.

        An idle timeout (no packet started) keeps the stream intact; a
        timeout MID-packet means the byte stream can no longer be
        resynchronized and the connection is declared dead."""
        if self._pending:
            return self._pending.pop(0)
        try:
            first = _read_exact(self._sock, 1)[0]
        except socket.timeout:
            return None  # idle: nothing started
        try:
            t, flags, p = _read_packet(self._sock, first_byte=first)
        except socket.timeout as e:
            raise ConnectionError(
                "mqtt: timed out mid-packet (stream desynced)") from e
        if t != _PUBLISH:
            return None  # a PINGRESP, or a packet type QoS0 never needs
        return self._parse_publish(flags, p)

    def set_recv_timeout(self, t: float) -> None:
        """Cap how long a single recv_publish may block (callers with a
        deadline shrink it to the remaining budget)."""
        self._sock.settimeout(max(0.05, t))

    def ping(self) -> None:
        self._send(_packet(_PINGREQ, 0, b""))

    def close(self) -> None:
        self._closed.set()
        try:
            self._send(_packet(_DISCONNECT, 0, b""))
        except OSError:
            pass
        self._sock.close()


class MiniBroker:
    """In-process QoS0 broker for loopback pipelines and tests.

    A publish is forwarded on the publisher's own connection thread,
    under each subscriber's write lock, with a blocking send: a
    subscriber that stops reading holds the publisher and every other
    subscriber of the topic until it reads again, and no message (or
    part of one) is dropped.  Only the reads poll, to notice
    :meth:`stop`, which shuts every connection down.
    ``bytes_in``/``bytes_out`` count the PUBLISH payload bytes it read
    and forwarded (topic and framing not included)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._subs: Dict[socket.socket, List[str]] = {}
        # topic → retained PAYLOAD (parsed, not raw wire bytes: a QoS>0
        # publish carries a packet id that must not leak into QoS0
        # re-delivery), delivered on subscribe; empty payload clears the
        # slot, per spec
        self._retained: Dict[str, bytes] = {}
        # per-socket write locks: concurrent sendall calls from several
        # _serve threads would interleave packet bytes mid-stream
        self._wlocks: Dict[socket.socket, threading.Lock] = {}
        # every open connection, for stop() to shut down: a thread may
        # be blocked in a forward to a subscriber that stopped reading
        self._conns: set = set()
        self._lock = threading.Lock()
        self.bytes_in = 0
        self.bytes_out = 0
        self._running = True
        self._thread = _prof.named_thread(
            "edge-mqtt-broker", str(self.port), self._accept_loop)
        self._thread.start()

    @staticmethod
    def _match(pattern: str, topic: str) -> bool:
        if pattern == "#":
            return True
        pp, tp = pattern.split("/"), topic.split("/")
        for i, seg in enumerate(pp):
            if seg == "#":
                return True
            if i >= len(tp) or (seg != "+" and seg != tp[i]):
                return False
        return len(pp) == len(tp)

    def _accept_loop(self) -> None:
        try:
            self._srv.settimeout(0.2)
        except OSError:
            return  # stop() closed the socket before the thread got here
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            _prof.named_thread("edge-mqtt-serve", "", self._serve,
                               args=(conn,)).start()

    def _send_pkt(self, conn: socket.socket, pkt: bytes) -> None:
        with self._lock:
            lock = self._wlocks.setdefault(conn, threading.Lock())
        with lock:
            # per-connection write lock: the broker's only job under it
            # is pushing one framed packet; serialization is the point
            # nns-lint: disable=NNS602 -- per-conn write leaf lock;
            # sendall under it IS the packet serialization
            conn.sendall(pkt)

    def _serve(self, conn: socket.socket) -> None:
        # the socket blocks, so a forward to it (from another _serve
        # thread) waits for a slow reader instead of giving up part-way
        # through a packet, which would desync that subscriber's stream;
        # the wait for the next packet polls, to notice stop()
        conn.settimeout(None)
        with self._lock:
            if not self._running:
                conn.close()
                return
            self._conns.add(conn)
        try:
            while True:
                ready, _, _ = select.select([conn], [], [], 0.5)
                if not ready:
                    if not self._running:
                        return
                    continue
                t, flags, p = _read_packet(conn)
                if t == _CONNECT:
                    self._send_pkt(conn, _packet(_CONNACK, 0, b"\x00\x00"))
                    with self._lock:
                        self._subs.setdefault(conn, [])
                elif t == _SUBSCRIBE:
                    pid = p[:2]
                    tlen = struct.unpack(">H", p[2:4])[0]
                    topic = p[4:4 + tlen].decode()
                    with self._lock:
                        self._subs.setdefault(conn, []).append(topic)
                        retained = [(tp, pl) for tp, pl
                                    in self._retained.items()
                                    if self._match(topic, tp)]
                    self._send_pkt(conn, _packet(_SUBACK, 0, pid + b"\x00"))
                    for tp, pl in retained:
                        self._send_pkt(conn, _packet(
                            _PUBLISH, 0x01, _mqtt_str(tp) + pl))
                elif t == _PUBLISH:
                    topic, payload = MqttClient._parse_publish(flags, p)
                    with self._lock:
                        self.bytes_in += len(payload)
                        if flags & 0x01:  # retain
                            if payload:
                                self._retained[topic] = payload
                            else:
                                self._retained.pop(topic, None)
                        targets = [c for c, pats in self._subs.items()
                                   if c is not conn and any(
                                       self._match(pt, topic)
                                       for pt in pats)]
                    # rebuild canonically as QoS0: forwarding the raw
                    # var-payload of a QoS1 publish would prepend its
                    # packet id to every subscriber's payload
                    pkt = _packet(_PUBLISH, 0, _mqtt_str(topic) + payload)
                    for c in targets:
                        try:
                            self._send_pkt(c, pkt)
                        except OSError:
                            # that subscriber's stream broke, perhaps
                            # part-way through this packet: end it
                            # rather than write past the cut
                            try:
                                c.shutdown(socket.SHUT_RDWR)
                            except OSError:
                                pass
                            continue
                        with self._lock:
                            self.bytes_out += len(payload)
                elif t == _PINGREQ:
                    self._send_pkt(conn, _packet(_PINGRESP, 0, b""))
                elif t == _DISCONNECT:
                    return
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                self._subs.pop(conn, None)
                self._wlocks.pop(conn, None)
                self._conns.discard(conn)
            conn.close()

    def stop(self) -> None:
        with self._lock:
            self._running = False
            conns = list(self._conns)
        self._srv.close()
        for c in conns:
            # wakes a _serve thread blocked in a read or in a forward
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(timeout=3)


# -- buffer (de)serialization ------------------------------------------------

_MAX_MEMS = 16          # parity: GST_MQTT_MAX_NUM_MEMS
_CAPS_STR_LEN = 512     # parity: GST_MQTT_MAX_LEN_GST_CAPS_STR
_NONE = (1 << 64) - 1
_HDR_FMT = "<I" + "Q" * _MAX_MEMS + "qqQQQ" + f"{_CAPS_STR_LEN}s"
_HDR_SIZE = struct.calcsize(_HDR_FMT)


def pack_mqtt_buffer(buf: Buffer, caps: Optional[Caps],
                     base_epoch_us: int, now_us: int) -> bytes:
    """Header + each tensor's bytes.  A card tensor drains once
    (``Tensor.tobytes``: one ``d2h`` per tensor in the transfer ledger;
    a later ``np()`` of the same tensor reads those bytes)."""
    payloads = [t.tobytes() for t in buf.tensors[:_MAX_MEMS]]
    sizes = [len(p) for p in payloads] + [0] * (_MAX_MEMS - len(payloads))
    caps_b = (str(caps) if caps is not None else "").encode()[
        :_CAPS_STR_LEN - 1]
    hdr = struct.pack(
        _HDR_FMT, len(payloads), *sizes, base_epoch_us, now_us,
        buf.duration if buf.duration is not None else _NONE,
        _NONE,  # dts: unused in this runtime
        buf.pts if buf.pts is not None else _NONE,
        caps_b)
    return hdr + b"".join(payloads)


def unpack_mqtt_buffer(data: bytes) -> Tuple[Buffer, Optional[TensorsSpec],
                                             int]:
    """→ (buffer of host tensors, spec-from-caps, sent_epoch_us)."""
    if len(data) < _HDR_SIZE:
        raise StreamError(f"mqtt: short message ({len(data)}B)")
    fields = struct.unpack(_HDR_FMT, data[:_HDR_SIZE])
    num = fields[0]
    sizes = fields[1:1 + _MAX_MEMS]
    if num > _MAX_MEMS:
        raise StreamError(f"mqtt: header claims {num} memories (max "
                          f"{_MAX_MEMS})")
    if _HDR_SIZE + sum(sizes[:num]) > len(data):
        raise StreamError("mqtt: payload shorter than declared sizes")
    _base_us, sent_us = fields[1 + _MAX_MEMS], fields[2 + _MAX_MEMS]
    duration, _dts, pts = fields[3 + _MAX_MEMS:6 + _MAX_MEMS]
    caps_str = fields[6 + _MAX_MEMS].split(b"\x00", 1)[0].decode()
    spec = None
    if caps_str:
        from ..runtime.parser import parse_caps_string

        try:
            spec = parse_caps_string(caps_str).to_spec()
        except Exception:  # noqa: BLE001 — foreign caps: payload still flows
            spec = None
    tensors = []
    off = _HDR_SIZE
    for i in range(num):
        n = sizes[i]
        if spec is not None and i < len(spec.tensors):
            # typed by the caps, bfloat16 included (a size that does not
            # match the caps raises): the bytes are the tensor's
            # payload, read on the host or uploaded once
            tensors.append(Tensor(data[off:off + n], spec.tensors[i]))
        else:
            raw = np.frombuffer(data, np.uint8, count=n, offset=off)
            tensors.append(Tensor(raw, TensorSpec.from_shape(
                raw.shape, np.uint8)))
        off += n
    return Buffer(
        tensors=tensors,
        pts=None if pts == _NONE else pts,
        duration=None if duration == _NONE else duration,
        format=spec.format if spec is not None else TensorFormat.STATIC,
    ), spec, sent_us


# -- elements ----------------------------------------------------------------


@register_element("mqttsink")
class MqttSink(SinkElement):
    FACTORY = "mqttsink"

    def __init__(self, name=None, host: str = "127.0.0.1", port: int = 1883,
                 pub_topic: str = "", client_id: str = "",
                 mqtt_qos: int = 0, num_buffers: int = -1,
                 epoch_fn: Optional[Callable[[], int]] = None,
                 reconnect: bool = True,
                 reconnect_timeout_s: float = 30.0, **props):
        self.host, self.port = host, port
        self.pub_topic = pub_topic
        self.client_id = client_id
        self.mqtt_qos = mqtt_qos
        self.num_buffers = num_buffers
        # pluggable clock (reference: NTP-disciplined epoch, ntputil.c)
        self.epoch_fn = epoch_fn
        # broker outages re-dial through the shared backoff/breaker
        # policy; past reconnect-timeout-s the outage becomes a clean
        # bus error instead of an eternal silent drop
        self.reconnect = reconnect
        self.reconnect_timeout_s = reconnect_timeout_s
        super().__init__(name, **props)
        self._client: Optional[MqttClient] = None
        self._base_us = 0
        self._sent = 0
        self._stopping = threading.Event()
        self._retry = RetryPolicy(name=self.name, base_s=0.2, max_s=2.0,
                                  fail_threshold=6, open_s=2.0)

    def _epoch_us(self) -> int:
        return int(self.epoch_fn()) if self.epoch_fn else \
            int(time.time() * 1e6)

    def start(self) -> None:
        cid = self.client_id or f"{os.uname().nodename}_{os.getpid()}_sink"
        topic = self.pub_topic or f"{cid}/topic"
        self.pub_topic = topic
        self._cid = cid
        self._stopping.clear()
        self._retry.metrics = LinkMetrics.get(
            self.name, f"{self.host}:{self.port}", kind="mqtt-pub")
        self._retry._sync_metrics()
        self._client = MqttClient(self.host, self.port, cid)
        self._base_us = self._epoch_us()
        self._sent = 0

    def render(self, buf: Buffer) -> None:
        n = int(self.num_buffers)
        if n >= 0 and self._sent >= n:
            return
        caps = self.sinkpad.caps
        data = pack_mqtt_buffer(buf, caps, self._base_us, self._epoch_us())
        tr = buf.meta.get(TRACE_META_KEY)
        if tr is not None:
            # trace context rides a magic-framed trailer AFTER the
            # payload; pre-trace subscribers parse by the header's
            # declared sizes and never see it (obs.tracectx)
            data = tracectx.append_trailer(
                data, tracectx.oneway_ctx(tr, self._epoch_us()))
        try:
            self._client.publish(str(self.pub_topic), data)
        except (ConnectionError, OSError) as e:
            if not bool(self.reconnect):
                raise
            self._retry.failure(e, what="broker publish")
            self._republish(data)
        self._sent += 1

    def _republish(self, data: bytes) -> None:
        """Broker gone mid-stream: reconnect through the shared retry
        policy and re-publish the frame.  Blocking here IS the
        backpressure — the streaming thread holds the frame until the
        broker answers, stop() interrupts, or the outage exceeds
        ``reconnect-timeout-s`` (→ StreamError on the bus via the chain
        guard)."""
        try:
            self._client.close()
        except OSError:
            pass
        deadline = time.monotonic() + float(self.reconnect_timeout_s)
        while not self._stopping.is_set():
            if time.monotonic() >= deadline:
                raise StreamError(
                    f"{self.name}: broker unreachable for "
                    f"{self.reconnect_timeout_s}s (gave up reconnecting)")
            if not self._retry.wait(stop=self._stopping, max_s=max(
                    deadline - time.monotonic(), 0.05)):
                return
            try:
                client = MqttClient(self.host, self.port, self._cid)
                client.publish(str(self.pub_topic), data)
            except (ConnectionError, OSError, StreamError) as e:
                self._retry.failure(e, what="broker reconnect")
                continue
            self._client = client
            self._retry.success()
            m = self._retry.metrics
            if m is not None:
                m.reconnect()
            return

    def stop(self) -> None:
        self._stopping.set()
        if self._client is not None:
            self._client.close()
            self._client = None


@register_element("mqttsrc")
class MqttSrc(SourceElement):
    FACTORY = "mqttsrc"

    def __init__(self, name=None, host: str = "127.0.0.1", port: int = 1883,
                 sub_topic: str = "", client_id: str = "",
                 num_buffers: int = -1, sub_timeout: float = 10.0,
                 reconnect: bool = True,
                 reconnect_timeout_s: float = 30.0, **props):
        self.host, self.port = host, port
        self.sub_topic = sub_topic
        self.client_id = client_id
        self.num_buffers = num_buffers
        self.sub_timeout = sub_timeout
        # a broker outage re-dials + re-subscribes through the shared
        # backoff/breaker policy; past reconnect-timeout-s it becomes a
        # clean bus error
        self.reconnect = reconnect
        self.reconnect_timeout_s = reconnect_timeout_s
        super().__init__(name, **props)
        self._client: Optional[MqttClient] = None
        # bounded, blocking put: a slow pipeline backs the broker (and
        # the publisher) up instead of dropping messages
        self._rx: "_q.Queue" = _q.Queue(maxsize=256)
        self._thread: Optional[threading.Thread] = None
        self._count = 0
        self.last_latency_us: Optional[int] = None
        self._retry = RetryPolicy(name=self.name, base_s=0.2, max_s=2.0,
                                  fail_threshold=6, open_s=2.0)

    def output_spec(self) -> TensorsSpec:
        # schema rides in each message's caps header: flexible stream
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def output_caps(self) -> Caps:
        return Caps.from_spec(self.output_spec())

    def start(self) -> None:
        if not self.sub_topic:
            raise StreamError(f"{self.name}: sub-topic not set")
        self._cid = self.client_id or \
            f"{os.uname().nodename}_{os.getpid()}_src"
        self._retry.metrics = LinkMetrics.get(
            self.name, f"{self.host}:{self.port}", kind="mqtt-sub")
        self._retry._sync_metrics()
        self._client = self._connect_broker()
        self._count = 0
        # the source thread (and _running) must exist BEFORE the rx
        # loop: its reconnect gate reads _running, and a broker that
        # dies immediately after the subscribe would otherwise be
        # misread as "stopping" and silently EOS the stream
        super().start()
        self._thread = _prof.named_thread(
            "edge-mqtt-rx", self.name, self._rx_loop)
        self._thread.start()

    def _connect_broker(self) -> MqttClient:
        client = MqttClient(self.host, self.port, self._cid,
                            timeout=float(self.sub_timeout))
        client.subscribe(str(self.sub_topic))
        return client

    def _rx_loop(self) -> None:
        while self._client is not None:
            try:
                msg = self._client.recv_publish()
            except (ConnectionError, OSError) as e:
                if not bool(self.reconnect) \
                        or not self._running.is_set():
                    self._rx.put(None)
                    return
                self._retry.failure(e, what="broker connection")
                if not self._reconnect_broker():
                    self._rx.put(None)
                    return
                continue
            if msg is not None:
                self._rx.put(msg[1])

    def _reconnect_broker(self) -> bool:
        """Re-dial + re-subscribe through the shared retry policy.
        False when stop() interrupted or the outage outlived
        ``reconnect-timeout-s`` (the give-up posts a bus error — the
        stream ends loudly, never silently)."""
        old, self._client = self._client, None
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        deadline = time.monotonic() + float(self.reconnect_timeout_s)
        while self._running.is_set():
            if time.monotonic() >= deadline:
                self.post_error(StreamError(
                    f"{self.name}: broker unreachable for "
                    f"{self.reconnect_timeout_s}s (gave up reconnecting)"))
                return False
            self._retry.wait(max_s=max(deadline - time.monotonic(), 0.05))
            if not self._running.is_set():
                return False
            try:
                client = self._connect_broker()
            except (ConnectionError, OSError, StreamError) as e:
                self._retry.failure(e, what="broker reconnect")
                continue
            self._client = client
            self._retry.success()
            m = self._retry.metrics
            if m is not None:
                m.reconnect()
            return True
        return False

    def create(self) -> Optional[Buffer]:
        n = int(self.num_buffers)
        if n >= 0 and self._count >= n:
            return None
        while self._running.is_set():
            try:
                data = self._rx.get(timeout=0.05)
            except _q.Empty:
                continue
            if data is None:
                return None
            data, ctx = tracectx.split_trailer(data)
            buf, _spec, sent_us = unpack_mqtt_buffer(data)
            self.last_latency_us = int(time.time() * 1e6) - sent_us
            if ctx is not None and _hooks.tracer is not None:
                tracectx.plant_oneway(buf.meta, ctx,
                                      int(time.time() * 1e6),
                                      link=self.name,
                                      source_name=self.name)
            self._count += 1
            return buf
        return None

    def stop(self) -> None:
        super().stop()
        if self._client is not None:
            self._client.close()
            self._client = None
        if self._thread is not None:
            self._thread.join(timeout=3)
            self._thread = None
