"""gRPC tensor bridge: ``tensor_src_grpc`` / ``tensor_sink_grpc``.

Counterpart of the JAX package's ``edge/grpc_bridge.py``.  Parity
targets: the reference's ``tensor_src_grpc``/``tensor_sink_grpc``
(props ``server`` (default TRUE), ``blocking`` (default TRUE),
``idl={protobuf,flatbuf}``, ``host`` (localhost), ``port`` (55115);
each element works as either gRPC server or client) and its
``TensorService`` RPCs — ``SendTensors`` (client→server stream) and
``RecvTensors`` (server→client stream) over the
``nnstreamer.protobuf.Tensors`` message.

Payloads ride the port's wire codecs (:mod:`..converters.codecs` — the
same field numbers as the reference .proto, so frames interoperate, with
the JAX package's too), and the gRPC methods are registered as *generic*
bytes-in/bytes-out handlers — no protoc/flatc codegen at build or
runtime.  A card buffer is drained as the codecs drain one (one ``d2h``
per tensor); received frames surface as ``format=flexible`` buffers of
fully-typed host tensors (self-describing wire), like the wire converter
sub-plugins.  The module needs ``grpcio``: :mod:`nnstreamer_tpu_torch.edge`
imports it only where ``import grpc`` succeeds.

Data flow matrix (matching the reference):
- sink server=True  : serves ``RecvTensors``; every buffer rendered into
  the sink is streamed to all connected receivers.
- sink server=False : client; opens ``SendTensors`` and streams buffers
  to the remote server.
- src  server=True  : serves ``SendTensors``; frames pushed by remote
  clients flow into the pipeline.
- src  server=False : client; calls ``RecvTensors`` and pushes the
  received stream into the pipeline.
"""

from __future__ import annotations

import queue as _q
import threading
import time
from concurrent import futures
from typing import Optional

import grpc

from ..converters.codecs import (
    flatbuf_decode,
    flatbuf_encode,
    flexbuf_decode,
    flexbuf_encode,
    protobuf_decode,
    protobuf_encode,
)
from ..core import Buffer, Caps, TensorFormat, TensorsSpec
from ..obs import hooks as _hooks
from ..obs import prof as _prof
from ..obs import tracectx
from ..obs.tracer import TRACE_META_KEY
from ..runtime.element import SinkElement, SourceElement, StreamError
from ..runtime.registry import register_element

SERVICE = "nnstreamer.protobuf.TensorService"
DEFAULT_PORT = 55115

_CODECS = {
    "protobuf": (protobuf_encode, protobuf_decode),
    "flatbuf": (flatbuf_encode, flatbuf_decode),
    "flexbuf": (flexbuf_encode, flexbuf_decode),
}


def _identity(b):
    return bytes(b)


class _GrpcPeer:
    """Shared server/client plumbing for one element."""

    def __init__(self, host: str, port: int, server: bool, idl: str):
        if idl not in _CODECS:
            raise ValueError(f"unknown idl {idl!r}; one of {list(_CODECS)}")
        self.encode, self.decode = _CODECS[idl]
        self.host, self.port, self.is_server = host, int(port), server
        self._server = None
        self._channel = None
        self.bound_port: Optional[int] = None

    # -- server --------------------------------------------------------------

    def start_server(self, send_handler=None, recv_source=None) -> int:
        """``send_handler(frame_bytes)`` consumes incoming SendTensors
        frames; ``recv_source()`` yields outgoing frames for RecvTensors
        subscribers."""
        rpcs = {}
        if send_handler is not None:
            def send_tensors(request_iterator, context):
                for frame in request_iterator:
                    send_handler(frame)
                return b""  # Empty

            rpcs["SendTensors"] = grpc.stream_unary_rpc_method_handler(
                send_tensors, request_deserializer=_identity,
                response_serializer=_identity)
        if recv_source is not None:
            def recv_tensors(request, context):
                for frame in recv_source(context):
                    yield frame

            rpcs["RecvTensors"] = grpc.unary_stream_rpc_method_handler(
                recv_tensors, request_deserializer=_identity,
                response_serializer=_identity)
        handler = grpc.method_handlers_generic_handler(SERVICE, rpcs)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((handler,))
        self.bound_port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        if self.bound_port == 0:
            raise StreamError(f"grpc: cannot bind {self.host}:{self.port}")
        self._server.start()
        return self.bound_port

    # -- client --------------------------------------------------------------

    def channel(self):
        if self._channel is None:
            self._channel = grpc.insecure_channel(f"{self.host}:{self.port}")
        return self._channel

    def client_send_stream(self, frame_iter) -> None:
        """SendTensors as a client: stream frames, wait for Empty."""
        ch = self.channel()
        call = ch.stream_unary(
            f"/{SERVICE}/SendTensors",
            request_serializer=_identity, response_deserializer=_identity)
        call(frame_iter)

    def client_recv_stream(self):
        """RecvTensors as a client: yields frames from the server."""
        ch = self.channel()
        call = ch.unary_stream(
            f"/{SERVICE}/RecvTensors",
            request_serializer=_identity, response_deserializer=_identity)
        return call(b"")

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None
        if self._channel is not None:
            self._channel.close()
            self._channel = None


@register_element("tensor_sink_grpc")
class GrpcSink(SinkElement):
    """Pipeline → gRPC (server: serve RecvTensors; client: SendTensors)."""

    FACTORY = "tensor_sink_grpc"

    def __init__(self, name=None, host: str = "localhost",
                 port: int = DEFAULT_PORT, server: bool = True,
                 blocking: bool = True, idl: str = "protobuf",
                 out_queue: int = 64, **props):
        self.host, self.port = host, port
        self.server, self.blocking, self.idl = server, blocking, idl
        self.out_queue = out_queue
        super().__init__(name, **props)
        self._peer: Optional[_GrpcPeer] = None
        self._q: "_q.Queue" = _q.Queue(maxsize=int(out_queue))
        self._subscribers: list = []
        self._sub_lock = threading.Lock()
        self._client_thread: Optional[threading.Thread] = None
        self._running = False

    def start(self) -> None:
        self._peer = _GrpcPeer(self.host, self.port, bool(self.server),
                               str(self.idl))
        self._running = True
        if self._peer.is_server:
            self._peer.start_server(recv_source=self._subscriber_frames)
        else:
            self._client_thread = _prof.named_thread(
                "edge-grpc-send", self.name, self._client_loop)
            self._client_thread.start()

    @property
    def bound_port(self) -> Optional[int]:
        return self._peer.bound_port if self._peer else None

    def _subscriber_frames(self, context):
        sub: "_q.Queue" = _q.Queue(maxsize=int(self.out_queue))
        with self._sub_lock:
            self._subscribers.append(sub)
        try:
            while self._running and context.is_active():
                try:
                    frame = sub.get(timeout=0.1)
                except _q.Empty:
                    continue
                if frame is None:
                    return
                yield frame
        finally:
            with self._sub_lock:
                if sub in self._subscribers:
                    self._subscribers.remove(sub)

    def _client_loop(self) -> None:
        def frames():
            while self._running:
                try:
                    f = self._q.get(timeout=0.1)
                except _q.Empty:
                    continue
                if f is None:
                    return
                yield f

        try:
            self._peer.client_send_stream(frames())
        except Exception as e:  # noqa: BLE001 — surface as bus error
            if self._running:
                self.post_error(e)

    def _encode(self, buf: Buffer) -> bytes:
        """Codec bytes, plus the trace trailer for a sampled buffer
        (magic-framed suffix, obs.tracectx — the src side strips it
        before handing the frame to the codec)."""
        frame = self._peer.encode(buf, buf.spec())
        tr = buf.meta.get(TRACE_META_KEY)
        if tr is not None:
            frame = tracectx.append_trailer(
                frame, tracectx.oneway_ctx(tr, int(time.time() * 1e6)))
        return frame

    def render(self, buf: Buffer) -> None:
        if self._peer.is_server:
            with self._sub_lock:
                subs = list(self._subscribers)
            if not subs:
                return  # nobody listening: skip the serialization entirely
            frame = self._encode(buf)
            for sub in subs:
                try:
                    sub.put(frame, timeout=1.0 if self.blocking else 0.0)
                except _q.Full:
                    pass  # slow subscriber: drop (non-blocking semantics)
        else:
            frame = self._encode(buf)
            # blocking mode still re-checks _running so a stalled remote
            # cannot wedge the streaming thread past stop()
            while self._running:
                try:
                    self._q.put(frame, timeout=0.2 if self.blocking else 0.0)
                    return
                except _q.Full:
                    if not self.blocking:
                        return  # drop

    @staticmethod
    def _put_sentinel(q: "_q.Queue") -> None:
        """Enqueue the shutdown sentinel even if the queue is full."""
        while True:
            try:
                q.put_nowait(None)
                return
            except _q.Full:
                try:
                    q.get_nowait()
                except _q.Empty:
                    pass

    def stop(self) -> None:
        self._running = False
        self._put_sentinel(self._q)
        with self._sub_lock:
            for sub in self._subscribers:
                self._put_sentinel(sub)
        if self._client_thread is not None:
            self._client_thread.join(timeout=5)
            self._client_thread = None
        if self._peer is not None:
            self._peer.stop()
            self._peer = None


@register_element("tensor_src_grpc")
class GrpcSrc(SourceElement):
    """gRPC → pipeline (server: serve SendTensors; client: RecvTensors)."""

    FACTORY = "tensor_src_grpc"

    def __init__(self, name=None, host: str = "localhost",
                 port: int = DEFAULT_PORT, server: bool = True,
                 blocking: bool = True, idl: str = "protobuf",
                 num_buffers: int = 0, **props):
        self.host, self.port = host, port
        self.server, self.blocking, self.idl = server, blocking, idl
        self.num_buffers = num_buffers
        super().__init__(name, **props)
        self._peer: Optional[_GrpcPeer] = None
        self._q: "_q.Queue" = _q.Queue(maxsize=256)
        self._recv_thread: Optional[threading.Thread] = None
        self._count = 0

    def output_spec(self) -> TensorsSpec:
        # payloads are self-describing (wire header carries the schema)
        return TensorsSpec(format=TensorFormat.FLEXIBLE)

    def output_caps(self) -> Caps:
        return Caps.from_spec(self.output_spec())

    def start(self) -> None:
        self._peer = _GrpcPeer(self.host, self.port, bool(self.server),
                               str(self.idl))
        self._count = 0
        # _running must be set BEFORE the server can deliver frames:
        # _on_frame drops everything while the element is not running
        super().start()
        if self._peer.is_server:
            self._peer.start_server(send_handler=self._on_frame)
        else:
            self._recv_thread = _prof.named_thread(
                "edge-grpc-recv", self.name, self._recv_loop)
            self._recv_thread.start()

    @property
    def bound_port(self) -> Optional[int]:
        return self._peer.bound_port if self._peer else None

    def _on_frame(self, frame: bytes) -> None:
        # bounded, interruptible put: a stalled/stopped pipeline must not
        # wedge the gRPC executor thread (its workers are non-daemon and
        # would hang interpreter exit)
        while self._running.is_set():
            try:
                self._q.put(frame, timeout=0.2)
                return
            except _q.Full:
                continue

    def _recv_loop(self) -> None:
        try:
            for frame in self._peer.client_recv_stream():
                self._q.put(frame)
        except grpc.RpcError as e:
            # remote going away is EOS, not an error (classified by
            # status code, never by message text)
            eos_codes = (grpc.StatusCode.CANCELLED,
                         grpc.StatusCode.UNAVAILABLE)
            if self._running.is_set() and e.code() not in eos_codes:
                self.post_error(e)
        except Exception as e:  # noqa: BLE001
            if self._running.is_set():
                self.post_error(e)
        finally:
            self._q.put(None)

    def create(self) -> Optional[Buffer]:
        n = int(self.num_buffers)
        if n and self._count >= n:
            return None
        while self._running.is_set():
            try:
                frame = self._q.get(timeout=0.05)
            except _q.Empty:
                continue
            if frame is None:
                return None  # EOS
            frame, ctx = tracectx.split_trailer(frame)
            buf, _spec = self._peer.decode(frame)
            buf.format = TensorFormat.FLEXIBLE
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
        if self._peer is not None:
            self._peer.stop()
            self._peer = None
        if self._recv_thread is not None:
            self._recv_thread.join(timeout=5)
            self._recv_thread = None
