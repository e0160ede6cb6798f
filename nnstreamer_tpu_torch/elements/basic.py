"""Basic plumbing elements: appsrc, appsink, tensor_sink, fakesink,
queue, tee, identity, filesrc, filesink, tensor_debug.

Counterpart of the JAX package's ``elements/basic.py`` (GStreamer
appsrc/appsink semantics, the reference's ``tensor_sink`` ``new-data``
callback element and ``tensor_debug``, the ``queue`` thread boundary,
``tee`` fan-out, and ``filesrc``/``filesink``, the head and tail of every
golden comparison).

``tee`` hands the same buffer, the same tensors, to every branch, as the
JAX package does.  Torch tensors are mutable, so it first marks each
tensor shared: a ``tensor_transform donate=true`` on one branch then
never writes into the frame in place (it still marks the frame donated,
so a later read on another branch raises ``DonatedTensorError``, as in
the JAX package).
"""

from __future__ import annotations

import collections
import logging
import queue as _q
import threading
from typing import Callable, List, Optional

import numpy as np

from ..core import Buffer, Caps, CapsStruct, Tensor, TensorSpec, TensorsSpec
from ..obs import hooks as _hooks
from ..runtime.element import Element, Pad, SinkElement, SourceElement
from ..runtime.events import Event, EventKind, Message, MessageKind
from ..runtime.registry import register_element


@register_element("appsrc")
class AppSrc(SourceElement):
    """Application-driven source: the app pushes Buffers via :meth:`push_buffer`
    and ends the stream with :meth:`end_of_stream`.  ``spec`` (a TensorsSpec or
    a caps string) must be set before the pipeline starts."""

    FACTORY = "appsrc"

    def __init__(self, name=None, spec: Optional[TensorsSpec] = None,
                 caps=None, max_buffers: int = 64, **props):
        self.spec = spec
        self.caps = caps
        self.max_buffers = max_buffers
        super().__init__(name, **props)
        if isinstance(self.caps, str):
            from ..runtime.parser import parse_caps_string

            self.caps = parse_caps_string(self.caps)
        self._q: "_q.Queue" = _q.Queue(maxsize=int(self.max_buffers))

    def output_caps(self) -> Caps:
        if self.caps is not None:
            return self.caps
        return super().output_caps()

    def output_spec(self):
        return self.spec

    def push_buffer(self, buf: Buffer, timeout: Optional[float] = None) -> None:
        self._q.put(buf, timeout=timeout)

    def end_of_stream(self) -> None:
        self._q.put(None)

    def create(self) -> Optional[Buffer]:
        while self._running.is_set():
            try:
                return self._q.get(timeout=0.05)
            except _q.Empty:
                continue
        return None


@register_element("appsink")
class AppSink(SinkElement):
    """Pull-style sink: the app calls :meth:`pull` to take buffers out."""

    FACTORY = "appsink"

    def __init__(self, name=None, max_buffers: int = 64, drop: bool = False,
                 **props):
        self.max_buffers = max_buffers
        self.drop = drop
        super().__init__(name, **props)
        self._q: "_q.Queue" = _q.Queue(maxsize=int(self.max_buffers))

    def render(self, buf: Buffer) -> None:
        if self.drop:
            try:
                self._q.put_nowait(buf)
            except _q.Full:
                try:
                    self._q.get_nowait()
                except _q.Empty:
                    pass
                self._q.put_nowait(buf)
        else:
            self._q.put(buf)

    def pull(self, timeout: Optional[float] = None) -> Optional[Buffer]:
        try:
            return self._q.get(timeout=timeout)
        except _q.Empty:
            return None


@register_element("tensor_sink")
class TensorSink(SinkElement):
    """Callback sink (parity: gsttensor_sink.c ``new-data`` signal +
    emit-signal/signal-rate properties).  The callback runs on the
    streaming thread after the sink's depth-1 fence, with the buffer as
    the pipeline left it (device tensors stay on the device)."""

    FACTORY = "tensor_sink"

    def __init__(self, name=None, callback: Optional[Callable] = None,
                 emit_signal: bool = True, sync: bool = False, **props):
        self.callback = callback
        self.emit_signal = emit_signal
        self.sync = sync
        super().__init__(name, **props)
        self.buffers_rendered = 0
        self.last_buffer: Optional[Buffer] = None
        self._cbs: List[Callable] = []

    def connect(self, cb: Callable) -> None:
        """connect('new-data'-style) a callback(buffer)."""
        self._cbs.append(cb)

    def render(self, buf: Buffer) -> None:
        self.buffers_rendered += 1
        self.last_buffer = buf
        if self.emit_signal:
            if self.callback is not None:
                self.callback(buf)
            for cb in self._cbs:
                cb(buf)


@register_element("fakesink")
class FakeSink(SinkElement):
    FACTORY = "fakesink"

    def render(self, buf: Buffer) -> None:
        pass


@register_element("queue")
class Queue(Element):
    """Thread boundary with a bounded buffer (parity: GStreamer queue).
    ``leaky``: '' (block), 'upstream' (drop new), 'downstream' (drop old)."""

    FACTORY = "queue"

    def __init__(self, name=None, max_size_buffers: int = 16,
                 leaky: str = "", **props):
        self.max_size_buffers = max_size_buffers
        self.leaky = leaky
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self._dq: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._eos = False

    def chain(self, pad: Pad, buf: Buffer) -> None:
        cap = int(self.max_size_buffers)
        with self._cv:
            if self.leaky == "upstream" and len(self._dq) >= cap:
                return  # drop the incoming buffer
            if self.leaky == "downstream":
                while len(self._dq) >= cap:
                    self._dq.popleft()
            else:
                while self._running and len(self._dq) >= cap:
                    self._cv.wait(0.05)
                if not self._running:
                    return
            tracer = _hooks.tracer
            if tracer is not None:
                tracer.queue_enqueued(self, buf)
            self._dq.append(buf)
            self._cv.notify_all()

    def handle_event(self, pad: Pad, event: Event) -> None:
        if event.kind == EventKind.EOS:
            with self._cv:
                self._eos = True
                self._cv.notify_all()
        else:
            self.forward_event(event)

    def start(self) -> None:
        self._running = True
        self._eos = False
        pipe = self.pipeline.name if self.pipeline is not None else "-"
        self._thread = threading.Thread(
            target=self._loop, name=f"nns:{pipe}:{self.name}:queue",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._dq and not self._eos:
                    self._cv.wait(0.05)
                if not self._running:
                    return
                if self._dq:
                    buf = self._dq.popleft()
                    self._cv.notify_all()
                elif self._eos:
                    break
                else:
                    continue
            tracer = _hooks.tracer
            if tracer is not None:
                tracer.queue_dequeued(self, buf)
            self.push(buf)
        self.forward_event(Event.eos())

    @property
    def current_level_buffers(self) -> int:
        with self._cv:
            return len(self._dq)


@register_element("tee")
class Tee(Element):
    """1→N fan-out; each downstream branch receives every buffer."""

    FACTORY = "tee"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad()
        self._next = 0

    def request_pad(self, name: str) -> Optional[Pad]:
        if name in ("src_%u", "src"):
            name = f"src_{self._next}"
        if not name.startswith("src_"):
            return None
        self._next += 1
        return self.add_src_pad(name)

    def propose_src_caps(self, pad: Pad) -> Caps:
        if self.sinkpad.caps is not None:
            return self.sinkpad.caps
        return Caps.any_tensors()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if len(self.srcpads) > 1:
            for t in buf.tensors:
                t._shared = True
        for sp in self.srcpads:
            self.push(buf, sp)


@register_element("identity")
class Identity(Element):
    FACTORY = "identity"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        self.push(buf)


@register_element("filesrc")
class FileSrc(SourceElement):
    """Read a file and push its bytes as application/octet-stream buffers
    (parity: GStreamer filesrc, the head of every golden pipeline).
    ``blocksize=0`` pushes the whole file as one buffer."""

    FACTORY = "filesrc"

    def __init__(self, name=None, location: str = "", blocksize: int = 0,
                 **props):
        self.location = location
        self.blocksize = blocksize
        super().__init__(name, **props)
        self._fh = None
        self._done = False

    def output_caps(self) -> Caps:
        return Caps.new(CapsStruct.make("application/octet-stream"))

    def output_spec(self):
        return None

    def start(self) -> None:
        self._fh = open(self.location, "rb")
        self._done = False
        super().start()

    def stop(self) -> None:
        super().stop()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def create(self) -> Optional[Buffer]:
        if self._done or self._fh is None:
            return None
        size = int(self.blocksize)
        data = self._fh.read(size) if size > 0 else self._fh.read()
        if not data or size <= 0:
            self._done = True
        if not data:
            return None
        arr = np.frombuffer(data, np.uint8)
        return Buffer(tensors=[Tensor(
            arr, TensorSpec.from_shape(arr.shape, np.uint8))])


@register_element("filesink")
class FileSink(SinkElement):
    """Append every incoming buffer's payload bytes to a file (parity:
    GStreamer filesink — the tail of every golden comparison)."""

    FACTORY = "filesink"

    def __init__(self, name=None, location: str = "", **props):
        self.location = location
        super().__init__(name, **props)
        self._fh = None

    def start(self) -> None:
        self._fh = open(self.location, "wb")

    def render(self, buf: Buffer) -> None:
        for t in buf.tensors:
            self._fh.write(t.tobytes())

    def stop(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


@register_element("tensor_debug")
class TensorDebug(Element):
    """Stream introspection (parity: the reference's gsttensor_debug.c):
    posts an ELEMENT bus message describing each buffer (schema and pts
    only: no tensor is read, so nothing crosses from the device), passes
    data through; ``output-mode=console`` also logs it."""

    FACTORY = "tensor_debug"

    def __init__(self, name=None, output_mode: str = "console", **props):
        self.output_mode = output_mode
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        desc = {
            "num_tensors": buf.num_tensors,
            "dims": [t.spec.dim_string() for t in buf.tensors],
            "types": [str(t.dtype) for t in buf.tensors],
            "format": str(buf.format),
            "pts": buf.pts,
        }
        if self.output_mode == "console":
            logging.getLogger("nnstreamer_tpu_torch").info(
                "[%s] buffer %s", self.name, desc)
        self.post_message(
            Message(MessageKind.ELEMENT, self.name, data=desc))
        self.push(buf)
