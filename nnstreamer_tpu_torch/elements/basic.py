"""Basic plumbing elements: appsrc, appsink, queue, filesink.

Counterpart of the JAX package's ``elements/basic.py`` for the elements
this slice of the port covers (GStreamer appsrc/appsink semantics, the
``queue`` thread boundary, and ``filesink``, the tail of every golden
comparison).
"""

from __future__ import annotations

import collections
import queue as _q
import threading
from typing import Optional

from ..core import Buffer, Caps, TensorsSpec
from ..runtime.element import Element, Pad, SinkElement, SourceElement
from ..runtime.events import Event, EventKind
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
            self.push(buf)
        self.forward_event(Event.eos())

    @property
    def current_level_buffers(self) -> int:
        with self._cv:
            return len(self._dq)


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
