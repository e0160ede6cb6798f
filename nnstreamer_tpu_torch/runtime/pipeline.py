"""Pipeline container: graph assembly, negotiation, state, bus.

Counterpart of the JAX package's ``runtime/pipeline.py`` (replaces
GstPipeline/GstBus).  ``Pipeline.start()`` runs the fusion pass and the
static negotiation pass (sources outward), then spawns source threads.
``bus`` carries ERROR/EOS/LATENCY/ELEMENT messages.

A pipeline owns the device its elements compute on: ``"cuda"`` unless the
caller asks for ``"cpu"``; asking for ``cuda`` without a card raises.

While playing, a pipeline is registered (weakly) with the process metrics
registry (``obs/metrics.py``); its first start also reads the chaos plan
(``NNS_TPU_TORCH_CHAOS``), arms the flight recorder
(``NNS_TPU_TORCH_FLIGHTREC_DIR``) and serves the registry
(``NNS_TPU_TORCH_METRICS_PORT``).
"""

from __future__ import annotations

import queue as _q
import threading
import time
from typing import Dict, Optional, Union

from ..obs import metrics as _metrics
from ..utils.device import DeviceLike, resolve_device
from .element import Element, NegotiationError, SourceElement
from .events import Message, MessageKind


class Bus:
    """Message bus (parity: GstBus).  Watch handlers run synchronously in
    the posting thread, so handler registration is copy-on-write under a
    lock: ``post`` reads an immutable snapshot and never holds the lock
    while invoking handlers (a handler may itself add/remove watches)."""

    def __init__(self):
        self._q: "_q.Queue[Message]" = _q.Queue()
        self._handlers: tuple = ()
        self._handlers_lock = threading.Lock()

    def post(self, msg: Message) -> None:
        handlers = self._handlers  # immutable snapshot; no lock on post
        for h in handlers:
            h(msg)
        self._q.put(msg)

    def pop(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            return self._q.get(timeout=timeout)
        except _q.Empty:
            return None

    def add_watch(self, handler) -> None:
        with self._handlers_lock:
            self._handlers = self._handlers + (handler,)

    def remove_watch(self, handler) -> bool:
        """Remove ONE registration of a previously added watch.  Returns
        whether it was registered."""
        with self._handlers_lock:
            for i, h in enumerate(self._handlers):
                if h == handler:
                    self._handlers = (self._handlers[:i]
                                      + self._handlers[i + 1:])
                    return True
            return False


class Pipeline:
    def __init__(self, name: str = "pipeline", fuse: bool = True,
                 device: DeviceLike = "cuda"):
        self.name = name
        # the device every element of this pipeline computes on
        self.device = resolve_device(device)
        # transform↔filter↔decoder fusion pass (runtime/fusion.py); opt
        # out with fuse=False to run every element on its own
        self.fuse = fuse
        # fused segments (runtime/fusion.py FusedSegment), rebuilt on
        # every start()
        self.fused_segments: list = []
        self.elements: Dict[str, Element] = {}
        self.bus = Bus()
        self.playing = False
        self._eos_evt = threading.Event()
        self._err_evt = threading.Event()
        # single combined wake-up for wait_eos
        self._done_evt = threading.Event()
        self._first_error: Optional[Message] = None
        self._n_sinks = 0
        self._eos_sinks: set = set()
        self.bus.add_watch(self._watch)

    # -- assembly ------------------------------------------------------------

    def add(self, *elements: Element) -> "Pipeline":
        for e in elements:
            if e.name in self.elements:
                raise ValueError(f"duplicate element name {e.name!r}")
            self.elements[e.name] = e
            e.pipeline = self
        return self

    def __getitem__(self, name: str) -> Element:
        return self.elements[name]

    def link(self, *chain: Union[Element, str]) -> "Pipeline":
        """Link elements in sequence using their default src/sink pads."""
        els = [self.elements[c] if isinstance(c, str) else c for c in chain]
        for a, b in zip(els, els[1:]):
            self.link_pads(a, "src", b, "sink")
        return self

    def link_pads(self, a: Union[Element, str], apad: str,
                  b: Union[Element, str], bpad: str) -> "Pipeline":
        """Link ``a.apad`` → ``b.bpad``; re-linking a connected pad
        raises ``ValueError`` naming the existing peer."""
        a = self.elements[a] if isinstance(a, str) else a
        b = self.elements[b] if isinstance(b, str) else b
        a.get_pad(apad).link(b.get_pad(bpad))
        return self

    # -- state ---------------------------------------------------------------

    def start(self) -> "Pipeline":
        if self.playing:
            return self
        self._eos_evt.clear()
        self._err_evt.clear()
        self._done_evt.clear()
        self._eos_sinks.clear()
        self._first_error = None
        sources = [e for e in self.elements.values()
                   if isinstance(e, SourceElement)]
        if not sources:
            raise NegotiationError("pipeline has no source element")
        try:
            self._check_links()
            from .fusion import fuse_pipeline

            fuse_pipeline(self, enable=self.fuse)
            for s in sources:
                s.negotiate()
            self._check_negotiated()
            self._n_sinks = sum(
                1 for e in self.elements.values()
                if not e.srcpads and e.sinkpads)
            # Start sinks/others before sources so data finds everything
            # live.
            for e in self.elements.values():
                if not isinstance(e, SourceElement):
                    e.start()
            for s in sources:
                s.start()
        except Exception:
            # A failed transition must not leak what already opened:
            # roll back to NULL (stop() is safe on never-started
            # elements), then re-raise the original failure.
            self.stop()
            raise
        self.playing = True
        # visible to the metrics registry: scrape-time pull only, the
        # hot path pays nothing
        _metrics.REGISTRY.register_pipeline(self)
        from ..chaos import hooks as _chaos_hooks
        from ..obs import flightrec as _flightrec

        _chaos_hooks.maybe_install_from_env()
        _flightrec.maybe_arm_from_env()
        return self

    def stop(self) -> "Pipeline":
        _metrics.REGISTRY.unregister_pipeline(self)
        for e in self.elements.values():
            if isinstance(e, SourceElement):
                e.stop()
        for e in self.elements.values():
            if not isinstance(e, SourceElement):
                e.stop()
        # Going to NULL clears negotiated caps: a restarted pipeline
        # renegotiates from scratch.
        for e in self.elements.values():
            for p in e.sinkpads + e.srcpads:
                p.caps = None
                p.spec = None
            e._eos_seen.clear()
        self.playing = False
        return self

    def _check_links(self) -> None:
        for e in self.elements.values():
            for p in e.sinkpads:
                if p.peer is None:
                    raise NegotiationError(
                        f"{e.name}.{p.name}: sink pad not linked")

    def _check_negotiated(self) -> None:
        for e in self.elements.values():
            for p in e.sinkpads + e.srcpads:
                if p.peer is not None and p.caps is None:
                    raise NegotiationError(
                        f"{e.name}.{p.name}: caps not negotiated "
                        f"(negotiation did not reach this pad)")

    # -- bus convenience ------------------------------------------------------

    def post(self, msg: Message) -> None:
        self.bus.post(msg)

    def _watch(self, msg: Message) -> None:
        if msg.kind == MessageKind.ERROR:
            if self._first_error is None:
                self._first_error = msg
            self._err_evt.set()
            self._done_evt.set()
        elif msg.kind == MessageKind.EOS:
            self._eos_sinks.add(msg.source)
            if len(self._eos_sinks) >= max(self._n_sinks, 1):
                self._eos_evt.set()
                self._done_evt.set()

    def wait_eos(self, timeout: Optional[float] = None,
                 raise_on_error: bool = True) -> bool:
        """Block until every sink reported EOS (or an error)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._err_evt.is_set():
                if raise_on_error:
                    raise RuntimeError(
                        f"pipeline error: {self._first_error}")
                return False
            if self._eos_evt.is_set():
                return True
            remain = None if deadline is None else deadline - time.monotonic()
            if remain is not None and remain <= 0:
                return False
            self._done_evt.wait(remain)

    @property
    def error(self) -> Optional[Message]:
        return self._first_error

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
