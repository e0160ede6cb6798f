"""Element / Pad model: the dataflow graph nodes of the pipeline runtime.

Counterpart of the JAX package's ``runtime/element.py``: pads with caps
templates, chain-based push scheduling, event propagation, and a forward
caps-negotiation pass standing in for GStreamer's
transform_caps/fixate_caps/set_caps.

Scheduling model: *push*.  Source elements run a thread each; a buffer
travels downstream through direct ``chain()`` calls in that thread until it
hits a ``queue`` element (thread boundary) or a sink.  PyTorch launches
CUDA work asynchronously, so a chain of device-side elements enqueues
kernels without waiting — the Python thread runs ahead while the card
computes.  Every launch goes to the default stream, so a tensor made in
one element's thread is safe to use in the next.

Every element reads its device from the pipeline (:attr:`Element.device`).

Observability seams (``obs/``), each one global read when nothing is
attached: the tracer's pre/post-chain marks and the source's sampling
decision, the transfer ledger's label context around each chain, the
sink's fence completing deferred trace records, and ``post_error`` feeding
the flight recorder and ``nns_element_errors_total``.
"""

from __future__ import annotations

import enum
import threading
from fractions import Fraction
from typing import Any, Dict, List, Optional

import torch

from ..core import Buffer, Caps, TensorsSpec
from ..obs import hooks as _hooks
from ..obs import transfer as _xfer
from ..obs.tracer import FENCE_PENDING, TRACE_META_KEY
from ..utils import profile as _profile
from ..utils.device import card_wait
from . import admission as _admission
from .events import Event, EventKind, Message, MessageKind


class PadDirection(enum.Enum):
    SRC = "src"
    SINK = "sink"


class PadPresence(enum.Enum):
    ALWAYS = "always"
    REQUEST = "request"  # mux sink_%u style
    SOMETIMES = "sometimes"  # demux src_%u style


class NegotiationError(Exception):
    """Caps negotiation failure.

    Carries optional structured context: ``reason`` — symbolic cause
    (``"empty"``, ``"unfixable"``, ``"no-spec"``, ``"unlinked"``,
    ``"open"`` or ``None``); ``src_pad`` / ``sink_pad`` — the pads of the
    failing link; ``upstream`` / ``downstream`` — the caps on each side.
    """

    def __init__(self, message: str, *, reason: Optional[str] = None,
                 src_pad: Optional["Pad"] = None,
                 sink_pad: Optional["Pad"] = None,
                 upstream: Optional["Caps"] = None,
                 downstream: Optional["Caps"] = None):
        super().__init__(message)
        self.reason = reason
        self.src_pad = src_pad
        self.sink_pad = sink_pad
        self.upstream = upstream
        self.downstream = downstream


class StreamError(Exception):
    pass


class Pad:
    """A connection point. ``caps``/``spec`` are set once negotiation fixes
    the stream schema on this pad."""

    __slots__ = ("name", "direction", "element", "peer", "caps", "spec")

    def __init__(self, name: str, direction: PadDirection, element: "Element"):
        self.name = name
        self.direction = direction
        self.element = element
        self.peer: Optional["Pad"] = None
        self.caps: Optional[Caps] = None
        self.spec: Optional[TensorsSpec] = None

    @property
    def template(self) -> Caps:
        return self.element.pad_template_caps(self)

    def link(self, other: "Pad") -> None:
        if self.direction == other.direction:
            raise ValueError(f"cannot link two {self.direction.value} pads")
        src, sink = (self, other) if self.direction == PadDirection.SRC \
            else (other, self)
        if src.peer is not None or sink.peer is not None:
            busy = src if src.peer is not None else sink
            raise ValueError(
                f"cannot link {src.element.name}.{src.name} -> "
                f"{sink.element.name}.{sink.name}: "
                f"{busy.element.name}.{busy.name} is already linked to "
                f"{busy.peer.element.name}.{busy.peer.name} (unlink first)")
        src.peer, sink.peer = sink, src

    def unlink(self) -> None:
        if self.peer is not None:
            self.peer.peer = None
            self.peer = None

    # -- data flow (src pads only) -----------------------------------------

    def push(self, buf: Buffer) -> None:
        peer = self.peer
        if peer is None:
            return  # unlinked src pad drops data (parity: unlinked gst pad)
        peer.element._chain_guarded(peer, buf)

    def push_event(self, event: Event) -> None:
        peer = self.peer
        if peer is not None:
            peer.element.handle_event(peer, event)

    def push_upstream_event(self, event: Event) -> None:
        """sink pad → upstream element (QoS path)."""
        peer = self.peer
        if peer is not None:
            peer.element.handle_upstream_event(peer, event)

    def __repr__(self):
        return f"<Pad {self.element.name}.{self.name} {self.direction.value}>"


class Element:
    """Base class of all pipeline elements."""

    # Factory name used by the registry / pipeline parser.
    FACTORY: str = ""

    def __init__(self, name: Optional[str] = None, **props):
        # Attributes the subclass assigned *before* chaining up are its
        # declared, settable properties (the GObject install_property
        # analog), plus the universal "name".  Internal state created
        # from here on is NOT settable via set_property — a typo matching
        # an internal attr must raise, not silently overwrite state.
        self._props_declared = frozenset(vars(self)) | {"name"}
        self.name = name or f"{self.FACTORY or type(self).__name__}0"
        self.sinkpads: List[Pad] = []
        self.srcpads: List[Pad] = []
        self.pipeline = None  # set by Pipeline.add
        self._eos_seen: set = set()
        self._lock = threading.Lock()
        # flow counters: fan-in elements are fed by several source
        # threads at once, and `d[k] += 1` is a racy read-modify-write
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, Any] = {"buffers_in": 0, "buffers_out": 0}
        # per-element config file (parity: gst_tensor_parse_config_file):
        # the file overrides constructor values; set_property afterwards
        # (incl. later keys in a pipeline string) overrides the file
        cfg = props.pop("config_file", None) or props.pop("config-file",
                                                          None)
        if cfg:
            self.load_config_file(str(cfg))
        for k, v in props.items():
            self.set_property(k, v)

    # -- properties (parity: GObject properties) ---------------------------

    def set_property(self, key: str, value: Any) -> None:
        attr = key.replace("-", "_")
        if attr not in self._props_declared:
            raise ValueError(f"{type(self).__name__} has no property {key!r}")
        setattr(self, attr, value)

    def get_property(self, key: str) -> Any:
        return getattr(self, key.replace("-", "_"))

    def load_config_file(self, path: str, skip=()) -> None:
        """Apply ``key=value`` lines (# comments, blank lines skipped) as
        properties, with the pipeline-string value grammar.  ``skip``
        names properties that must keep their current values (the parser
        passes the keys given explicitly alongside config-file)."""
        from .parser import _parse_value

        skip = {k.replace("-", "_") for k in skip}
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" not in line:
                    raise ValueError(
                        f"{path}:{ln}: expected key=value, got {line!r}")
                k, _, v = line.partition("=")
                if k.strip().replace("-", "_") in skip:
                    continue
                self.set_property(k.strip(), _parse_value(v.strip()))

    @property
    def device(self) -> torch.device:
        """The device this element computes on: its pipeline's."""
        if self.pipeline is None:
            raise RuntimeError(f"{self.name}: not added to a pipeline, so "
                               "it has no device")
        return self.pipeline.device

    # -- pads ---------------------------------------------------------------

    def add_sink_pad(self, name: str = "sink") -> Pad:
        p = Pad(self._pad_name(name, self.sinkpads), PadDirection.SINK,
                self)
        self.sinkpads.append(p)
        return p

    def add_src_pad(self, name: str = "src") -> Pad:
        p = Pad(self._pad_name(name, self.srcpads), PadDirection.SRC, self)
        self.srcpads.append(p)
        return p

    @staticmethod
    def _pad_name(name: str, pads: List[Pad]) -> str:
        """Expand the ``%u`` pad-template wildcard to the lowest free
        index (``sink_%u`` → ``sink_0``, ``sink_1``, ...)."""
        if "%u" not in name:
            return name
        used = {p.name for p in pads}
        n = 0
        while name.replace("%u", str(n)) in used:
            n += 1
        return name.replace("%u", str(n))

    def get_pad(self, name: str) -> Pad:
        for p in self.sinkpads + self.srcpads:
            if p.name == name:
                return p
        rp = self.request_pad(name)
        if rp is not None:
            return rp
        raise KeyError(f"{self.name} has no pad {name!r}")

    def request_pad(self, name: str) -> Optional[Pad]:
        """Override in elements with REQUEST pads (mux sink_%u)."""
        return None

    @property
    def sinkpad(self) -> Pad:
        return self.sinkpads[0]

    @property
    def srcpad(self) -> Pad:
        return self.srcpads[0]

    def pad_template_caps(self, pad: Pad) -> Caps:
        """What this pad can accept/produce *before* negotiation.  Default
        is the full wildcard (generic sinks/plumbing accept any media)."""
        return Caps.any()

    # -- negotiation ---------------------------------------------------------

    def propose_src_caps(self, pad: Pad) -> Caps:
        """Caps this element wants to output on ``pad`` given its negotiated
        sink specs (parity: transform_caps in SRC direction). Default:
        passthrough of the first sink pad's caps."""
        if self.sinkpads and self.sinkpads[0].caps is not None:
            return self.sinkpads[0].caps
        return self.pad_template_caps(pad)

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        """Fixed caps arrive on a sink pad; validate then negotiate our own
        src pads."""
        tpl = self.pad_template_caps(pad)
        m = tpl.intersect(caps)
        if m.is_empty():
            raise NegotiationError(
                f"{self.name}.{pad.name}: caps {caps} not accepted "
                f"(template {tpl})",
                reason="empty", sink_pad=pad, upstream=caps, downstream=tpl)
        pad.caps = caps
        try:
            pad.spec = caps.to_spec()
        except ValueError:
            pad.spec = None  # non-tensor media caps
        try:
            self.caps_negotiated(pad)
        except NegotiationError:
            raise
        except (ValueError, TypeError, KeyError) as e:
            raise NegotiationError(
                f"{self.name}.{pad.name}: cannot handle caps {caps}: {e}"
            ) from e
        if self._sink_caps_complete():
            self.negotiate_src_pads()

    def _sink_caps_complete(self) -> bool:
        return all(p.caps is not None for p in self.sinkpads if p.peer)

    def caps_negotiated(self, pad: Pad) -> None:
        """Hook: element saw fixed caps on a sink pad."""

    def negotiate_src_pads(self) -> None:
        for sp in self.srcpads:
            if sp.peer is None or sp.caps is not None:
                continue
            proposed = self.propose_src_caps(sp)
            allowed = proposed.intersect(sp.peer.template)
            if allowed.is_empty():
                raise NegotiationError(
                    f"link {self.name}.{sp.name} → "
                    f"{sp.peer.element.name}.{sp.peer.name}: cannot agree "
                    f"(proposed {proposed}; downstream {sp.peer.template})",
                    reason="empty", src_pad=sp, sink_pad=sp.peer,
                    upstream=proposed, downstream=sp.peer.template)
            try:
                fixed = allowed.fixate()
            except ValueError as e:
                raise NegotiationError(
                    f"link {self.name}.{sp.name} → "
                    f"{sp.peer.element.name}.{sp.peer.name}: cannot fixate "
                    f"caps {allowed}: {e}",
                    reason="unfixable", src_pad=sp, sink_pad=sp.peer,
                    upstream=allowed) from e
            sp.caps = fixed
            try:
                sp.spec = fixed.to_spec()
            except ValueError:
                sp.spec = None
            sp.peer.element.set_caps(sp.peer, fixed)

    # -- data flow -----------------------------------------------------------

    def count_stat(self, key: str, n: int = 1) -> None:
        """Thread-safe bump of a flow counter."""
        with self._stats_lock:
            self.stats[key] = self.stats.get(key, 0) + n

    def _chain_guarded(self, pad: Pad, buf: Buffer) -> None:
        # transfer-ledger label context (obs/transfer.py): crossings made
        # while this element owns the buffer are attributed to
        # (pipeline, element); one flag read when obs is off
        x_on = _xfer.ACTIVE
        xctx = None
        try:
            self.count_stat("buffers_in")
            # tracer hook (obs/hooks.py): read ONCE so an attach
            # mid-buffer keeps the pre/post pair together
            tracer = _hooks.tracer
            if x_on:
                tr = buf.meta.get(TRACE_META_KEY) \
                    if tracer is not None else None
                xctx = _xfer.push_context(
                    self.pipeline.name if self.pipeline is not None
                    else "", self.name, (tr,) if tr is not None else None)
            if tracer is not None:
                tracer.pre_chain(self, buf)
            with _profile.span("chain", self.name):
                self.chain(pad, buf)
            if tracer is not None:
                tracer.post_chain(self, buf)
        except Exception as e:  # noqa: BLE001 - any failure must surface
            # as an ERROR bus message, not silently kill the upstream
            # streaming thread
            self.post_error(e)
        finally:
            if x_on:
                _xfer.pop_context(xctx)

    def chain(self, pad: Pad, buf: Buffer) -> None:
        raise NotImplementedError(f"{type(self).__name__} has no chain")

    def push(self, buf: Buffer, pad: Optional[Pad] = None) -> None:
        self.count_stat("buffers_out")
        (pad or self.srcpad).push(buf)

    # -- events --------------------------------------------------------------

    def handle_event(self, pad: Pad, event: Event) -> None:
        """Default: EOS is forwarded downstream once *all* linked sink pads
        saw it; other events forward immediately."""
        if event.kind == EventKind.EOS:
            with self._lock:
                self._eos_seen.add(pad.name)
                linked = {p.name for p in self.sinkpads if p.peer}
                ready = linked <= self._eos_seen
            if ready:
                self.on_eos()
                self.forward_event(event)
        else:
            self.forward_event(event)

    def on_eos(self) -> None:
        """Hook: flush buffered state before EOS propagates."""

    def forward_event(self, event: Event) -> None:
        for sp in self.srcpads:
            sp.push_event(event)

    def handle_upstream_event(self, pad: Pad, event: Event) -> None:
        for p in self.sinkpads:
            p.push_upstream_event(event)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """Pipeline going to PLAYING (after negotiation)."""

    def stop(self) -> None:
        """Pipeline going to NULL."""

    # -- bus ------------------------------------------------------------------

    def post_message(self, msg: Message) -> None:
        if self.pipeline is not None:
            self.pipeline.post(msg)

    def post_error(self, err: BaseException) -> None:
        # bus FIRST: consumers watching for the ERROR must not wait on any
        # recorder work
        self.post_message(Message(MessageKind.ERROR, self.name, error=err))
        # black-box evidence (obs/flightrec.py) and errors as a series
        try:
            from ..obs.flightrec import FLIGHT
            from ..obs.metrics import REGISTRY

            REGISTRY.counter(
                "nns_element_errors_total",
                "errors posted to a pipeline bus by an element",
                labelnames=("pipeline", "element"),
            ).labels(
                pipeline=getattr(self.pipeline, "name", "") or "",
                element=self.name,
            ).inc()
            FLIGHT.element_error(self.name, err)
        except Exception:  # noqa: BLE001 - the black box must never
            # break the error path it records
            pass

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class SourceElement(Element):
    """Push source with its own streaming thread (parity: GstPushSrc).

    Subclasses implement :meth:`create` returning a Buffer, or ``None`` for
    EOS.  ``output_spec()`` must return the fixed stream schema (sources start
    negotiation).  An upstream QoS throttle event caps the production rate.
    """

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_src_pad()
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._throttle_rate: Optional[Fraction] = None
        self._throttle_lock = threading.Lock()

    def output_caps(self) -> Caps:
        spec = self.output_spec()
        if spec is None:
            raise NegotiationError(
                f"{self.name}: source has no output spec", reason="no-spec")
        return Caps.from_spec(spec)

    def output_spec(self) -> Optional[TensorsSpec]:
        return None

    def create(self) -> Optional[Buffer]:
        raise NotImplementedError

    def negotiate(self) -> None:
        sp = self.srcpad
        if sp.peer is None:
            raise NegotiationError(f"{self.name}: source not linked",
                                   reason="unlinked", src_pad=sp)
        proposed = self.output_caps()
        allowed = proposed.intersect(sp.peer.template)
        if allowed.is_empty():
            raise NegotiationError(
                f"{self.name} → {sp.peer.element.name}: cannot agree "
                f"(source {proposed}; downstream {sp.peer.template})",
                reason="empty", src_pad=sp, sink_pad=sp.peer,
                upstream=proposed, downstream=sp.peer.template)
        try:
            fixed = allowed.fixate()
        except ValueError as e:
            raise NegotiationError(
                f"{self.name} → {sp.peer.element.name}: cannot fixate caps "
                f"{allowed}: {e}",
                reason="unfixable", src_pad=sp, sink_pad=sp.peer,
                upstream=allowed) from e
        sp.caps = fixed
        try:
            sp.spec = fixed.to_spec()
        except ValueError:
            sp.spec = None
        sp.peer.element.set_caps(sp.peer, fixed)

    def handle_upstream_event(self, pad: Pad, event: Event) -> None:
        if event.kind == EventKind.QOS_THROTTLE:
            with self._throttle_lock:
                self._throttle_rate = event.data.get("rate")
        # sources terminate upstream propagation

    def start(self) -> None:
        self._running.set()
        # deterministic name (nns:<pipeline>:<element>) + thread-
        # registry coverage: obs/prof.py joins profiler samples, lockdep
        # site labels and py-spy output on this string
        from ..obs import prof as _prof

        self._thread = _prof.element_thread(self, self._loop, "src")
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        import time

        from ..obs import prof as _prof

        # exact run/wait accounting (obs/prof.py): create()+throttle is
        # the wait side, push() — the whole downstream chain runs in
        # this thread — is the run side, less its card waits.  None
        # under NNS_TPU_TORCH_OBS_DISABLE → the loop skips every clock
        # read.
        pipe = getattr(self, "pipeline", None)
        acct = _prof.element_account(
            getattr(pipe, "name", "") or "-", self.name)
        gate = _profile.GATE
        t0 = c0 = 0.0
        last = None
        while self._running.is_set():
            if acct is not None:
                t0 = time.monotonic()
                c0 = time.thread_time()
            # an iteration runs torch work (create() may, the chain
            # does): inside the profiler's gate, its waits outside
            gate.enter()
            try:
                try:
                    with _profile.span("create", self.name):
                        buf = self.create()
                except Exception as e:  # noqa: BLE001 - report, don't kill pipeline
                    self.post_error(e)
                    break
                if buf is None:
                    self.srcpad.push_event(Event.eos())
                    break
                with self._throttle_lock:
                    rate = self._throttle_rate
                if rate and rate > 0:
                    now = time.monotonic()
                    if last is not None:
                        wait = float(1 / rate) - (now - last)
                        if wait > 0:
                            with gate.outside():
                                time.sleep(wait)
                    last = time.monotonic()
                if _admission.ACTIVE:
                    # deadline anchor for SLO-aware admission, stamped
                    # after the throttle and only while a controller is
                    # armed
                    buf.meta[_admission.INGRESS_TS_META] = time.monotonic()
                tracer = _hooks.tracer
                if tracer is not None:
                    # the trace starts here, after the throttle: the
                    # latency a sampled buffer reports is pipeline time
                    tracer.source_created(self, buf)
                if acct is None:
                    self.push(buf)
                else:
                    acct.run_chain(self.push, buf, t0, c0)
            finally:
                gate.exit()


class SinkElement(Element):
    """Base sink (parity: GstBaseSink): implement :meth:`render`.

    Sinks are where the asynchronous device path fences: by the time a
    buffer reaches a sink, the kernels that compute it may still be
    queued on the card.  The fence is *depth-1 pipelined*: the sink
    records a CUDA event behind buffer N's work, and rendering buffer N
    waits for buffer N-1's event — never N's own — so the streaming
    thread prepares window N while the card runs window N-1, run-ahead
    stays bounded at one window, and a device fault surfaces here, on this
    sink's bus, one window late at most.  EOS waits for the retained
    event, so ``wait_eos()`` returning means every window finished.  The
    event rides the buffer as ``meta["device_done"]``: a caller can time
    windows on the device with it.

    With a tracer attached, a sampled buffer that carries such an event
    has its trace record closed by the fence on that event, after it fired
    (``obs/tracer.py``), not when the chain returns.
    """

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad()
        self._pending_fence: Optional[torch.cuda.Event] = None
        # trace dicts whose records wait for the pending fence
        self._pending_traces: tuple = ()
        self._fence_lock = threading.Lock()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        cur = None
        for t in reversed(buf.tensors):
            if t.is_device and t.torch().is_cuda:
                # every launch is on the default stream, so an event
                # recorded now completes after all of this buffer's work
                with torch.cuda.device(t.torch().device):
                    cur = torch.cuda.Event(enable_timing=True)
                    cur.record()
                buf.meta["device_done"] = cur
                break
        traces = ()
        if cur is not None and _hooks.tracer is not None:
            tr = buf.meta.get(TRACE_META_KEY)
            if tr is not None:
                tr[FENCE_PENDING] = True
                traces = (tr,)
        with self._fence_lock:
            prev, self._pending_fence = self._pending_fence, cur
            prev_traces, self._pending_traces = self._pending_traces, traces
        self._fence(prev, prev_traces)
        self.render(buf)

    def _fence(self, ev, traces=()) -> None:
        if ev is None:
            return
        tracer = _hooks.tracer
        if tracer is None:
            with _profile.span("fence", self.name):
                card_wait(ev.synchronize)
            return
        import time

        t0 = time.monotonic()
        with _profile.span("fence", self.name):
            card_wait(ev.synchronize)
        tracer.sink_fenced(self, time.monotonic() - t0, traces)

    def render(self, buf: Buffer) -> None:
        raise NotImplementedError

    def handle_event(self, pad: Pad, event: Event) -> None:
        if event.kind == EventKind.EOS:
            with self._fence_lock:
                prev, self._pending_fence = self._pending_fence, None
                traces, self._pending_traces = self._pending_traces, ()
            try:
                # wait for the retained window BEFORE EOS posts: "EOS on
                # the bus" must mean the card finished every window
                self._fence(prev, traces)
            except Exception as e:  # noqa: BLE001 - a device fault
                # surfacing at the EOS fence still belongs on this sink's
                # bus (event delivery has no _chain_guarded)
                self.post_error(e)
            self.on_eos()
            self.post_message(Message(MessageKind.EOS, self.name))


class TransformElement(Element):
    """1-in/1-out element (parity: GstBaseTransform): implement
    :meth:`transform`; override :meth:`propose_src_caps` when not
    passthrough-caps."""

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()

    def chain(self, pad: Pad, buf: Buffer) -> None:
        out = self.transform(buf)
        if out is not None:
            self.push(out)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        raise NotImplementedError
