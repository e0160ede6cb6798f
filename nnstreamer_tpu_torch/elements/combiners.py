"""N↔1 stream combinators: tensor_mux, tensor_merge, tensor_demux,
tensor_split, join.

Counterpart of the JAX package's ``elements/combiners.py`` (parity: the
reference's gsttensor_mux.c, gsttensor_merge.c, gsttensor_demux.c,
gsttensor_split.c and gst/join/gstjoin.c), on the port's time-sync engine
(``elements/sync.py``).

On the device: ``tensor_merge`` concatenates with one ``torch.cat`` on the
card as soon as any branch is on the device (the host minority is copied
up, the device majority never drained), and ``tensor_split`` hands out
slices of the tensor where it lives.

Shared storage: torch tensors are mutable, and a ``tensor_transform
donate=true`` downstream writes into a tensor it holds alone.  So every
tensor these elements hand to more than one consumer is marked shared
(``Tensor.shared_view``): a tensor that a repeated ``tensorpick`` sends to
two pads, the slices of ``tensor_split``, and the buffers ``tensor_mux``
may reuse under a timestamped or refresh sync mode.

Order: a collect element's upstream pads run on their own threads; its
sets are combined and pushed under one lock, so the merged stream leaves
in the order the sync engine completed the sets (the JAX element pushes
outside its collector's lock, where two threads may interleave).
"""

from __future__ import annotations

import threading
from collections import Counter
from fractions import Fraction
from typing import List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, Tensor, TensorSpec, TensorsSpec
from ..runtime.element import Element, NegotiationError, Pad
from ..runtime.events import Event, EventKind
from ..runtime.registry import register_element
from .sync import Collector, SyncPolicy


class CollectElement(Element):
    """Base for N-sink elements with the four time-sync policies.  Request
    sink pads are created on demand (``sink_0``, ``sink_1``, …)."""

    def __init__(self, name=None, sync_mode: str = "nosync",
                 sync_option: str = "", **props):
        self.sync_mode = sync_mode
        self.sync_option = sync_option
        super().__init__(name, **props)
        self.add_src_pad()
        self._collector: Optional[Collector] = None
        # one downstream stream: the sets leave in the collector's order
        # even when two upstream threads complete sets at once
        self._emit_lock = threading.Lock()

    def request_pad(self, name: str) -> Optional[Pad]:
        if not name.startswith("sink"):
            return None
        # add_sink_pad expands the %u template to the lowest free index
        pad = self.add_sink_pad("sink_%u" if name == "sink" else name)
        if self._collector is not None:
            self._collector.add_pad(pad.name)
        return pad

    def start(self) -> None:
        self._collector = Collector(
            SyncPolicy.parse(self.sync_mode, self.sync_option),
            [p.name for p in self.sinkpads])

    def chain(self, pad: Pad, buf: Buffer) -> None:
        with self._emit_lock:
            for bufset in self._collector.deposit(pad.name, buf):
                ordered = [bufset[p.name] for p in self.sinkpads
                           if p.name in bufset]
                out = self.combine(ordered)
                if out is not None:
                    self.push(out)

    def handle_event(self, pad: Pad, event: Event) -> None:
        if event.kind == EventKind.EOS:
            if self._collector is None or self._collector.mark_eos(pad.name):
                self.on_eos()
                self.forward_event(event)
            return
        super().handle_event(pad, event)

    def combine(self, bufs: List[Buffer]) -> Optional[Buffer]:
        raise NotImplementedError

    def _out_pts(self, bufs: List[Buffer]) -> Optional[int]:
        ts = [b.pts for b in bufs if b.pts is not None]
        return min(ts) if ts else None


@register_element("tensor_mux")
class TensorMux(CollectElement):
    """N single/multi-tensor streams → one frame carrying all tensors."""

    FACTORY = "tensor_mux"

    def propose_src_caps(self, pad: Pad) -> Caps:
        tensors, rate = [], Fraction(0, 1)
        for sp in self.sinkpads:
            if sp.spec is None:
                raise NegotiationError(f"{self.name}: sink caps incomplete")
            tensors.extend(sp.spec.tensors)
            rate = rate or sp.spec.rate
        return Caps.from_spec(TensorsSpec(tensors=tuple(tensors), rate=rate))

    def combine(self, bufs: List[Buffer]) -> Buffer:
        # nosync consumes every buffer once; the other modes may hand a
        # pad's buffer to two frames (a pad that ran ahead, refresh)
        reuse = self._collector.policy.mode != "nosync"
        tensors: List[Tensor] = []
        for b in bufs:
            tensors.extend(t.shared_view() if reuse else t
                           for t in b.tensors)
        return Buffer(tensors=tensors, pts=self._out_pts(bufs))


@register_element("tensor_merge")
class TensorMerge(CollectElement):
    """N streams → 1 tensor concatenated along a dim.  ``option`` is the
    innermost-first dim index (mode=linear; direction enum parity)."""

    FACTORY = "tensor_merge"

    def __init__(self, name=None, mode: str = "linear", option: str = "0",
                 **props):
        self.mode = mode
        self.option = option
        super().__init__(name, **props)

    def _axis(self, spec: TensorSpec) -> int:
        d = int(str(self.option) or 0)
        return len(spec.dims) - 1 - d  # innermost-first → tensor axis

    def propose_src_caps(self, pad: Pad) -> Caps:
        if self.mode != "linear":
            raise NegotiationError(f"{self.name}: unknown mode {self.mode!r}")
        specs = []
        rate = Fraction(0, 1)
        for sp in self.sinkpads:
            if sp.spec is None or not sp.spec.tensors:
                raise NegotiationError(f"{self.name}: sink caps incomplete")
            specs.append(sp.spec.tensors[0])
            rate = rate or sp.spec.rate
        ax = self._axis(specs[0])
        dims = list(specs[0].dims)
        d = len(dims) - 1 - ax
        dims[d] = sum(s.dims[d] for s in specs)
        for s in specs[1:]:
            if s.dtype != specs[0].dtype:
                raise NegotiationError(f"{self.name}: dtype mismatch")
            for i, (a, b) in enumerate(zip(specs[0].dims, s.dims)):
                if i != d and a != b:
                    raise NegotiationError(
                        f"{self.name}: dims differ off-axis: {specs[0].dims} "
                        f"vs {s.dims}")
        out = TensorSpec(dtype=specs[0].dtype, dims=tuple(dims))
        return Caps.from_spec(TensorsSpec.of(out, rate=rate))

    def combine(self, bufs: List[Buffer]) -> Buffer:
        parts = [b.tensors[0] for b in bufs]
        ax = self._axis(parts[0].spec)
        dev = next((t.torch().device for t in parts if t.is_device), None)
        if dev is not None:
            # device fan-in: as soon as ANY branch is on the device,
            # concatenate there — uploading the host minority costs their
            # bytes once; draining the device majority would cost a copy
            # a frame and push the merged stream off the device
            merged = Tensor(torch.cat([t.torch(dev) for t in parts],
                                      dim=ax))
        else:
            merged = Tensor(np.concatenate([t.np() for t in parts], axis=ax))
        return Buffer(tensors=[merged], pts=self._out_pts(bufs))


def parse_tensorpick(s: str) -> List[List[int]]:
    """``"0,2"`` picks tensors 0 and 2 (one per src pad); ``"0:1,2"``
    groups 0+1 onto the first pad (parity: demux tensorpick grammar)."""
    if not str(s).strip():
        return []
    return [[int(x) for x in grp.split(":") if x.strip() != ""]
            for grp in str(s).split(",") if grp.strip()]


@register_element("tensor_demux")
class TensorDemux(Element):
    """1 multi-tensor stream → N streams (SOMETIMES src pads ``src_%u``)."""

    FACTORY = "tensor_demux"

    def __init__(self, name=None, tensorpick: str = "", **props):
        self.tensorpick = tensorpick
        super().__init__(name, **props)
        self.add_sink_pad()

    def request_pad(self, name: str) -> Optional[Pad]:
        if not name.startswith("src"):
            return None
        return self.add_src_pad(name)

    def _groups(self, num_tensors: int) -> List[List[int]]:
        picks = parse_tensorpick(self.tensorpick)
        if picks:
            return picks
        return [[i] for i in range(num_tensors)]

    def negotiate_src_pads(self) -> None:
        in_spec = self.sinkpad.spec
        if in_spec is None:
            raise NegotiationError(f"{self.name}: sink caps not set")
        groups = self._groups(in_spec.num_tensors)
        for i, sp in enumerate(self.srcpads):
            if sp.peer is None or sp.caps is not None:
                continue
            if i >= len(groups):
                raise NegotiationError(
                    f"{self.name}: more src pads than tensor picks")
            spec = TensorsSpec(
                tensors=tuple(in_spec.tensors[j] for j in groups[i]),
                rate=in_spec.rate)
            fixed = Caps.from_spec(spec).intersect(sp.peer.template)
            if fixed.is_empty():
                raise NegotiationError(
                    f"{self.name}.{sp.name}: downstream refuses {spec}")
            sp.caps = fixed.fixate()
            sp.spec = sp.caps.to_spec()
            sp.peer.element.set_caps(sp.peer, sp.caps)

    def chain(self, pad: Pad, buf: Buffer) -> None:
        groups = self._groups(buf.num_tensors)[:len(self.srcpads)]
        # a tensor picked onto two pads goes to each as its own handle,
        # marked shared (see the module doc)
        uses = Counter(j for g in groups for j in g)
        for sp, grp in zip(self.srcpads, groups):
            tensors = [buf.tensors[j].shared_view() if uses[j] > 1
                       else buf.tensors[j] for j in grp]
            self.push(Buffer(tensors=tensors, pts=buf.pts,
                             duration=buf.duration, meta=dict(buf.meta)),
                      pad=sp)


@register_element("tensor_split")
class TensorSplit(Element):
    """Split one tensor along a dim by ``tensorseg`` sizes
    (``"64:64:128"``; innermost-first dim index via ``dimension``)."""

    FACTORY = "tensor_split"

    def __init__(self, name=None, tensorseg: str = "", dimension: str = "0",
                 **props):
        self.tensorseg = tensorseg
        self.dimension = dimension
        super().__init__(name, **props)
        self.add_sink_pad()

    def request_pad(self, name: str) -> Optional[Pad]:
        if not name.startswith("src"):
            return None
        return self.add_src_pad(name)

    def _segs(self) -> List[int]:
        return [int(x) for x in str(self.tensorseg).split(":") if x.strip()]

    def negotiate_src_pads(self) -> None:
        in_spec = self.sinkpad.spec
        if in_spec is None:
            raise NegotiationError(f"{self.name}: sink caps not set")
        t = in_spec.tensors[0]
        d = int(str(self.dimension))
        segs = self._segs()
        if sum(segs) != t.dims[d]:
            raise NegotiationError(
                f"{self.name}: tensorseg {segs} does not sum to dim "
                f"{t.dims[d]}")
        for i, sp in enumerate(self.srcpads):
            if sp.peer is None or sp.caps is not None:
                continue
            dims = list(t.dims)
            dims[d] = segs[i]
            spec = TensorsSpec.of(t.with_dims(dims), rate=in_spec.rate)
            sp.caps = Caps.from_spec(spec).fixate()
            sp.spec = sp.caps.to_spec()
            sp.peer.element.set_caps(sp.peer, sp.caps)

    def chain(self, pad: Pad, buf: Buffer) -> None:
        t = buf.tensors[0]
        d = int(str(self.dimension))
        ax = len(t.spec.dims) - 1 - d
        offs = np.cumsum([0] + self._segs())
        # slice where the tensor lives: views of one storage, so each
        # slice is marked shared (see the module doc)
        arr = t.torch() if t.is_device else t.np()
        for i, sp in enumerate(self.srcpads):
            sl = [slice(None)] * arr.ndim
            sl[ax] = slice(int(offs[i]), int(offs[i + 1]))
            part = Tensor(arr[tuple(sl)])
            part._shared = True
            self.push(Buffer(tensors=[part], pts=buf.pts,
                             duration=buf.duration, meta=dict(buf.meta)),
                      pad=sp)


@register_element("join")
class Join(Element):
    """N→1 path combiner: forward whichever input arrives, no sync
    (parity: gst/join/gstjoin.c — used after tensor_if branches)."""

    FACTORY = "join"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_src_pad()

    def request_pad(self, name: str) -> Optional[Pad]:
        if not name.startswith("sink"):
            return None
        return self.add_sink_pad("sink_%u" if name == "sink" else name)

    def propose_src_caps(self, pad: Pad) -> Caps:
        for sp in self.sinkpads:
            if sp.caps is not None:
                return sp.caps
        raise NegotiationError(f"{self.name}: no sink caps yet")

    def _sink_caps_complete(self) -> bool:
        # join negotiates from the FIRST pad that fixes caps
        return any(p.caps is not None for p in self.sinkpads if p.peer)

    def chain(self, pad: Pad, buf: Buffer) -> None:
        self.push(buf)
