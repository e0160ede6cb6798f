"""``tensor_crop`` — data-driven cropping of a raw stream.

Counterpart of the JAX package's ``elements/crop.py`` (parity target: the
reference's gsttensor_crop.c): two sink pads — ``sink_raw`` carries the
stream, ``sink_info`` a *flexible* tensor stream of crop regions (x, y,
w, h per region, produced e.g. by the tensor_region decoder) — collected
with the time-sync engine; the output is a flexible stream of cropped
patches (one tensor per region, shapes vary per buffer).

A raw tensor that lives on a device is cropped there.  Each patch is a
contiguous tensor of its own: a slice would be a view that keeps the
whole frame alive and would see any later in-place write to it (the JAX
package's slices are new arrays).  Collection and push run under one
lock, so patches leave in the order the frames were paired even when the
two pads are fed from two threads.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, Tensor, TensorFormat, TensorsSpec
from ..runtime.element import Element, Pad, StreamError
from ..runtime.events import Event, EventKind
from ..runtime.registry import register_element
from .sync import Collector, SyncPolicy


@register_element("tensor_crop")
class TensorCrop(Element):
    FACTORY = "tensor_crop"

    def __init__(self, name=None, lateness: int = 0,
                 sync_mode: str = "nosync", sync_option: str = "", **props):
        self.lateness = lateness
        self.sync_mode = sync_mode
        self.sync_option = sync_option
        super().__init__(name, **props)
        self.add_sink_pad("sink_raw")
        self.add_sink_pad("sink_info")
        self.add_src_pad()
        self._collector: Optional[Collector] = None
        self._emit = threading.Lock()

    @property
    def raw_pad(self) -> Pad:
        return self.sinkpads[0]

    @property
    def info_pad(self) -> Pad:
        return self.sinkpads[1]

    def start(self) -> None:
        self._collector = Collector(
            SyncPolicy.parse(self.sync_mode, self.sync_option),
            [p.name for p in self.sinkpads])

    def propose_src_caps(self, pad: Pad) -> Caps:
        raw_spec = self.raw_pad.spec
        rate = raw_spec.rate if raw_spec is not None else 0
        return Caps.from_spec(TensorsSpec(
            format=TensorFormat.FLEXIBLE, rate=rate))

    def chain(self, pad: Pad, buf: Buffer) -> None:
        with self._emit:
            for bufset in self._collector.deposit(pad.name, buf):
                raw = bufset.get("sink_raw")
                info = bufset.get("sink_info")
                if raw is None or info is None:
                    continue
                self.push(self._crop(raw, info))

    def _crop(self, raw: Buffer, info: Buffer) -> Buffer:
        """info tensor: (N, 4) of x, y, w, h (uint32/float), one crop per
        region, over the raw stream's innermost-3 dims (ch:w:h frame)."""
        regions = np.asarray(info.tensors[0].np()).reshape(-1, 4)
        t = raw.tensors[0]
        shape = t.spec.shape  # row-major; frame is (..., h, w, ch)
        if len(shape) < 3:
            raise StreamError(
                f"{self.name}: raw stream must be at least rank 3 "
                f"(h, w, ch); got {shape}")
        h_ax, w_ax = len(shape) - 3, len(shape) - 2
        out: List[Tensor] = []
        dev = t.is_device
        arr = t.torch() if dev else t.np()
        for (x, y, w, hgt) in regions:
            x, y, w, hgt = int(x), int(y), int(w), int(hgt)
            x = max(0, min(x, shape[w_ax] - 1))
            y = max(0, min(y, shape[h_ax] - 1))
            w = max(1, min(w, shape[w_ax] - x))
            hgt = max(1, min(hgt, shape[h_ax] - y))
            sl = [slice(None)] * len(shape)
            sl[h_ax] = slice(y, y + hgt)
            sl[w_ax] = slice(x, x + w)
            patch = arr[tuple(sl)]
            out.append(Tensor(
                patch.clone(memory_format=torch.contiguous_format) if dev
                else patch.copy()))
        return Buffer(tensors=out, pts=raw.pts, duration=raw.duration,
                      offset=raw.offset, format=TensorFormat.FLEXIBLE,
                      meta=dict(raw.meta))

    def handle_event(self, pad: Pad, event: Event) -> None:
        if event.kind == EventKind.EOS:
            if self._collector is None or self._collector.mark_eos(pad.name):
                self.forward_event(event)
            return
        super().handle_event(pad, event)
