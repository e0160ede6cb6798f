"""``tensor_aggregator`` — temporal batching / windowing.

Counterpart of the JAX package's ``elements/aggregator.py`` (parity: the
reference's gsttensor_aggregator.c, properties ``frames-in``,
``frames-out``, ``frames-flush``, ``frames-dim``, ``concat``): the element
reinterprets the stream's frame axis, e.g. 30 fps of d=300:300 → 15 fps
of d=300:300:2, with a sliding-window overlap when ``frames-flush <
frames-out``.  Output timestamps are the JAX element's: a window carries
its first frame's time, synthesized from the input rate (or the buffer's
duration) for windows an input buffer completes after its first.

This element is how a stream of single camera frames becomes a
model-sized batch ahead of ``tensor_filter``.  On the device the window
is a list of frame views, and a full window leaves as ONE ``torch.cat`` on
the card; no frame crosses to the host.  With ``concat=false`` the window
leaves as its frames' views, marked shared (a frame of an overlapping
window is handed out twice).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, Tensor, TensorSpec, TensorsSpec
from ..core.buffer import from_numpy
from ..runtime.element import NegotiationError, Pad, TransformElement
from ..runtime.registry import register_element


@register_element("tensor_aggregator")
class TensorAggregator(TransformElement):
    FACTORY = "tensor_aggregator"

    def __init__(self, name=None, frames_in: int = 1, frames_out: int = 1,
                 frames_flush: int = 0, frames_dim: Optional[int] = None,
                 concat: bool = True, **props):
        self.frames_in = frames_in
        self.frames_out = frames_out
        self.frames_flush = frames_flush
        self.frames_dim = frames_dim
        self.concat = concat
        super().__init__(name, **props)
        self._window: list = []  # frame-granular: tensors or ndarrays
        self._pts0: Optional[int] = None

    # -- negotiation ---------------------------------------------------------

    def _dim_axis(self, spec: TensorSpec) -> int:
        d = self.frames_dim if self.frames_dim is not None \
            else len(spec.dims) - 1
        return len(spec.dims) - 1 - int(d)  # innermost-first → tensor axis

    def _is_passthrough(self) -> bool:
        fin, fout = int(self.frames_in), int(self.frames_out)
        flush = int(self.frames_flush) or fout
        return bool(self.concat) and fin == fout and flush == fout

    def _per_frame_dims(self, t: TensorSpec):
        d = self.frames_dim if self.frames_dim is not None \
            else len(t.dims) - 1
        dims = list(t.dims)
        dims[int(d)] = dims[int(d)] // max(int(self.frames_in), 1)
        return int(d), dims

    def propose_src_caps(self, pad: Pad) -> Caps:
        in_spec = self.sinkpad.spec
        if in_spec is None:
            raise NegotiationError(f"{self.name}: no input caps")
        t = in_spec.tensors[0]
        fin, fout = int(self.frames_in), int(self.frames_out)
        flush = int(self.frames_flush) or fout
        rate = in_spec.rate
        if self._is_passthrough():
            return Caps.from_spec(TensorsSpec.of(t, rate=rate))
        d, per_frame = self._per_frame_dims(t)
        # window emission rate: fin frames arrive per input buffer; one
        # window leaves per `flush` frames consumed
        out_rate = rate * Fraction(fin, flush) if rate else rate
        if self.concat:
            dims = list(per_frame)
            dims[d] = dims[d] * fout
            return Caps.from_spec(TensorsSpec.of(
                t.with_dims(dims), rate=out_rate))
        # concat=False: the window leaves as fout separate per-frame tensors
        return Caps.from_spec(TensorsSpec(
            tensors=tuple(t.with_dims(per_frame) for _ in range(fout)),
            rate=out_rate))

    # -- hot path -------------------------------------------------------------

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        t = buf.tensors[0]
        fin, fout = int(self.frames_in), int(self.frames_out)
        flush = int(self.frames_flush) or fout
        if self._is_passthrough():
            return buf
        ax = self._dim_axis(t.spec)
        arr = t.torch() if t.is_device else t.np()
        # split incoming buffer into its fin frames along ax (views)
        n_per = arr.shape[ax] // max(fin, 1)
        frames = [
            arr[tuple(slice(i * n_per, (i + 1) * n_per) if a == ax
                      else slice(None) for a in range(arr.ndim))]
            for i in range(fin)]
        if self._pts0 is None:
            self._pts0 = buf.pts
        self._window.extend(frames)
        # per-frame duration (ns): follow-on windows completed by this
        # same input buffer carry synthesized timestamps, not None (which
        # would break time-based elements downstream, e.g. tensor_rate)
        rate = self.sinkpad.spec.rate if self.sinkpad.spec else None
        if rate:
            frame_ns = 1e9 / (float(rate) * max(fin, 1))
        elif buf.duration is not None:
            frame_ns = buf.duration / max(fin, 1)
        else:
            frame_ns = None
        base, emitted = self._pts0, 0
        # emit every complete window (fin > flush can complete several)
        while len(self._window) >= fout:
            out_frames = self._window[:fout]
            self._window = self._window[flush:]
            if not emitted:
                pts = base
            elif base is not None and frame_ns is not None:
                pts = base + int(emitted * flush * frame_ns)
            else:
                pts = None  # clockless stream: keep pts-less passthrough
            emitted += 1
            self.push(Buffer(tensors=self._window_tensors(out_frames, ax),
                             pts=pts, meta=dict(buf.meta)))
        if emitted:
            # leftover frames (fin not divisible by flush) started at
            # base + emitted*flush*frame_ns: the next window is stamped
            # with ITS first frame's time, not the next input buffer's pts
            if self._window and base is not None and frame_ns is not None:
                self._pts0 = base + int(emitted * flush * frame_ns)
            else:
                self._pts0 = None
        return None

    def _window_tensors(self, frames: list, ax: int) -> List[Tensor]:
        """One window's output tensors: the frames concatenated where they
        live (one ``torch.cat`` on the device when any frame is there), or
        the frames themselves, marked shared."""
        dev = next((f.device for f in frames
                    if isinstance(f, torch.Tensor)), None)
        if self.concat:
            if dev is not None:
                return [Tensor(torch.cat(
                    [f if isinstance(f, torch.Tensor)
                     else from_numpy(f, dev) for f in frames], dim=ax))]
            return [Tensor(np.concatenate(frames, axis=ax))]
        out = [Tensor(f) for f in frames]
        for t in out:
            t._shared = True
        return out

    def on_eos(self) -> None:
        self._window = []
        self._pts0 = None
