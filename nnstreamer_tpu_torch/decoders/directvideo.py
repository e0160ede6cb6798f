"""``direct_video`` decoder: tensor → video/x-raw.

Counterpart of the JAX package's ``decoders/directvideo.py`` (parity
target: the reference's tensordec-directvideo.c): uint8 tensors of 1/3/4
channels become GRAY8/RGB/RGBx video (option1 may force BGR ordering).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import Buffer, Caps, CapsStruct, DType, Tensor, TensorsSpec
from . import Decoder, register_decoder


_CH_TO_FMT = {1: "GRAY8", 3: "RGB", 4: "RGBx"}


@register_decoder
class DirectVideo(Decoder):
    MODE = "direct_video"

    def _fmt(self, channels: int) -> str:
        if channels not in _CH_TO_FMT:
            raise ValueError(
                f"direct_video: {channels} channels unsupported (1/3/4)")
        fmt = _CH_TO_FMT[channels]
        if self.options[0].upper() == "BGR" and channels == 3:
            fmt = "BGR"
        return fmt

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        t = in_spec.tensors[0]
        if t.dtype != DType.UINT8:
            raise ValueError("direct_video: input must be uint8")
        ch, w, h = t.dims[0], t.dims[1], t.dims[2] if t.rank > 2 else 1
        return Caps.new(CapsStruct.make(
            "video/x-raw", format=self._fmt(ch), width=w, height=h,
            framerate=in_spec.rate))

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        t = buf.tensors[0]
        arr = t.np().reshape(t.spec.shape[-3:])  # (H, W, C)
        return Buffer(tensors=[Tensor(np.ascontiguousarray(arr))],
                      pts=buf.pts, duration=buf.duration,
                      meta=dict(buf.meta))
