"""``image_segment`` decoder: segmentation map → colored RGBA video.

Counterpart of the JAX package's ``decoders/imagesegment.py`` (parity
target: the reference's tensordec-imagesegment.c): schemes
``tflite-deeplab`` ((H, W, C) per-class scores → argmax) and raw index
maps; each class index maps to a palette color.

- option1 — scheme: ``tflite-deeplab`` (argmax over channel scores) or
  ``index`` (input already is an integer class map).  A last axis wider
  than 64, or a rank under 3, is read as an index map whatever the scheme.

A score tensor that lives on a device is pre-reduced there: the channel
argmax to int32 (:func:`argmax_channel`, the first maximum, as
``jnp.argmax``), then one copy of the (H, W) map, 1/C of the scores.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import Buffer, Caps, CapsStruct, Tensor, TensorSpec, TensorsSpec
from ..obs import transfer as _xfer
from . import Decoder, register_decoder

_PALETTE = np.array(
    [[0, 0, 0, 0]] + [
        [(37 * i) % 256, (97 * i) % 256, (157 * i) % 256, 255]
        for i in range(1, 64)],
    np.uint8)


def argmax_channel(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) scores → (H, W) int32 class map on ``x``'s device;
    the first index among equal maxima."""
    x = x.reshape(x.shape[-3], x.shape[-2], x.shape[-1])
    return torch.argmax(x, dim=-1).to(torch.int32)


@register_decoder
class ImageSegment(Decoder):
    MODE = "image_segment"

    def _scheme(self) -> str:
        return (self.options[0] or "tflite-deeplab").strip().lower()

    def _is_index_map(self, shape) -> bool:
        return self._scheme() == "index" or len(shape) < 3 \
            or shape[-1] > 64

    def _dims(self, in_spec: TensorsSpec):
        shape = in_spec.tensors[0].shape
        if self._is_index_map(shape):
            return shape[-1], shape[-2]      # integer map (..., H, W)
        return shape[-2], shape[-3]          # scores (..., H, W, C)

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        w, h = self._dims(in_spec)
        return Caps.new(CapsStruct.make(
            "video/x-raw", format="RGBA", width=w, height=h,
            framerate=in_spec.rate))

    def prereduce_active(self, buf: Buffer) -> bool:
        t = buf.tensors[0]
        return t.is_device and not self._is_index_map(t.spec.shape)

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        t = buf.tensors[0]
        if self.prereduce_active(buf):
            with torch.inference_mode():
                # the one device→host copy: the (H, W) map
                idx = _xfer.to_host(argmax_channel(t.torch())).numpy() \
                    .astype(np.int64)
        else:
            arr = t.np()
            if self._is_index_map(arr.shape):
                idx = arr.reshape(arr.shape[-2],
                                  arr.shape[-1]).astype(np.int64)
            else:
                scores = arr.reshape(arr.shape[-3], arr.shape[-2],
                                     arr.shape[-1])
                idx = scores.argmax(axis=-1)
        frame = _PALETTE[idx % len(_PALETTE)]
        out = Buffer(
            tensors=[Tensor(frame,
                            TensorSpec.from_shape(frame.shape, np.uint8))],
            pts=buf.pts, duration=buf.duration, meta=dict(buf.meta))
        out.meta["segment_map"] = idx
        return out
