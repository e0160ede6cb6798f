"""``tensor_region`` decoder: detections → crop-region stream for
tensor_crop.

Counterpart of the JAX package's ``decoders/tensorregion.py`` (parity
target: the reference's tensordec-tensorregion.c): consumes one frame of
detection-model output and emits a *flexible* tensor of crop coordinates
(x, y, w, h in pixels of the target frame) that tensor_crop's
``sink_info`` pad consumes — the detect-then-crop cascade.

- option1 — number of regions to emit (top-N by score; default 1)
- option2 — label file (restricts regions to labeled classes)
- option3 — target frame size ``WIDTH:HEIGHT`` (pixel coords; default
  model-normalized 300:300)

Input layout: the post-processed 4-tensor SSD layout (boxes, classes,
scores, count) or raw (loc, cls) mobilenet-ssd output, one frame per
buffer.  A batched layout (boxes (B, N, 4) with B > 1) is refused with an
error naming the batch: the regions of one buffer crop one frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import (
    Buffer,
    Caps,
    Tensor,
    TensorFormat,
    TensorSpec,
    TensorsSpec,
)
from . import Decoder, register_decoder
from .boundingbox import BoundingBoxes


@register_decoder
class TensorRegion(Decoder):
    MODE = "tensor_region"

    def __init__(self):
        super().__init__()
        self.num_regions = 1
        self.frame_w, self.frame_h = 300, 300
        self._bb = BoundingBoxes()

    def options_updated(self) -> None:
        if self.options[0]:
            self.num_regions = int(self.options[0])
        if self.options[1]:
            self._bb.set_option(1, self.options[1])
        if self.options[2]:
            w, _, h = self.options[2].partition(":")
            self.frame_w, self.frame_h = int(w), int(h or w)

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        return Caps.from_spec(TensorsSpec(
            format=TensorFormat.FLEXIBLE, rate=in_spec.rate))

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        shape = buf.tensors[0].spec.shape
        if buf.num_tensors >= 3 and len(shape) == 3 and shape[0] > 1:
            raise ValueError(
                f"tensor_region: boxes {shape} hold a batch of {shape[0]} "
                "frames; tensor_region reads one frame per buffer")
        if buf.num_tensors >= 3:
            dets = self._bb._decode_ssd_postprocess(buf)
        else:
            dets = self._bb._decode_mobilenet_ssd(buf)
        dets.sort(key=lambda d: -d.score)
        dets = dets[:self.num_regions]
        regions = np.zeros((max(len(dets), 1), 4), np.uint32)
        for i, d in enumerate(dets):
            regions[i] = (
                int(np.clip(d.x, 0, 1) * self.frame_w),
                int(np.clip(d.y, 0, 1) * self.frame_h),
                max(int(d.w * self.frame_w), 1),
                max(int(d.h * self.frame_h), 1))
        if not dets:  # no detection: whole-frame region
            regions[0] = (0, 0, self.frame_w, self.frame_h)
        out = Buffer(
            tensors=[Tensor(regions,
                            TensorSpec.from_shape(regions.shape, np.uint32))],
            pts=buf.pts, duration=buf.duration,
            format=TensorFormat.FLEXIBLE, meta=dict(buf.meta))
        out.meta["detections"] = dets
        return out
