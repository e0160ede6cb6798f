"""YOLO detection family in PyTorch: the v8 wire layout, and decode + NMS
on the device.

Counterpart of the JAX package's ``models/yolo.py``: a compact anchor-free
v8-style network (stride 8/16/32 pyramid, per-cell xywh + class scores).
Its *raw* variant (:func:`yolo_raw_apply`) emits the v8 wire layout
``(B, 4+C, A)`` that the ``bounding_boxes`` decoder's ``yolov8`` scheme
reads; its *end-to-end* variant (:func:`yolo_detect_apply`) decodes and
runs the class-aware NMS of ``models/ssd.py`` on the device and emits the
postprocess 4-tensor contract (boxes, classes, scores, num) the device
overlay renders, as the SSD does.

:func:`yolo_init` draws the JAX package's tree from numpy in its order —
``early`` is drawn after ``b0..b2`` and their ``refines``, although it
runs first — so one seed gives a bit-identical tree.  The module's
parameter names follow the tree (``stem``, ``early``, ``b0.refines.0.dw``,
``head0``), and ``models/convert.py`` loads a tree into it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .mobilenet import ConvBN, _conv_init, _rng_of
from .ssd import batched_nms

Params = Dict[str, Any]

_STRIDES = (8, 16, 32)


def _block_init(rng, cin, cout):
    """conv (stride 2) + depthwise + pointwise refine (CSP-lite)."""
    return {
        "down": _conv_init(rng, 3, 3, cin, cout),
        "dw": _conv_init(rng, 3, 3, cout, cout, groups=cout),
        "pw": _conv_init(rng, 1, 1, cout, cout),
    }


def _refine_init(rng, c):
    return {
        "dw": _conv_init(rng, 3, 3, c, c, groups=c),
        "pw": _conv_init(rng, 1, 1, c, c),
    }


def yolo_init(key, num_classes: int = 80, width: int = 32,
              depth: int = 1) -> Params:
    """The v8-style pyramid's parameter tree in the JAX package's layout.
    ``width`` scales channels; ``depth`` adds ``depth - 1`` residual
    dw+pw refinements per stage."""
    rng = _rng_of(key)
    c = [width, width * 2, width * 4, width * 8]
    p: Params = {
        "stem": _conv_init(rng, 3, 3, 3, c[0]),
        "num_classes": num_classes,
    }
    for i in range(3):  # stages to strides 8, 16, 32 (stem s2, early s4)
        p[f"b{i}"] = _block_init(rng, c[i], c[i + 1])
        if depth > 1:
            p[f"b{i}"]["refines"] = [
                _refine_init(rng, c[i + 1]) for _ in range(depth - 1)]
    # the extra early downsample, drawn here as the JAX package draws it
    p["early"] = _block_init(rng, c[0], c[0])
    for i in range(len(_STRIDES)):
        p[f"head{i}"] = _conv_init(rng, 1, 1, c[i + 1], 4 + num_classes)
    return p


class Refine(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dw = ConvBN(c, c, 3, groups=c)
        self.pw = ConvBN(c, c, 1)


class YoloBlock(nn.Module):
    """``_block``: a stride-2 conv, then residual dw+pw refinements (the
    block's own, then its ``refines``)."""

    def __init__(self, cin: int, cout: int, refines: int = 0):
        super().__init__()
        self.down = ConvBN(cin, cout, 3, stride=2)
        self.dw = ConvBN(cout, cout, 3, groups=cout)
        self.pw = ConvBN(cout, cout, 1)
        self.refines = nn.ModuleList(Refine(cout) for _ in range(refines))

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        x = self.down(x, dtype)
        x = x + self.pw(self.dw(x, dtype), dtype)
        for r in self.refines:
            x = x + r.pw(r.dw(x, dtype), dtype)
        return x


class YOLO(nn.Module):
    """The v8-style network; :meth:`pyramid` is ``_pyramid``, the heads
    are ``head0..head2``."""

    def __init__(self, num_classes: int = 80, width: int = 32,
                 depth: int = 1):
        super().__init__()
        self.num_classes = num_classes
        c = [width, width * 2, width * 4, width * 8]
        self.stem = ConvBN(3, c[0], 3, stride=2)
        self.early = YoloBlock(c[0], c[0])
        for i in range(3):
            setattr(self, f"b{i}", YoloBlock(c[i], c[i + 1], depth - 1))
            setattr(self, f"head{i}",
                    ConvBN(c[i + 1], 4 + num_classes, 1, relu6=False))

    def pyramid(self, x: torch.Tensor,
                dtype=torch.bfloat16) -> List[torch.Tensor]:
        """NHWC image → the stride-8/16/32 feature maps."""
        x = self.stem(x.to(dtype), dtype)                   # s2
        x = self.early(x, dtype)                            # s4
        feats = []
        for i in range(3):
            x = getattr(self, f"b{i}")(x, dtype)             # s8/s16/s32
            feats.append(x)
        return feats


def _raw_anchor_major(model: YOLO, x: torch.Tensor,
                      dtype) -> torch.Tensor:
    """(B,H,W,3) → (B, A, 4+C) f32: per anchor, xywh in input pixels
    (cell centre + sigmoid offset, ``min(exp, 8)`` sizes), then the
    class confidences."""
    outs = []
    for i, (f, stride) in enumerate(zip(model.pyramid(x, dtype), _STRIDES)):
        h = getattr(model, f"head{i}")(f, dtype).to(torch.float32)
        gh, gw = h.shape[1], h.shape[2]
        gy, gx = torch.meshgrid(
            torch.arange(gh, dtype=torch.float32, device=h.device),
            torch.arange(gw, dtype=torch.float32, device=h.device),
            indexing="ij")
        cx = (gx + torch.sigmoid(h[..., 0])) * stride
        cy = (gy + torch.sigmoid(h[..., 1])) * stride
        w = torch.clamp(torch.exp(h[..., 2]), max=8.0) * stride
        hh = torch.clamp(torch.exp(h[..., 3]), max=8.0) * stride
        cls = torch.sigmoid(h[..., 4:])
        out = torch.cat([torch.stack([cx, cy, w, hh], dim=-1), cls], dim=-1)
        outs.append(out.reshape(x.shape[0], gh * gw, -1))
    return torch.cat(outs, dim=1)


def yolo_raw_apply(model: YOLO, x: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B,H,W,3) float input → the v8 wire layout ``(B, 4+C, A)`` in f32:
    rows 0..3 xywh in input pixels, rows 4.. per-class confidences in
    [0, 1] — what the ``yolov8`` decoder scheme reads."""
    dtype = torch.bfloat16 if dtype is None else dtype
    return _raw_anchor_major(model, x, dtype).transpose(1, 2).contiguous()


def yolo_detect_apply(model: YOLO, x: torch.Tensor, max_out: int = 100,
                      iou_thresh: float = 0.5, score_thresh: float = 0.25,
                      dtype: Optional[torch.dtype] = None):
    """End to end on ``x``'s device: raw head → corner-form normalised
    boxes → class-aware NMS (``ssd.batched_nms``) → (boxes (B,N,4)
    ymin,xmin,ymax,xmax, classes (B,N) f32, scores (B,N), num (B,)
    int32), the postprocess contract the bounding_boxes decoder reads.

    ``batched_nms`` treats column 0 as background, so a zero column is
    prepended and the ids come back shifted by one, as in the JAX
    package; ``num`` counts the scores above ``score_thresh``."""
    dtype = torch.bfloat16 if dtype is None else dtype
    size_h, size_w = float(x.shape[1]), float(x.shape[2])
    raw = _raw_anchor_major(model, x, dtype)
    cx, cy = raw[..., 0] / size_w, raw[..., 1] / size_h
    w, h = raw[..., 2] / size_w, raw[..., 3] / size_h
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                        dim=-1)
    scores = raw[..., 4:]
    padded = torch.cat([torch.zeros_like(scores[..., :1]), scores], dim=-1)
    b, s, c = batched_nms(boxes, padded, max_out=max_out,
                          iou_thresh=iou_thresh, score_thresh=score_thresh,
                          fill=0.0)
    num = (s > score_thresh).sum(dim=-1).to(torch.int32)
    return b, (c - 1).to(torch.float32), s, num


def register_yolo(name: str = "yolo_v8n", batch: int = 1,
                  image_size: int = 256, num_classes: int = 80,
                  raw: bool = False, max_out: int = 100,
                  seed: int = 0, width: int = 32, depth: int = 1) -> str:
    """Register a seeded YOLO for ``tensor_filter framework=torch-cuda
    model=<name>``: ``raw=True`` emits the v8 wire layout for the
    ``yolov8`` decoder scheme; the default is the end-to-end variant in
    the postprocess contract.  f32 NHWC input, bf16 compute."""
    from ..filters import register_model
    from .convert import yolo_from_jax

    model = yolo_from_jax(yolo_init(seed, num_classes=num_classes,
                                    width=width, depth=depth))
    if raw:
        def fn(m, x):
            return yolo_raw_apply(m, x)
    else:
        def fn(m, x):
            return yolo_detect_apply(m, x, max_out=max_out)
    return register_model(name, fn, params=model,
                          in_shapes=[(batch, image_size, image_size, 3)],
                          in_dtypes=np.float32)
