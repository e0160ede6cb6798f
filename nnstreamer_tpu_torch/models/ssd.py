"""SSD-MobileNetV2 object detection in PyTorch, with decode and NMS on the
device.

Counterpart of the JAX package's ``models/ssd.py``: the same anchor table
(pure numpy), the same head layout, the same center-form decode and the
same class-aware matrix NMS, so the port and the JAX package give the
same detections from the same weights.  ``vmap`` over the batch becomes an
explicit leading batch dimension.

Ties: ``lax.top_k`` puts the lower index first among equal values, and the
JAX package relies on that (the class tensor is bfloat16 on the detect
path, so exact ties are common, and the final top-k ranks the ``-inf``
fill slots too).  ``torch.topk`` promises no order among equals, so
:func:`_top_k` is a stable descending sort, sliced.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .mobilenet import ConvBN, MobileNetV2Backbone

# SSDLite feature pyramid: tap MobileNetV2 block 13 (stride 16) and the
# final block (stride 32), then 4 extra stride-2 layers.
_TAP_BLOCK = 12  # 0-based index of last (6,96,3,1) block output, stride 16
_EXTRA_CHANNELS = (512, 256, 256, 128)
_ANCHORS_PER_CELL = 6
# Center-form decode scale factors (the reference's mobilenetssd
# box properties).
_SCALE_XY = 10.0
_SCALE_WH = 5.0


def ssd_anchors(image_size: int = 300,
                feature_sizes: Sequence[int] = (19, 10, 5, 3, 2, 1),
                min_scale: float = 0.2, max_scale: float = 0.95) -> np.ndarray:
    """Static anchor table, center-form (cy, cx, h, w), normalized [0,1]
    (a copy of the JAX package's numpy table)."""
    n_layers = len(feature_sizes)
    scales = [min_scale + (max_scale - min_scale) * i / (n_layers - 1)
              for i in range(n_layers)] + [1.0]
    ratios = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
    anchors: List[np.ndarray] = []
    for li, fs in enumerate(feature_sizes):
        s, s_next = scales[li], scales[li + 1]
        dims = [(s * np.sqrt(r), s / np.sqrt(r)) for r in ratios]
        dims.append((np.sqrt(s * s_next),) * 2)  # extra scale, ratio 1
        cy, cx = np.meshgrid(
            (np.arange(fs) + 0.5) / fs, (np.arange(fs) + 0.5) / fs,
            indexing="ij")
        for (w, h) in dims:
            a = np.stack([cy, cx, np.full_like(cy, h), np.full_like(cx, w)],
                         axis=-1)
            anchors.append(a.reshape(-1, 4))
    # Interleave per-cell: anchors of one cell are adjacent, matching the
    # head output layout (fs, fs, A, 4) flattening.
    out = []
    off = 0
    for fs in feature_sizes:
        per = [anchors[i] for i in range(off, off + _ANCHORS_PER_CELL)]
        stacked = np.stack(per, axis=1).reshape(-1, 4)  # (fs*fs*A, 4)
        out.append(stacked)
        off += _ANCHORS_PER_CELL
    return np.clip(np.concatenate(out, axis=0), 0.0, 1.5).astype(np.float32)


def feature_sizes_for(image_size: int) -> Tuple[int, ...]:
    """The six pyramid levels' grid sizes at ``image_size``."""
    return tuple(int(np.ceil(image_size / s))
                 for s in (16, 32, 64, 128, 256, 512))


def decode_boxes(loc: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Center-form regression → corner-form (ymin,xmin,ymax,xmax).
    ``loc``: (..., A, 4) raw head output; ``anchors``: (A, 4) cy,cx,h,w."""
    cy = loc[..., 0] / _SCALE_XY * anchors[:, 2] + anchors[:, 0]
    cx = loc[..., 1] / _SCALE_XY * anchors[:, 3] + anchors[:, 1]
    h = torch.exp(loc[..., 2] / _SCALE_WH) * anchors[:, 2]
    w = torch.exp(loc[..., 3] / _SCALE_WH) * anchors[:, 3]
    return torch.stack(
        [cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], dim=-1)


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., k, 4) corner-form → (..., k, k) IoU."""
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)
    tl = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    br = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last dim, lower index first among equal values
    (``lax.top_k``'s order): a stable descending sort, sliced.  Exact —
    the TPU's approximate preselect is not used off the TPU either."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for every batch row: x (B, A, ...), idx (B, K)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def batched_nms(boxes: torch.Tensor, class_scores: torch.Tensor,
                max_out: int = 100, iou_thresh: float = 0.5,
                score_thresh: float = 0.25, pre_topk: int = 128,
                fill: float = 0.0):
    """Class-aware matrix NMS over a batch: boxes (B,A,4), class scores
    (B,A,C) (class 0 = background, skipped) → (boxes (B,max_out,4),
    scores (B,max_out), classes (B,max_out) int32).

    The JAX package's algorithm per image: ONE shared candidate top-k on
    the best class score, ONE IoU matrix, then the top 4·max_out
    (candidate, class) pairs are tested against all k candidates — a pair
    is suppressed by an overlapping candidate with a higher score for its
    class, exact ties broken by candidate rank.  Thresholds and the fill
    value are taken in the score dtype, as JAX's weakly typed Python
    scalars are."""
    B = boxes.shape[0]
    fg = class_scores[..., 1:]                       # drop background
    num_fg = fg.shape[-1]
    k = min(pre_topk, boxes.shape[1])
    _, idx = _top_k(fg.amax(dim=-1), k)              # shared candidates
    b = _take(boxes, idx)                            # (B,k,4)
    s = _take(fg, idx)                               # (B,k,C-1)
    eye = torch.eye(k, dtype=torch.bool, device=boxes.device)
    overlap = (_iou_matrix(b) > iou_thresh) & ~eye   # (B,k,k), no self
    flat = s.reshape(B, -1)                          # candidate-major
    m = min(max_out, flat.shape[1])
    M = min(4 * max_out, flat.shape[1])
    raw, fidx = _top_k(flat, M)                      # (B,M) pair preselect
    cand = fidx // num_fg                            # (B,M) candidate row
    ccls = fidx % num_fg                             # (B,M) class column
    sj = _take(s.transpose(1, 2), ccls)              # (B,M,k) class scores
    rank = torch.arange(k, device=boxes.device)
    beats = (sj > raw[..., None]) | \
        ((sj == raw[..., None]) & (rank[None, None, :] < cand[..., None]))
    suppressed = (_take(overlap, cand) & beats).any(dim=-1)   # (B,M)
    # torch.full fills on the device (torch.tensor of a Python scalar
    # would copy it from the host each call); same rounding to s.dtype
    thresh = torch.full((), score_thresh, dtype=s.dtype, device=s.device)
    keep = (raw > thresh) & ~suppressed
    kept = torch.where(keep, raw, torch.full((), fill, dtype=s.dtype,
                                             device=s.device))
    top_scores, sel = _top_k(kept, m)                # final slate from M
    out_b = _take(b, torch.gather(cand, 1, sel))
    out_s = top_scores
    out_c = (torch.gather(ccls, 1, sel) + 1).to(torch.int32)
    if m < max_out:                                  # fixed-shape contract
        pad = max_out - m
        out_b = torch.nn.functional.pad(out_b, (0, 0, 0, pad))
        out_s = torch.nn.functional.pad(out_s, (0, pad), value=fill)
        out_c = torch.nn.functional.pad(out_c, (0, pad))
    return out_b, out_s, out_c


# -- model -------------------------------------------------------------------


class SSDHead(nn.Module):
    def __init__(self, cin: int, num_anchors: int, num_classes: int):
        super().__init__()
        self.loc = ConvBN(cin, num_anchors * 4, 3, relu6=False)
        self.cls = ConvBN(cin, num_anchors * num_classes, 3, relu6=False)


class SSDMobileNetV2(nn.Module):
    """SSD-MobileNetV2: backbone + 4 extra layers + 6 heads.  Its forward
    is the JAX package's ``ssd_mobilenet_v2_apply``.  Load weights from a
    JAX-layout tree with ``models/convert.py``."""

    def __init__(self, num_classes: int = 91):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = MobileNetV2Backbone()
        extras, cin = [], 320
        for c in _EXTRA_CHANNELS:
            extras.append(ConvBN(cin, c, 3, stride=2))
            cin = c
        self.extras = nn.ModuleList(extras)
        self.heads = nn.ModuleList(
            SSDHead(c, _ANCHORS_PER_CELL, num_classes)
            for c in (96, 320, *_EXTRA_CHANNELS))

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16,
                cls_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x``: (N, H, W, 3) normalized NHWC → (loc (N,A,4) float32,
        cls (N,A,C) in ``cls_dtype``) raw head outputs."""
        feat, taps = self.backbone(x, dtype, taps=(_TAP_BLOCK,))
        maps = [taps[0], feat]
        h = feat
        for extra in self.extras:
            h = extra(h, dtype)
            maps.append(h)
        locs, clss = [], []
        for fmap, head in zip(maps, self.heads):
            n = fmap.shape[0]
            # NHWC (n, fs, fs, A·4) → (n, fs·fs·A, 4): the anchor table is
            # interleaved per cell, so the reshape must see NHWC order
            locs.append(head.loc(fmap, dtype).reshape(n, -1, 4))
            clss.append(head.cls(fmap, dtype).reshape(n, -1,
                                                      self.num_classes))
        return (torch.cat(locs, dim=1).to(torch.float32),
                torch.cat(clss, dim=1).to(cls_dtype))


def ssd_detect_apply(model: SSDMobileNetV2, x: torch.Tensor,
                     anchors: torch.Tensor, max_out: int = 100,
                     dtype=torch.bfloat16, score_thresh: float = 0.25,
                     iou_thresh: float = 0.5):
    """End-to-end detector: image → (boxes, scores, classes).  Backbone +
    decode + NMS, all on ``x``'s device; ``anchors`` must be a tensor
    there already.

    The postprocess runs in LOGIT space on the class tensor in ``dtype``:
    sigmoid is monotonic, so ranking/thresholding on raw logits (with the
    threshold mapped through logit()) selects the same detections; the
    sigmoid is applied only to the ``max_out`` survivors.  Suppressed or
    padded slots carry -inf logits → exactly 0.0 scores."""
    loc, cls = model(x, dtype=dtype, cls_dtype=dtype)
    boxes = decode_boxes(loc, anchors)
    lt = float(np.log(score_thresh / (1.0 - score_thresh)))
    out_b, out_s, out_c = batched_nms(boxes, cls, max_out=max_out,
                                      iou_thresh=iou_thresh,
                                      score_thresh=lt, fill=-np.inf)
    return out_b, torch.sigmoid(out_s.to(torch.float32)), out_c


def register_ssd(name: str = "ssd_mobilenet_v2", num_classes: int = 91,
                 batch: int = 1, size: int = 300, max_out: int = 100,
                 seed: int = 0, end_to_end: bool = True) -> str:
    """Register a seeded SSD-MobileNetV2 for ``tensor_filter
    framework=torch-cuda model=<name>``.  ``end_to_end=True`` puts decode
    + NMS in the model and returns ``(boxes, scores, classes)``, as the
    JAX package's does; ``False`` returns the raw ``(loc, cls)`` head
    outputs in f32 for the ``mobilenet-ssd`` decoder scheme."""
    from ..filters import register_model
    from .convert import ssd_from_jax, ssd_mobilenet_v2_init

    model = ssd_from_jax(ssd_mobilenet_v2_init(seed, num_classes))
    if end_to_end:
        anchors = torch.from_numpy(ssd_anchors(size, feature_sizes_for(size)))
        return register_model(
            name,
            lambda p, x: ssd_detect_apply(p["model"], x, p["anchors"],
                                          max_out=max_out),
            params={"model": model, "anchors": anchors},
            in_shapes=[(batch, size, size, 3)], in_dtypes=np.float32)
    return register_model(name, lambda m, x: m(x), params=model,
                          in_shapes=[(batch, size, size, 3)],
                          in_dtypes=np.float32)
