"""Shared box post-processing + drawing utilities for decoders.

Counterpart of the JAX package's ``decoders/boxutil.py``: the host-side
IoU/NMS helpers, ``sigmoid``/``softmax`` and ``load_labels``, and the
rasterizer with its label text (parity: the reference's
tensordec-boundingbox.cc ``nms()`` and ``draw()``, and tensordec-font.c
through ``font.py``), and the device rasterizer :func:`device_render` as
a plain function on tensors, which draws boxes only.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Detection:
    """One detected object in normalized [0,1] image coordinates."""

    x: float  # left
    y: float  # top
    w: float
    h: float
    class_id: int
    score: float
    label: str = ""


def load_labels(path: str) -> List[str]:
    """One label per non-empty line of a text file."""
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def iou_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between one box (4,) and many boxes (N,4), xywh layout."""
    ax2, ay2 = a[0] + a[2], a[1] + a[3]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix = np.maximum(
        0, np.minimum(ax2, bx2) - np.maximum(a[0], b[:, 0]))
    iy = np.maximum(
        0, np.minimum(ay2, by2) - np.maximum(a[1], b[:, 1]))
    inter = ix * iy
    union = a[2] * a[3] + b[:, 2] * b[:, 3] - inter
    return inter / np.maximum(union, 1e-9)


def nms(dets: List[Detection], iou_thresh: float = 0.5,
        max_out: Optional[int] = None) -> List[Detection]:
    """Greedy class-aware NMS (parity: nms() in tensordec-boundingbox.cc)."""
    out: List[Detection] = []
    by_class: dict = {}
    for d in dets:
        by_class.setdefault(d.class_id, []).append(d)
    for cid, cds in by_class.items():
        cds.sort(key=lambda d: -d.score)
        boxes = np.array([[d.x, d.y, d.w, d.h] for d in cds], np.float32)
        alive = np.ones(len(cds), bool)
        for i, d in enumerate(cds):
            if not alive[i]:
                continue
            out.append(d)
            if i + 1 < len(cds):
                sup = iou_xywh(boxes[i], boxes[i + 1:]) > iou_thresh
                alive[i + 1:] &= ~sup
    out.sort(key=lambda d: -d.score)
    return out[:max_out] if max_out else out


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


#: default overlay palette, shared by the host and device renderers
PALETTE = np.array([
    [255, 0, 0, 255], [0, 255, 0, 255], [0, 0, 255, 255],
    [255, 255, 0, 255], [255, 0, 255, 255], [0, 255, 255, 255]],
    np.uint8)

#: the palette on each device, copied there once
_DEVICE_PALETTE: dict = {}


def _palette_on(dev: torch.device) -> torch.Tensor:
    pal = _DEVICE_PALETTE.get(dev)
    if pal is None:
        pal = _DEVICE_PALETTE.setdefault(
            dev, torch.as_tensor(PALETTE, device=dev))
    return pal


def device_render(boxes: torch.Tensor, classes: torch.Tensor,
                  scores: torch.Tensor, num: torch.Tensor, height: int,
                  width: int, conf_thresh: float,
                  thickness: int = 2) -> torch.Tensor:
    """Rasterize box outlines on the tensors' device.

    ``boxes (B,N,4)`` ymin,xmin,ymax,xmax normalized, ``classes (B,N)``,
    ``scores (B,N)``, ``num (B,)`` → ``(B,H,W,4)`` uint8 RGBA.  Draw
    semantics (truncating coordinate scaling, clipping, edge thickness,
    later boxes over earlier ones, palette by class) match
    :func:`draw_boxes` exactly, and the bytes match the JAX package's
    ``device_render_fn``.

    A pixel is on box i's outline iff (row in its top/bottom strip AND
    col in its x-range) OR (row in its y-range AND col in its left/right
    strip); the strips are the exact slices the host renderer assigns.
    The boxes are painted one after another into ONE packed-RGBA int32
    plane (0 = transparent), which a little-endian byte view turns into
    the 4-channel canvas.
    """
    B, N = boxes.shape[0], boxes.shape[1]
    H, W, t = height, width, thickness
    dev = boxes.device
    pal = _palette_on(dev)
    ys = torch.arange(H, dtype=torch.int32, device=dev)[None, None, :]
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]
    valid = (torch.arange(N, device=dev)[None, :] < num[:, None]) & \
        (scores >= conf_thresh)
    # float→int32 truncates toward zero (the reference's and XLA's cast)
    y0 = torch.clamp((boxes[..., 0] * H).to(torch.int32), 0, H - 1)
    x0 = torch.clamp((boxes[..., 1] * W).to(torch.int32), 0, W - 1)
    y1 = torch.clamp((boxes[..., 2] * H).to(torch.int32), 0, H - 1)
    x1 = torch.clamp((boxes[..., 3] * W).to(torch.int32), 0, W - 1)
    yl, xl = y0[..., None], x0[..., None]          # (B,N,1)
    yh, xh = y1[..., None], x1[..., None]
    in_y = (ys >= yl) & (ys <= yh)                 # (B,N,H)
    tb = ((ys >= yl) & (ys < yl + t)) | \
        ((ys >= torch.clamp(yh - t + 1, min=0)) & (ys <= yh))
    in_x = (xs >= xl) & (xs <= xh)                 # (B,N,W)
    lr = ((xs >= xl) & (xs < xl + t)) | \
        ((xs >= torch.clamp(xh - t + 1, min=0)) & (xs <= xh))
    tb = tb & valid[..., None]
    in_y = in_y & valid[..., None]
    color = pal[classes.to(torch.int64) % pal.shape[0]].to(torch.int64)
    # alpha lands in bit 24..31, the int32 sign bit: pack in int64, then
    # narrow (two's complement keeps the bit pattern)
    pcolor = (color[..., 0] | (color[..., 1] << 8) | (color[..., 2] << 16)
              | (color[..., 3] << 24)).to(torch.int32)          # (B,N)
    win = torch.zeros((B, H, W), dtype=torch.int32, device=dev)
    for i in range(N):
        mask = (tb[:, i, :, None] & in_x[:, i, None, :]) | \
            (in_y[:, i, :, None] & lr[:, i, None, :])
        win = torch.where(mask, pcolor[:, i, None, None], win)
    return win.contiguous().view(torch.uint8).reshape(B, H, W, 4)


def draw_boxes(dets: Sequence[Detection], width: int, height: int,
               thickness: int = 2, labels: bool = False,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Render detections into an RGBA overlay frame (H, W, 4) uint8 on
    the host.  With ``labels=True`` each detection carrying a ``label``
    gets its text stamped above the box in the box's color.  ``out``
    draws into an existing zeroed frame."""
    img = np.zeros((height, width, 4), np.uint8) if out is None else out
    palette = PALETTE
    for d in dets:
        color = palette[d.class_id % len(palette)]
        # coordinates scale in float32 — the reference's gfloat math and
        # bit-identical to the device renderer's f32 pipeline at
        # pixel-boundary roundings
        f32 = np.float32
        x0 = min(max(int(f32(d.x) * f32(width)), 0), width - 1)
        y0 = min(max(int(f32(d.y) * f32(height)), 0), height - 1)
        x1 = min(max(int(f32(f32(d.x) + f32(d.w)) * f32(width)), 0),
                 width - 1)
        y1 = min(max(int(f32(f32(d.y) + f32(d.h)) * f32(height)), 0),
                 height - 1)
        t = thickness
        img[y0:y0 + t, x0:x1 + 1] = color
        img[max(y1 - t + 1, 0):y1 + 1, x0:x1 + 1] = color
        img[y0:y1 + 1, x0:x0 + t] = color
        img[y0:y1 + 1, max(x1 - t + 1, 0):x1 + 1] = color
        if labels and d.label:
            from .font import draw_text, label_anchor

            lx, ly = label_anchor(x0, y0)
            draw_text(img, lx, ly, d.label, color)
    return img
