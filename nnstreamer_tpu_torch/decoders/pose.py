"""``pose_estimation`` decoder: keypoint heatmaps → skeleton overlay.

Counterpart of the JAX package's ``decoders/pose.py`` (parity target: the
reference's tensordec-pose.c): decodes PoseNet-style heatmaps (H, W, K)
into K keypoints (per-keypoint argmax + score) and draws the skeleton
connecting them; option grammar:

- option1 — output size ``WIDTH:HEIGHT``
- option2 — model input size ``WIDTH:HEIGHT``
- option3 — optional label file of keypoint names
- option4 — ``heatmap-offset`` mode: refine coords with offset tensors
  (second input tensor of shape (H, W, 2K)), as posenet emits

Heatmaps that live on a device are pre-reduced there
(:func:`keypoint_rows`): the per-keypoint argmax (the first maximum, as
``jnp.argmax``), the peak score and the offset gather, then one copy of
the (K, 3|5) rows.  Structured keypoints are attached at
``buffer.meta["keypoints"]``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import Buffer, Caps, CapsStruct, Tensor, TensorSpec, TensorsSpec
from ..core.buffer import from_numpy
from ..obs import transfer as _xfer
from . import Decoder, register_decoder
from .boxutil import load_labels, sigmoid

# COCO-17 style skeleton edge list (parity: pose.c connection table)
_EDGES: Tuple[Tuple[int, int], ...] = (
    (0, 1), (1, 3), (0, 2), (2, 4), (0, 5), (0, 6), (5, 7), (7, 9),
    (6, 8), (8, 10), (5, 11), (6, 12), (11, 13), (13, 15), (12, 14),
    (14, 16), (11, 12))


def keypoint_rows(hm: torch.Tensor,
                  off: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Heatmaps (..., H, W, K) [+ offsets (..., H, W, 2K)] → (K, 3|5) f32
    rows of [y, x, raw score(, dy, dx)] on the heatmaps' device.  The
    flat peak index splits as ``peak // W``, ``peak % W``; dy is offset
    channel k, dx channel K + k (JAX ``pose.py``)."""
    hm3 = hm.reshape(hm.shape[-3], hm.shape[-2], hm.shape[-1])
    h, w, k = hm3.shape
    flat = hm3.reshape(h * w, k)
    peak = torch.argmax(flat, dim=0)                 # (K,) flat indices
    y, x = peak // w, peak % w
    kidx = torch.arange(k, device=hm.device)
    cols = [y.to(torch.float32), x.to(torch.float32),
            flat[peak, kidx].to(torch.float32)]
    if off is not None:
        off3 = off.reshape(off.shape[-3], off.shape[-2], off.shape[-1])
        cols.append(off3[y, x, kidx].to(torch.float32))       # dy
        cols.append(off3[y, x, k + kidx].to(torch.float32))   # dx
    return torch.stack(cols, dim=1)


@register_decoder
class PoseEstimation(Decoder):
    MODE = "pose_estimation"

    def __init__(self):
        super().__init__()
        self.out_w, self.out_h = 192, 192
        self.in_w, self.in_h = 192, 192
        self.names: List[str] = []
        self.use_offsets = False

    def options_updated(self) -> None:
        if self.options[0]:
            w, _, h = self.options[0].partition(":")
            self.out_w, self.out_h = int(w), int(h or w)
        if self.options[1]:
            w, _, h = self.options[1].partition(":")
            self.in_w, self.in_h = int(w), int(h or w)
        if self.options[2]:
            self.names = load_labels(self.options[2])
        if self.options[3]:
            self.use_offsets = self.options[3].strip() == "heatmap-offset"

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        return Caps.new(CapsStruct.make(
            "video/x-raw", format="RGBA", width=self.out_w,
            height=self.out_h, framerate=in_spec.rate))

    def prereduce_active(self, buf: Buffer) -> bool:
        t = buf.tensors[0]
        if not t.is_device or len(t.spec.shape) < 3:
            return False
        if self.use_offsets and buf.num_tensors > 1:
            return buf.tensors[1].is_device
        return True

    def _keypoint_rows(self, buf: Buffer):
        """(K, 3|5) rows of [y, x, raw_score(, dy, dx)]: reduced where the
        heatmaps live (one small copy when that is a device), host arrays
        through the same function on the CPU."""
        t0 = buf.tensors[0]
        with_off = self.use_offsets and buf.num_tensors > 1
        if self.prereduce_active(buf):
            ins = [t.torch() for t in buf.tensors[:1 + with_off]]
        else:
            ins = [from_numpy(t.np()) for t in buf.tensors[:1 + with_off]]
        with torch.inference_mode():
            rows = _xfer.to_host(keypoint_rows(*ins)).numpy()
        hshape = t0.spec.shape
        return rows, hshape[-3], hshape[-2]

    def _keypoints(self, buf: Buffer) -> List[dict]:
        rows, H, W = self._keypoint_rows(buf)
        kps = []
        for k, r in enumerate(rows):
            y, x = int(r[0]), int(r[1])
            score = float(sigmoid(np.asarray(r[2])))
            if rows.shape[1] > 3:
                # posenet layout: first K channels = dy, next K = dx
                py = (y / max(H - 1, 1)) * self.in_h + r[3]
                px = (x / max(W - 1, 1)) * self.in_w + r[4]
                nx, ny = px / self.in_w, py / self.in_h
            else:
                nx, ny = x / max(W - 1, 1), y / max(H - 1, 1)
            kps.append({
                "index": k,
                "name": self.names[k] if k < len(self.names) else str(k),
                "x": float(np.clip(nx, 0, 1)),
                "y": float(np.clip(ny, 0, 1)),
                "score": score})
        return kps

    def _draw(self, kps: List[dict]) -> np.ndarray:
        img = np.zeros((self.out_h, self.out_w, 4), np.uint8)
        green = np.array([0, 255, 0, 255], np.uint8)
        white = np.array([255, 255, 255, 255], np.uint8)
        for a, b in _EDGES:
            if a >= len(kps) or b >= len(kps):
                continue
            x0, y0 = kps[a]["x"] * (self.out_w - 1), \
                kps[a]["y"] * (self.out_h - 1)
            x1, y1 = kps[b]["x"] * (self.out_w - 1), \
                kps[b]["y"] * (self.out_h - 1)
            n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
            xs = np.linspace(x0, x1, n).astype(int)
            ys = np.linspace(y0, y1, n).astype(int)
            img[ys, xs] = white
        for kp in kps:
            x = int(kp["x"] * (self.out_w - 1))
            y = int(kp["y"] * (self.out_h - 1))
            img[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = green
        return img

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        kps = self._keypoints(buf)
        frame = self._draw(kps)
        out = Buffer(
            tensors=[Tensor(frame,
                            TensorSpec.from_shape(frame.shape, np.uint8))],
            pts=buf.pts, duration=buf.duration, meta=dict(buf.meta))
        out.meta["keypoints"] = kps
        return out
