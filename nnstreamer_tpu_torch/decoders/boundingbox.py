"""``bounding_boxes`` decoder: detection model output → box overlay video.

Counterpart of the JAX package's ``decoders/boundingbox.py`` (parity: the
reference's box_properties/ mobilenetssd.cc, mobilenetssdpp.cc, yolo.cc,
ovdetection.cc and mppalmdetection.cc).  Options follow the reference
grammar:

- option1 — decoding scheme: ``mobilenet-ssd`` (raw loc (A,4) + class
  logits (A,C), decoded against SSD anchors), ``mobilenet-ssd-postprocess``
  (alias ``mobilenetssd-pp``: boxes (N,4 ymin,xmin,ymax,xmax normalized),
  classes (N,), scores (N,), num (1,); or the batched (B,N,4) layout of an
  in-model decode+NMS head), ``yolov5`` ((1, A, 5+C): xywh, objectness,
  class confidences), ``yolov8`` ((1, 4+C, A): xywh, class confidences),
  pixel-space xywh, ``ov-person-detection`` (OpenVINO rows [image_id,
  label, conf, x_min, y_min, x_max, y_max]) and ``mp-palm-detection``
  (MediaPipe palm anchors, clamped-sigmoid scores)
- option2 — a label file, one label per line: each detection's
  ``label`` is the line of its class, drawn above its box on the host
  overlay
- option3 — scheme detail: mobilenet-ssd, a box-priors file (blank:
  synthesize the SSD anchors for option5's size); yolo,
  ``<conf_thresh>:<iou_thresh>``; mp-palm, ``<score_thresh>[:…]`` (the
  threshold is read, the anchor fields keep the palm model's constants)
- option4 — output video size ``WIDTH:HEIGHT``
- option5 — model input size ``WIDTH:HEIGHT`` (yolo and palm box
  scaling, anchors)
- option7 — render backend: ``host`` (default, numpy rasterization with
  label text) | ``device`` (boxutil.device_render on the pipeline's
  device; the postprocess scheme only).  The device path draws boxes
  only: with option2 set it warns once and leaves the text out.  With
  ``device`` the structured detections stay on the device at
  ``meta["detections_device"]``; the host path attaches python
  :class:`Detection` lists at ``meta["detections"]``.

A yolo tensor that lives on a device is pre-reduced there
(:func:`yolo_prereduce`): best class, its score and the top
``_YOLO_TOPK`` anchors by that score, so only those (K, 6) rows cross to
the host; the detections equal the host decode's whenever a frame has at
most K anchors above the threshold.  The top-K is the stable sort of
``models/ssd.py`` (``lax.top_k``'s order among equal scores).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, CapsStruct, Tensor, TensorSpec, TensorsSpec
from ..models.ssd import (
    _SCALE_WH,
    _SCALE_XY,
    _top_k,
    feature_sizes_for,
    ssd_anchors,
)
from ..obs import transfer as _xfer
from . import Decoder, register_decoder
from .boxutil import (
    Detection,
    device_render,
    draw_boxes,
    load_labels,
    nms,
    sigmoid,
)

_log = logging.getLogger("nnstreamer_tpu_torch")

_PP_SCHEMES = ("mobilenet-ssd-postprocess", "mobilenetssd-pp")
_SCHEMES = ("mobilenet-ssd", "yolov5", "yolov8", "ov-person-detection",
            "mp-palm-detection") + _PP_SCHEMES

#: yolo device pre-reduction keeps the top-K anchors by best class score
#: and drains only those (K, 6) rows
_YOLO_TOPK = 512


def yolo_prereduce(out: torch.Tensor, v8: bool,
                   k: int = _YOLO_TOPK) -> torch.Tensor:
    """A raw yolo tensor → (K, 6) f32 rows of [cx, cy, w, h, best score,
    class], the top K anchors by best score, on ``out``'s device.  v8:
    (1, 4+C, A), no objectness; v5: (1, A, 5+C), scores = class
    confidences × objectness."""
    if v8:
        arr = out.reshape(out.shape[-2], out.shape[-1]).T
        boxes, scores = arr[:, :4], arr[:, 4:]
    else:
        arr = out.reshape(-1, out.shape[-1])
        boxes = arr[:, :4]
        scores = arr[:, 5:] * arr[:, 4:5]
    best, cls = torch.max(scores, dim=1)
    val, idx = _top_k(best, min(k, best.shape[0]))
    return torch.cat([boxes[idx].to(torch.float32),
                      val[:, None].to(torch.float32),
                      cls[idx][:, None].to(torch.float32)], dim=1)


@register_decoder
class BoundingBoxes(Decoder):
    MODE = "bounding_boxes"

    def __init__(self):
        super().__init__()
        self.scheme = "mobilenet-ssd-postprocess"
        self.labels: List[str] = []
        self.priors: Optional[np.ndarray] = None
        self.out_w, self.out_h = 300, 300
        self.in_w, self.in_h = 300, 300
        self.conf_thresh = 0.25
        self.iou_thresh = 0.5
        self.backend = "host"
        self._warned_device_labels = False
        #: mp-palm score threshold (reference default 0.5), settable via
        #: option3 when the scheme is mp-palm-detection
        self._palm_thresh: Optional[float] = None
        self._palm_anchor_cache: Optional[np.ndarray] = None
        #: set by the fusion pass when the device overlay runs INSIDE the
        #: upstream torch-cuda filter: decode() then consumes a ready
        #: canvas instead of rendering
        self.fused_upstream = False

    def options_updated(self) -> None:
        if self.options[6]:
            self.backend = self.options[6].strip().lower()
        if self.options[0]:
            scheme = self.options[0].strip().lower()
            if scheme not in _SCHEMES:
                raise ValueError(
                    f"bounding_boxes: unknown scheme {scheme!r} (known: "
                    f"{', '.join(_SCHEMES)})")
            self.scheme = scheme
        if self.options[1]:
            self.labels = load_labels(self.options[1])
        self._interpret_opt3(self.options[2])
        if self.options[3]:
            w, _, h = self.options[3].partition(":")
            self.out_w, self.out_h = int(w), int(h or w)
        if self.options[4]:
            w, _, h = self.options[4].partition(":")
            self.in_w, self.in_h = int(w), int(h or w)

    def _interpret_opt3(self, o3: Optional[str]) -> None:
        """option3 against the current scheme: yolo "<conf>:<iou>"
        thresholds, mp-palm "<threshold>[:num_layers:min_scale:…]" (the
        threshold is read, the rest keep the palm model's constants),
        mobilenet-ssd a box-priors file."""
        if not o3:
            return
        if self.scheme.startswith("yolo"):
            c, _, i = o3.partition(":")
            try:
                if c:
                    self.conf_thresh = float(c)
                if i:
                    self.iou_thresh = float(i)
            except ValueError:
                pass  # not a threshold pair (e.g. a stale priors path)
        elif self.scheme == "mp-palm-detection":
            try:
                self._palm_thresh = float(o3.partition(":")[0])
            except ValueError:
                pass
        elif self.scheme == "mobilenet-ssd":
            try:
                self.priors = np.loadtxt(o3, dtype=np.float32)
            except (OSError, ValueError):
                pass

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        # Batched postprocess input — boxes (B,N,4) from an on-device
        # decode+NMS head — yields one buffer of B overlay frames; the
        # ``frames`` field is the framework's batched-video extension.
        frames = 1
        if self.fused_upstream:
            # overlay fused into the upstream filter: tensor 0 of the
            # incoming schema IS the rendered canvas
            t0 = in_spec.tensors[0] if in_spec.tensors else None
            if t0 is not None and t0.rank == 4 and t0.shape[0] > 1:
                frames = t0.shape[0]
        elif in_spec.tensors and in_spec.tensors[0].rank == 3 \
                and self.scheme in _PP_SCHEMES:
            frames = in_spec.tensors[0].shape[0]
        extra = {"frames": frames} if frames > 1 else {}
        return Caps.new(CapsStruct.make(
            "video/x-raw", format="RGBA", width=self.out_w,
            height=self.out_h, framerate=in_spec.rate, **extra))

    # -- host path ------------------------------------------------------------

    def _anchors(self, num: int) -> np.ndarray:
        if self.priors is not None and len(self.priors) >= num:
            return self.priors[:num]
        # the standard SSD anchor table for the model input size
        a = ssd_anchors(self.in_w, feature_sizes_for(self.in_w))
        if len(a) < num:
            a = np.vstack([a] * (num // len(a) + 1))
        return a[:num]

    def _decode_mobilenet_ssd(self, buf: Buffer) -> List[Detection]:
        """Raw 2-tensor layout: loc (A,4) or (1,A,4) + class logits (A,C)
        or (1,A,C); class 0 is the background."""
        loc = buf.tensors[0].np().reshape(-1, 4)
        cls = buf.tensors[1].np()
        cls = cls.reshape(-1, cls.shape[-1])
        anchors = self._anchors(loc.shape[0])
        cy = loc[:, 0] / _SCALE_XY * anchors[:, 2] + anchors[:, 0]
        cx = loc[:, 1] / _SCALE_XY * anchors[:, 3] + anchors[:, 1]
        h = np.exp(loc[:, 2] / _SCALE_WH) * anchors[:, 2]
        w = np.exp(loc[:, 3] / _SCALE_WH) * anchors[:, 3]
        scores = sigmoid(cls)
        dets = []
        for a in range(loc.shape[0]):
            c = int(scores[a, 1:].argmax()) + 1
            s = float(scores[a, c])
            if s < self.conf_thresh:
                continue
            dets.append(Detection(
                x=float(cx[a] - w[a] / 2), y=float(cy[a] - h[a] / 2),
                w=float(w[a]), h=float(h[a]), class_id=c, score=s))
        return nms(dets, self.iou_thresh)

    def _decode_ov_detection(self, buf: Buffer) -> List[Detection]:
        """``ov-person-detection``: one (200, 7) tensor of rows [image_id,
        label, conf, x_min, y_min, x_max, y_max]; a negative image_id ends
        the list, conf >= 0.8 keeps the row (parity:
        box_properties/ovdetection.cc)."""
        arr = buf.tensors[0].np().reshape(-1, 7)
        dets: List[Detection] = []
        for row in arr:
            if row[0] < 0:
                break
            if row[2] < 0.8:
                continue
            x0, y0, x1, y1 = (float(row[3]), float(row[4]),
                              float(row[5]), float(row[6]))
            dets.append(Detection(
                x=x0, y=y0, w=x1 - x0, h=y1 - y0,
                class_id=int(row[1]), score=float(row[2])))
        return dets

    # MediaPipe palm anchor defaults (box_properties/mppalmdetection.cc)
    _PALM_STRIDES = (8, 16, 16, 16)
    _PALM_MIN_SCALE = 1.0
    _PALM_MAX_SCALE = 1.0
    _PALM_OFFSET = 0.5
    _PALM_INPUT = 192

    def _palm_anchors(self) -> np.ndarray:
        """MediaPipe SSD anchors of the palm model: per run of equal
        strides, two unit-aspect anchors per layer of the run, centers at
        (cell + 0.5)/grid (parity: mp_palm_detection_generate_anchors).
        (A, 4) rows of [y_center, x_center, h, w], built once."""
        if self._palm_anchor_cache is not None:
            return self._palm_anchor_cache
        n = len(self._PALM_STRIDES)

        def scale(i):
            if n == 1:
                return (self._PALM_MIN_SCALE + self._PALM_MAX_SCALE) / 2
            return self._PALM_MIN_SCALE + \
                (self._PALM_MAX_SCALE - self._PALM_MIN_SCALE) * i / (n - 1)

        out: List[List[float]] = []
        layer = 0
        while layer < n:
            run_end = layer
            dims: List[float] = []
            while run_end < n and \
                    self._PALM_STRIDES[run_end] == self._PALM_STRIDES[layer]:
                dims.extend([scale(run_end), scale(run_end + 1)])
                run_end += 1
            grid = int(np.ceil(self._PALM_INPUT /
                               self._PALM_STRIDES[layer]))
            for y in range(grid):
                for x in range(grid):
                    cy = (y + self._PALM_OFFSET) / grid
                    cx = (x + self._PALM_OFFSET) / grid
                    for sc in dims:
                        out.append([cy, cx, sc, sc])
            layer = run_end
        self._palm_anchor_cache = np.asarray(out, np.float32)
        return self._palm_anchor_cache

    def _decode_mp_palm(self, buf: Buffer) -> List[Detection]:
        """``mp-palm-detection``: boxes (A, 18) + raw scores (A,); offsets
        scale by the anchor box relative to the model input size, scores
        pass a sigmoid clamped at ±100, palms suppress at IoU 0.05
        (parity: box_properties/mppalmdetection.cc)."""
        boxes = buf.tensors[0].np().reshape(-1, 18)
        scores = buf.tensors[1].np().ravel()
        anchors = self._palm_anchors()
        a = min(len(anchors), len(boxes), len(scores))
        s = 1.0 / (1.0 + np.exp(-np.clip(scores[:a], -100.0, 100.0)))
        thresh = 0.5 if self._palm_thresh is None else self._palm_thresh
        dets: List[Detection] = []
        for d in np.nonzero(s >= thresh)[0]:
            ay, ax, ah, aw = anchors[d]
            b = boxes[d]
            yc = b[0] / self.in_h * ah + ay
            xc = b[1] / self.in_w * aw + ax
            h = b[2] / self.in_h * ah
            w = b[3] / self.in_w * aw
            dets.append(Detection(
                x=max(float(xc - w / 2), 0.0),
                y=max(float(yc - h / 2), 0.0),
                w=float(w), h=float(h), class_id=0, score=float(s[d])))
        return nms(dets, 0.05)

    def _decode_yolo(self, buf: Buffer, v8: bool) -> List[Detection]:
        t = buf.tensors[0]
        scale = np.array([self.in_w, self.in_h, self.in_w, self.in_h],
                         np.float32)
        if t.is_device:
            # pre-reduced where the tensor lives: only (K, 6) rows cross
            with torch.inference_mode():
                rows = _xfer.to_host(yolo_prereduce(t.torch(), v8)).numpy()
            dets = []
            for r in rows:
                if r[4] < self.conf_thresh:
                    break  # rows are score-sorted: nothing further passes
                cx, cy, w, h = r[:4] / scale
                dets.append(Detection(
                    x=float(cx - w / 2), y=float(cy - h / 2), w=float(w),
                    h=float(h), class_id=int(r[5]), score=float(r[4])))
            return nms(dets, self.iou_thresh)
        out = t.np()
        if v8:
            # (1, 4+C, A) → (A, 4+C); no objectness
            arr = out.reshape(out.shape[-2], out.shape[-1]).T
            boxes, scores = arr[:, :4], arr[:, 4:]
        else:
            # (1, A, 5+C): xywh + objectness + class confidences
            arr = out.reshape(-1, out.shape[-1])
            boxes = arr[:, :4]
            scores = arr[:, 5:] * arr[:, 4:5]
        dets = []
        for a in np.nonzero(scores.max(axis=1) >= self.conf_thresh)[0]:
            c = int(scores[a].argmax())
            cx, cy, w, h = boxes[a] / scale
            dets.append(Detection(
                x=float(cx - w / 2), y=float(cy - h / 2), w=float(w),
                h=float(h), class_id=c, score=float(scores[a, c])))
        return nms(dets, self.iou_thresh)

    def _decode_ssd_postprocess(self, buf: Buffer):
        """Post-processed 4-tensor layout; a batched (B>1) layout yields a
        list of per-frame detection lists."""
        boxes_t = buf.tensors[0].np()
        # (1,N,4) is the canonical single-frame layout — flatten; only a
        # true multi-frame batch (B>1) takes the batched branch
        if boxes_t.ndim == 3 and boxes_t.shape[0] > 1:
            classes = buf.tensors[1].np()
            scores = buf.tensors[2].np()
            nums = buf.tensors[3].np().reshape(-1) \
                if buf.num_tensors > 3 else None
            return [
                self._ssd_pp_frame(boxes_t[b], classes[b], scores[b],
                                   int(nums[b]) if nums is not None
                                   else scores.shape[1])
                for b in range(boxes_t.shape[0])]
        boxes = boxes_t.reshape(-1, 4)
        classes = buf.tensors[1].np().reshape(-1)
        scores = buf.tensors[2].np().reshape(-1)
        n = int(buf.tensors[3].np().reshape(-1)[0]) \
            if buf.num_tensors > 3 else len(scores)
        return self._ssd_pp_frame(boxes, classes, scores, n)

    def _ssd_pp_frame(self, boxes, classes, scores, n) -> List[Detection]:
        dets = []
        for i in range(min(n, len(scores))):
            if scores[i] < self.conf_thresh:
                continue
            ymin, xmin, ymax, xmax = boxes[i]
            dets.append(Detection(
                x=float(xmin), y=float(ymin), w=float(xmax - xmin),
                h=float(ymax - ymin), class_id=int(classes[i]),
                score=float(scores[i])))
        return dets  # already NMS'd by the model

    # -- device render path --------------------------------------------------

    def _device_active(self) -> bool:
        return self.backend == "device" and self.scheme in _PP_SCHEMES

    def wants_host_input(self) -> bool:
        # the device renderer consumes the tensors where they are
        return not self._device_active()

    def prereduce_active(self, buf: Buffer) -> bool:
        # the yolo schemes take the top-k of a device-resident frame on its
        # device; every other scheme reads the whole input on the host and
        # leaves the packed drain to tensor_decoder
        return self.scheme in ("yolov5", "yolov8") and \
            any(t.is_device for t in buf.tensors)

    def device_post_program(self):
        """For the fusion pass (runtime/fusion.py): an epilogue mapping the
        upstream filter's postprocess outputs (boxes, classes, scores,
        num) to (canvas, boxes, classes, scores, num), so transform +
        model + NMS + overlay run as one program per window.  None when
        this configuration does not render on the device."""
        if not self._device_active():
            return None
        out_h, out_w, conf = self.out_h, self.out_w, self.conf_thresh

        def post(*outs):
            boxes = outs[0]
            if boxes.ndim == 2:
                boxes = boxes[None]
            b, n = boxes.shape[0], boxes.shape[1]
            classes = outs[1].reshape(b, n)
            scores = outs[2].reshape(b, n)
            num = outs[3].reshape(b) if len(outs) > 3 \
                else torch.full((b,), n, dtype=torch.int32,
                                device=boxes.device)
            canvas = device_render(boxes, classes, scores, num, out_h,
                                   out_w, conf)
            return (canvas, *outs)

        post.chain_digest = "bounding_boxes:%s:%dx%d:%s" % (
            self.scheme, out_w, out_h, conf)
        return post

    def _decode_fused(self, buf: Buffer) -> Buffer:
        """Consume the fused program's output: tensor 0 is the rendered
        canvas; 1.. are the model's postprocess tensors, kept on the
        device as ``meta["detections_device"]``."""
        canvas = buf.tensors[0].torch()
        batched = canvas.ndim == 4 and canvas.shape[0] > 1
        if canvas.ndim == 4 and not batched:
            canvas = canvas[0]
        out = Buffer(
            tensors=[Tensor(canvas,
                            TensorSpec.from_shape(tuple(canvas.shape),
                                                  np.uint8))],
            pts=buf.pts, duration=buf.duration, meta=dict(buf.meta))
        if buf.num_tensors >= 4:
            boxes = buf.tensors[1].torch()
            if boxes.ndim == 2:
                boxes = boxes[None]
            b, n = boxes.shape[0], boxes.shape[1]
            out.meta["detections_device"] = {
                "boxes": boxes,
                "classes": buf.tensors[2].torch().reshape(b, n),
                "scores": buf.tensors[3].torch().reshape(b, n),
                "num": buf.tensors[4].torch().reshape(b)
                if buf.num_tensors > 4
                else torch.full((b,), n, dtype=torch.int32,
                                device=boxes.device)}
        return out

    def _decode_device(self, buf: Buffer) -> Buffer:
        """Rasterize the overlay on the tensors' device (option7=device,
        unfused): the four postprocess tensors stay where they are and the
        (B,H,W,4) canvas is returned as a device tensor."""
        boxes = buf.tensors[0].torch()
        # single-frame layouts ((N,4) or (1,N,4)) keep the host path's
        # (H,W,4) output rank; only a true batch (B>1) emits (B,H,W,4)
        batched = boxes.ndim == 3 and boxes.shape[0] > 1
        if boxes.ndim == 2:
            boxes = boxes[None]
        b, n = boxes.shape[0], boxes.shape[1]
        classes = buf.tensors[1].torch().reshape(b, n)
        scores = buf.tensors[2].torch().reshape(b, n)
        num = buf.tensors[3].torch().reshape(b) if buf.num_tensors > 3 \
            else torch.full((b,), n, dtype=torch.int32, device=boxes.device)
        with torch.inference_mode():
            canvas = device_render(boxes, classes, scores, num, self.out_h,
                                   self.out_w, self.conf_thresh)
        if not batched:
            canvas = canvas[0]
        out = Buffer(
            tensors=[Tensor(canvas,
                            TensorSpec.from_shape(tuple(canvas.shape),
                                                  np.uint8))],
            pts=buf.pts, duration=buf.duration, meta=dict(buf.meta))
        out.meta["detections_device"] = {
            "boxes": boxes, "classes": classes, "scores": scores,
            "num": num}
        return out

    # -- decode --------------------------------------------------------------

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        if self._device_active():
            if self.labels and not self._warned_device_labels:
                self._warned_device_labels = True
                _log.warning(
                    "bounding_boxes: option7=device draws boxes only — "
                    "label text (option2) is not rasterized on the device; "
                    "use option7=host for labeled overlays")
            # fused path: tensor 0 must actually BE a canvas (uint8, rank
            # 3/4) — a withdrawn fusion (flexible stream) leaves raw
            # detection tensors, which route to the normal renderer
            if self.fused_upstream and buf.num_tensors >= 1 and \
                    buf.tensors[0].spec.rank >= 3 and \
                    buf.tensors[0].spec.dtype.torch_dtype == torch.uint8:
                return self._decode_fused(buf)
            return self._decode_device(buf)
        scheme = self.scheme
        if scheme in ("yolov5", "yolov8"):
            # pre-reduces on the device instead: no drain of the raw tensor
            dets = self._decode_yolo(buf, v8=scheme == "yolov8")
        elif scheme == "mobilenet-ssd":
            dets = self._decode_mobilenet_ssd(buf)
        elif scheme == "ov-person-detection":
            dets = self._decode_ov_detection(buf)
        elif scheme == "mp-palm-detection":
            dets = self._decode_mp_palm(buf)
        else:
            dets = self._decode_ssd_postprocess(buf)
        batched = bool(dets) and isinstance(dets[0], list)
        for d in (x for f in dets for x in f) if batched else dets:
            if d.class_id < len(self.labels):
                d.label = self.labels[d.class_id]
        labels = bool(self.labels)
        if batched:
            frame = np.zeros((len(dets), self.out_h, self.out_w, 4),
                             np.uint8)
            for b, f in enumerate(dets):
                draw_boxes(f, self.out_w, self.out_h, labels=labels,
                           out=frame[b])
        else:
            frame = draw_boxes(dets, self.out_w, self.out_h, labels=labels)
        out = Buffer(
            tensors=[Tensor(frame,
                            TensorSpec.from_shape(frame.shape, np.uint8))],
            pts=buf.pts, duration=buf.duration, meta=dict(buf.meta))
        out.meta["detections"] = dets
        return out
