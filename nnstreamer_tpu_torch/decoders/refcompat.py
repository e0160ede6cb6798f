"""Reference-exact bounding-box decode semantics (host compat path).

Counterpart of the JAX package's ``decoders/refcompat.py``.  The
reference pins its box decoders against recorded outputs of trained
detectors and byte-compares the rendered overlay with golden frames.
This module reimplements, from the reference's documented behavior, the
exact decode semantics needed to reproduce those renders bit for bit on
the box geometry:

- integer truncation of box coords in input-image space
  (box_properties/yolo.cc ``object.x = (int)(MAX(0, cx-w/2))``);
- STRICT ``>`` confidence threshold (yolo.cc: v5 includes the objectness
  product, v8 class conf only);
- GLOBAL prob-sorted greedy NMS with the +1-inclusive integer IoU and
  strict ``>`` suppression (tensordec-boundingbox.cc);
- output scaling by integer division and 1-px red (0xFF0000FF RGBA)
  borders (tensordec-boundingbox.cc draw()).

Label glyphs (the reference's 8x13 ``rasters`` font) are not reproduced;
:func:`label_mask` returns the glyph regions so golden comparisons
exclude exactly those pixels and nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

PIXEL_VALUE = np.uint32(0xFF0000FF)  # RED 100% in RGBA, as the ref


@dataclasses.dataclass
class RefDetection:
    """Integer-pixel detection in INPUT image space (the reference's
    ``detectedObject``)."""

    x: int
    y: int
    width: int
    height: int
    class_id: int
    prob: float
    tracking_id: int = 0


def ref_iou(a: RefDetection, b: RefDetection) -> float:
    """Integer, +1-inclusive IoU (tensordec-boundingbox.cc:317)."""
    x1 = max(a.x, b.x)
    y1 = max(a.y, b.y)
    x2 = min(a.x + a.width, b.x + b.width)
    y2 = min(a.y + a.height, b.y + b.height)
    w = max(0, x2 - x1 + 1)
    h = max(0, y2 - y1 + 1)
    inter = float(w * h)
    union = float(a.width * a.height + b.width * b.height) - inter
    o = inter / union if union else 0.0
    return o if o >= 0 else 0.0


def ref_nms(dets: List[RefDetection], threshold: float
            ) -> List[RefDetection]:
    """Global (class-agnostic) greedy NMS, prob-descending, STRICT
    ``>`` suppression (tensordec-boundingbox.cc:336)."""
    dets = sorted(dets, key=lambda d: -d.prob)
    alive = [True] * len(dets)
    for i, a in enumerate(dets):
        if not alive[i]:
            continue
        for j in range(i + 1, len(dets)):
            if alive[j] and ref_iou(a, dets[j]) > threshold:
                alive[j] = False
    return [d for d, ok in zip(dets, alive) if ok]


def yolo_decode(arr: np.ndarray, v8: bool, conf_threshold: float,
                iou_threshold: float, in_w: int, in_h: int,
                scaled_output: bool) -> List[RefDetection]:
    """Decode a yolov5 (A, 5+C) or yolov8 (A, 4+C) float array with the
    reference's exact semantics (box_properties/yolo.cc decode)."""
    arr = np.asarray(arr, np.float32)
    start = 4 if v8 else 5
    confs = arr[:, start:]
    max_idx = confs.argmax(axis=1)
    max_val = confs[np.arange(len(arr)), max_idx]
    eff = max_val if v8 else max_val * arr[:, 4]
    dets: List[RefDetection] = []
    for b in np.nonzero(eff > conf_threshold)[0]:
        cx, cy, w, h = (float(v) for v in arr[b, :4])
        if not scaled_output:
            cx *= in_w
            cy *= in_h
            w *= in_w
            h *= in_h
        dets.append(RefDetection(
            x=int(max(0.0, cx - w / 2.0)),
            y=int(max(0.0, cy - h / 2.0)),
            width=int(min(float(in_w), w)),
            height=int(min(float(in_h), h)),
            class_id=int(max_idx[b]),
            prob=float(eff[b])))
    return ref_nms(dets, iou_threshold)


def mobilenet_ssd_decode(loc: np.ndarray, scores: np.ndarray,
                         priors: np.ndarray, threshold: float,
                         iou_threshold: float, in_w: int, in_h: int,
                         y_scale: float = 10.0, x_scale: float = 10.0,
                         h_scale: float = 5.0, w_scale: float = 5.0
                         ) -> List[RefDetection]:
    """Decode the raw 2-tensor mobilenet-ssd layout against a prior
    table (box_properties/mobilenetssd.cc _get_object_i_mobilenet_ssd):
    per box, the best class c >= 1 whose LOGIT passes
    ``logit(threshold)`` (inclusive >=) wins; float32 prior box math
    with the 10/10/5/5 scales, C-truncation to int pixels with only
    x/y clamped at 0, then the global reference NMS."""
    loc = np.asarray(loc, np.float32).reshape(-1, 4)
    scores = np.asarray(scores, np.float32)
    scores = scores.reshape(-1, scores.shape[-1])
    priors = np.asarray(priors, np.float32)
    # threshold compares in the LOGIT domain (mobilenetssd.cc:84,152)
    sig_thresh = np.float32(np.log(threshold / (1.0 - threshold)))
    dets: List[RefDetection] = []
    logits = scores[:, 1:]
    best = logits.argmax(axis=1)
    best_logit = logits[np.arange(len(logits)), best]
    for b in np.nonzero(best_logit >= sig_thresh)[0]:
        f = np.float32
        # priors rows: [ycenter, xcenter, h, w] normalized
        ycenter = loc[b, 0] / f(y_scale) * priors[b, 2] + priors[b, 0]
        xcenter = loc[b, 1] / f(x_scale) * priors[b, 3] + priors[b, 1]
        hh = f(np.exp(loc[b, 2] / f(h_scale))) * priors[b, 2]
        ww = f(np.exp(loc[b, 3] / f(w_scale))) * priors[b, 3]
        ymin = ycenter - hh / f(2.0)
        xmin = xcenter - ww / f(2.0)
        score = 1.0 / (1.0 + np.exp(-float(best_logit[b])))
        dets.append(RefDetection(
            x=max(0, int(xmin * in_w)), y=max(0, int(ymin * in_h)),
            width=int(ww * in_w), height=int(hh * in_h),
            class_id=int(best[b]) + 1, prob=float(score)))
    return ref_nms(dets, iou_threshold)


def ssd_pp_decode(boxes: np.ndarray, classes: np.ndarray,
                  scores: np.ndarray, num: int, in_w: int, in_h: int,
                  threshold: float = float(np.finfo(np.float32).tiny)
                  ) -> List[RefDetection]:
    """Post-processed SSD layout (box_properties/mobilenetssdpp.cc
    _get_objects_mobilenet_ssd_pp): rows [ymin, xmin, ymax, xmax]
    clamped to [0,1], strict ``< threshold`` skip (default G_MINFLOAT —
    a score of exactly 0 is dropped), C truncation, NO nms (the model
    already suppressed)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    dets: List[RefDetection] = []
    for d in range(min(int(num), len(boxes))):
        if scores[d] < threshold:
            continue
        y1 = min(max(float(boxes[d, 0]), 0.0), 1.0)
        x1 = min(max(float(boxes[d, 1]), 0.0), 1.0)
        y2 = min(max(float(boxes[d, 2]), 0.0), 1.0)
        x2 = min(max(float(boxes[d, 3]), 0.0), 1.0)
        dets.append(RefDetection(
            x=int(x1 * in_w), y=int(y1 * in_h),
            width=int((x2 - x1) * in_w), height=int((y2 - y1) * in_h),
            class_id=int(classes[d]), prob=float(scores[d])))
    return dets


def palm_anchors(min_scale: float = 1.0, max_scale: float = 1.0,
                 offset_x: float = 0.5, offset_y: float = 0.5,
                 strides: Sequence[int] = (8, 16, 16, 16),
                 input_size: int = 192) -> np.ndarray:
    """MediaPipe SSD anchor table [x_center, y_center, w, h] per row
    (box_properties/mppalmdetection.cc
    mp_palm_detection_generate_anchors)."""
    n = len(strides)

    def calc_scale(i):
        if n == 1:
            return (min_scale + max_scale) * 0.5
        return min_scale + (max_scale - min_scale) * i / (n - 1.0)

    rows = []
    layer = 0
    while layer < n:
        scales = []
        last = layer
        while last < n and strides[last] == strides[layer]:
            scales.append(calc_scale(last))
            scales.append(calc_scale(last + 1))
            last += 1
        fm = int(np.ceil(input_size / strides[layer]))
        for y in range(fm):
            for x in range(fm):
                for s in scales:
                    rows.append([(x + offset_x) / fm,
                                 (y + offset_y) / fm, s, s])
        layer = last
    return np.asarray(rows, np.float32)


def palm_decode(boxes: np.ndarray, scores: np.ndarray,
                anchors: np.ndarray, threshold: float,
                in_w: int, in_h: int) -> List[RefDetection]:
    """mp-palm-detection decode (mppalmdetection.cc
    _get_objects_mp_palm_detection): score clamped to +-100 then
    sigmoid, strict ``< threshold`` skip, anchor box math dividing by
    the INPUT size, x/y clamped at 0, then the reference nms at the
    hard-coded 0.05 IoU."""
    boxes = np.asarray(boxes, np.float32)
    boxes = boxes.reshape(len(anchors), -1)
    dets: List[RefDetection] = []
    for d in range(len(anchors)):
        score = float(np.clip(float(scores.reshape(-1)[d]),
                              -100.0, 100.0))
        score = 1.0 / (1.0 + np.exp(-score))
        if score < threshold:
            continue
        ax, ay, aw, ah = (float(v) for v in anchors[d])
        y_center = float(boxes[d, 0]) / in_h * ah + ay
        x_center = float(boxes[d, 1]) / in_w * aw + ax
        h = float(boxes[d, 2]) / in_h * ah
        w = float(boxes[d, 3]) / in_w * aw
        dets.append(RefDetection(
            x=max(0, int((x_center - w / 2.0) * in_w)),
            y=max(0, int((y_center - h / 2.0) * in_h)),
            width=int(w * in_w), height=int(h * in_h),
            class_id=0, prob=score))
    return ref_nms(dets, 0.05)


def load_box_priors(path: str) -> np.ndarray:
    """box_priors.txt: 4 lines x A columns of floats — rows are
    [ycenter, xcenter, h, w] per anchor (tensordecutil.c
    _init_anchors layout used by mobilenetssd.cc)."""
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if ln:
                rows.append([float(v) for v in ln.split()])
    a = np.asarray(rows, np.float32)
    if a.shape[0] == 4:
        a = a.T  # (A, 4)
    return a


def draw_reference(dets: Sequence[RefDetection], out_w: int, out_h: int,
                   in_w: int, in_h: int) -> np.ndarray:
    """Render the reference's exact border geometry: returns an
    (out_h, out_w) uint32 RGBA-word canvas with 1-px PIXEL_VALUE
    borders, background 0 (tensordec-boundingbox.cc draw(), box part
    only — label glyphs are excluded by design, see module doc)."""
    frame = np.zeros((out_h, out_w), np.uint32)
    for a in dets:
        x1 = (out_w * a.x) // in_w
        x2 = min(out_w - 1, (out_w * (a.x + a.width)) // in_w)
        y1 = (out_h * a.y) // in_h
        y2 = min(out_h - 1, (out_h * (a.y + a.height)) // in_h)
        if x1 > x2 or y1 > y2 or y1 >= out_h or x1 >= out_w:
            # a box fully past the canvas: the reference's C writes out
            # of bounds here (silent corruption); we skip instead —
            # valid inputs are unaffected, hostile ones can't crash
            continue
        frame[y1, x1:x2 + 1] = PIXEL_VALUE
        frame[y2, x1:x2 + 1] = PIXEL_VALUE
        for yy in range(y1 + 1, y2):
            frame[yy, x1] = PIXEL_VALUE
            frame[yy, x2] = PIXEL_VALUE
    return frame


def label_mask(dets: Sequence[RefDetection], labels: Sequence[str],
               out_w: int, out_h: int, in_w: int, in_h: int,
               track: bool = False) -> np.ndarray:
    """(out_h, out_w) bool mask of the glyph blocks the reference's
    label pass writes (8x13 per char, 9-px advance, anchored 14 rows
    above the box top; chars stop at the right edge) — the pixels a
    golden comparison must exclude because we do not reproduce the
    font table."""
    mask = np.zeros((out_h, out_w), bool)
    for a in dets:
        if a.class_id < 0 or a.class_id >= len(labels):
            continue
        text = labels[a.class_id]
        if track:
            text = f"{text}-{a.tracking_id}"
        x1 = (out_w * a.x) // in_w
        y1 = (out_h * a.y) // in_h
        y1 = max(0, y1 - 14)
        for _ch in text:
            if x1 + 8 > out_w:
                break
            mask[y1:y1 + 13, x1:x1 + 8] = True
            x1 += 9
    return mask
