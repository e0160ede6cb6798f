"""The port's decoders against the JAX package's.

``image_labeling``: the same score tensors through both packages' decoders
give the same label, index, score, payload and caps; the port's device
path (a torch tensor, argmax on its device) equals its host path (numpy),
ties resolved to the first index.

The raw box schemes (``mobilenet-ssd``, ``yolov5``, ``yolov8``): the
same seeded tensors through both packages' host decoders give the same
detections (exact: the same numpy arithmetic) and the same canvas bytes;
the port's pre-reduce (a tensor that lives on a device) gives the same
(K, 6) rows as the JAX package's, ties in the JAX order, and the same
detections as the host decode; option3 sets the yolo thresholds.

The box overlay renderers:

Byte-exact: the device renderer (``device_render``) against the JAX
package's ``device_render_fn`` on the same detections, and against the
port's own host ``draw_boxes``.  The cases cover overlapping boxes (later
boxes win), boxes thinner than the stroke, classes past the palette,
``num < N`` and scores under the threshold.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.decoders import boxutil as jbox
from nnstreamer_tpu_torch.decoders import boxutil
from nnstreamer_tpu_torch.decoders.boundingbox import BoundingBoxes

H, W, CONF = 40, 48, 0.25


def _detections(seed: int, batch: int = 3, n: int = 7):
    rng = np.random.default_rng(seed)
    y0 = rng.uniform(-0.1, 0.9, (batch, n))
    x0 = rng.uniform(-0.1, 0.9, (batch, n))
    boxes = np.stack([y0, x0, y0 + rng.uniform(0, 0.6, (batch, n)),
                      x0 + rng.uniform(0, 0.6, (batch, n))], -1)
    boxes[0, 0] = [0.2, 0.2, 0.21, 0.7]     # thinner than the stroke
    boxes[0, 1] = [0.1, 0.1, 0.8, 0.8]      # overlaps box 2 ...
    boxes[0, 2] = [0.3, 0.3, 0.6, 0.6]      # ... and loses nothing of it
    boxes[1, 3] = [0.5, 0.5, 0.5, 0.5]      # a single point
    classes = rng.integers(0, 15, (batch, n)).astype(np.int32)  # > palette
    scores = rng.uniform(0, 1, (batch, n)).astype(np.float32)
    scores[0, :3] = 0.9
    num = np.array([n, n - 3, 2], np.int32)[:batch]                # num < N
    return boxes.astype(np.float32), classes, scores, num


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_render_matches_jax_byte_exact(seed):
    boxes, classes, scores, num = _detections(seed)
    want = np.asarray(jbox.device_render_fn(*boxes.shape[:2], H, W, CONF)(
        boxes, classes, scores, num))
    got = boxutil.device_render(
        torch.from_numpy(boxes), torch.from_numpy(classes),
        torch.from_numpy(scores), torch.from_numpy(num), H, W, CONF)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert got[..., 3].max() == 255  # alpha (bit 24, the sign bit) set


@pytest.mark.parametrize("seed", [0, 3])
def test_device_render_equals_host_draw_boxes(seed):
    boxes, classes, scores, num = _detections(seed)
    dev = BoundingBoxes()
    for i, v in ((0, "mobilenet-ssd-postprocess"), (3, f"{W}:{H}"),
                 (6, "device")):
        dev.set_option(i, v)
    host = BoundingBoxes()
    host.set_option(3, f"{W}:{H}")
    from nnstreamer_tpu_torch.core import Buffer

    buf = Buffer.of(torch.from_numpy(boxes), torch.from_numpy(classes),
                    torch.from_numpy(scores), torch.from_numpy(num))
    got = dev.decode(buf, None).tensors[0].np()
    hbuf = Buffer.of(boxes, classes.astype(np.float32), scores, num)
    want = host.decode(hbuf, None).tensors[0].np()
    assert got.shape == want.shape == (3, H, W, 4)
    assert np.array_equal(got, want)


def test_unported_scheme_and_labels_raise():
    dec = BoundingBoxes()
    for scheme in ("ov-person-detection", "mp-palm-detection"):
        with pytest.raises(NotImplementedError, match=scheme):
            dec.set_option(0, scheme)
    with pytest.raises(NotImplementedError, match="label"):
        BoundingBoxes().set_option(1, "labels.txt")


# -- image_labeling -----------------------------------------------------------

from nnstreamer_tpu.core import Buffer as JBuffer  # noqa: E402
from nnstreamer_tpu.core import TensorsSpec as JTensorsSpec  # noqa: E402
from nnstreamer_tpu.decoders.imagelabel import (  # noqa: E402
    ImageLabeling as JImageLabeling,
)
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec  # noqa: E402
from nnstreamer_tpu_torch.decoders import find_decoder  # noqa: E402
from nnstreamer_tpu_torch.decoders.imagelabel import (  # noqa: E402
    ImageLabeling,
    argmax_pair,
)


def _labels(tmp_path, n=7):
    path = tmp_path / "labels.txt"
    path.write_text("".join(f"class {i}\n" for i in range(n)) + "\n")
    return str(path)


@pytest.mark.parametrize("shape", [(10,), (4, 10), (2, 1, 10)])
def test_image_labeling_matches_jax(tmp_path, shape):
    """One label per buffer: the argmax over the WHOLE flattened tensor,
    so a batch gives one label; an index past the labels file gives its
    decimal string."""
    path = _labels(tmp_path)
    scores = np.random.default_rng(len(shape)).standard_normal(shape) \
        .astype(np.float32)
    jdec, tdec = JImageLabeling(), ImageLabeling()
    jdec.set_option(0, path)
    tdec.set_option(0, path)
    want = jdec.decode(JBuffer.of(scores, pts=5), None)
    for arr in (scores, torch.from_numpy(scores)):   # host, then tensor
        got = tdec.decode(Buffer.of(arr, pts=5), None)
        for k in ("label", "label_index", "score"):
            assert got.meta[k] == want.meta[k], k
        assert got.pts == 5
        assert got.tensors[0].np().tobytes() == want.tensors[0].tobytes()
    assert want.meta["label_index"] == int(np.argmax(scores))
    spec = TensorsSpec.from_shapes([shape], np.float32)
    jspec = JTensorsSpec.from_shapes([shape], np.float32)
    assert str(tdec.out_caps(spec)) == str(jdec.out_caps(jspec))
    assert "text/x-raw" in str(tdec.out_caps(spec))


def test_image_labeling_past_the_labels_and_ties(tmp_path):
    dec = find_decoder("image_labeling")()
    dec.set_option(0, _labels(tmp_path, n=3))
    x = np.zeros((2, 5), np.float32)
    x[1, 2] = x[1, 4] = 3.5                    # tie: the first index wins
    for arr in (x, torch.from_numpy(x)):
        out = dec.decode(Buffer.of(arr), None)
        assert (out.meta["label"], out.meta["label_index"],
                out.meta["score"]) == ("7", 7, 3.5)
    pair = argmax_pair(torch.from_numpy(x).bfloat16())
    assert pair.dtype == torch.float32 and pair.tolist() == [7.0, 3.5]


# -- the raw box schemes ---------------------------------------------------------

from nnstreamer_tpu.decoders import boundingbox as jbb  # noqa: E402
from nnstreamer_tpu_torch.decoders import boundingbox as tbb  # noqa: E402

SIZE_IN, C, A = 64, 6, 84


def _yolo_tensor(v8: bool, seed: int, ties: bool = False) -> np.ndarray:
    """A raw yolo tensor: pixel xywh and confidences, a few anchors
    confident (v5: objectness × class), ``ties`` repeating scores."""
    rng = np.random.default_rng(seed)
    xywh = np.concatenate([rng.uniform(0, SIZE_IN, (A, 2)),
                           rng.uniform(2, SIZE_IN / 2, (A, 2))], axis=1)
    conf = rng.uniform(0, 0.3, (A, C))
    hot = rng.choice(A, 12, replace=False)
    conf[hot, rng.integers(0, C, 12)] = rng.uniform(0.4, 1.0, 12)
    if ties:
        conf[hot[:6], :] = 0.75
    if v8:
        arr = np.concatenate([xywh, conf], axis=1).T[None]    # (1, 4+C, A)
    else:
        obj = rng.uniform(0.5, 1.0, (A, 1))
        arr = np.concatenate([xywh, obj, conf], axis=1)[None]  # (1, A, 5+C)
    return arr.astype(np.float32)


def _ssd_tensors(seed: int):
    from nnstreamer_tpu_torch.models import feature_sizes_for, ssd_anchors

    n = len(ssd_anchors(SIZE_IN, feature_sizes_for(SIZE_IN)))
    rng = np.random.default_rng(seed)
    loc = rng.standard_normal((1, n, 4)).astype(np.float32)
    cls = rng.normal(-4, 1.5, (1, n, C)).astype(np.float32)
    return loc, cls


def _decoders(scheme, opt3=""):
    decs = []
    for cls in (jbb.BoundingBoxes, tbb.BoundingBoxes):
        d = cls()
        for i, v in ((0, scheme), (2, opt3), (3, f"{W}:{H}"),
                     (4, f"{SIZE_IN}:{SIZE_IN}")):
            if v:
                d.set_option(i, v)
        decs.append(d)
    return decs


def _key(dets):
    return [(d.class_id, d.score, d.x, d.y, d.w, d.h) for d in dets]


@pytest.mark.parametrize("scheme,seed", [("yolov8", 0), ("yolov8", 1),
                                         ("yolov5", 2), ("yolov5", 3),
                                         ("mobilenet-ssd", 4),
                                         ("mobilenet-ssd", 5)])
def test_raw_scheme_host_decode_matches_jax(scheme, seed):
    if scheme == "mobilenet-ssd":
        arrays = _ssd_tensors(seed)
    else:
        arrays = (_yolo_tensor(scheme == "yolov8", seed),)
    jdec, tdec = _decoders(scheme)
    want = jdec.decode(JBuffer.of(*arrays, pts=3), None)
    got = tdec.decode(Buffer.of(*arrays, pts=3), None)
    assert want.meta["detections"], "the case must detect something"
    assert _key(got.meta["detections"]) == _key(want.meta["detections"])
    assert got.tensors[0].np().tobytes() == want.tensors[0].tobytes()
    assert got.pts == 3


@pytest.mark.parametrize("v8", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_yolo_prereduce_matches_jax_rows(v8, ties):
    arr = _yolo_tensor(v8, 7, ties=ties)
    want = np.asarray(jbb._yolo_prereduce_fn(arr.shape, v8, 16)(arr))
    got = tbb.yolo_prereduce(torch.from_numpy(arr), v8, 16).numpy()
    assert got.shape == want.shape == (16, 6)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("scheme", ["yolov8", "yolov5"])
@pytest.mark.parametrize("opt3", ["", "0.5:0.3"])
def test_yolo_prereduce_decode_equals_host_decode(scheme, opt3):
    """A tensor that lives on a device (a torch tensor here) is
    pre-reduced; a host array is decoded whole: the same detections."""
    arr = _yolo_tensor(scheme == "yolov8", 8)
    _, tdec = _decoders(scheme, opt3)
    host = tdec.decode(Buffer.of(arr), None)
    dev = tdec.decode(Buffer.of(torch.from_numpy(arr)), None)
    assert host.meta["detections"]
    assert sorted(_key(dev.meta["detections"])) == \
        sorted(_key(host.meta["detections"]))
    assert dev.tensors[0].np().tobytes() == host.tensors[0].tobytes()
    if opt3:
        assert (tdec.conf_thresh, tdec.iou_thresh) == (0.5, 0.3)
        assert min(d.score for d in host.meta["detections"]) >= 0.5


def test_raw_scheme_caps_are_one_frame():
    for scheme, shape in (("yolov8", (2, 4 + C, A)),
                          ("yolov5", (2, A, 5 + C)),
                          ("mobilenet-ssd", (2, A, 4))):
        jdec, tdec = _decoders(scheme)
        caps = str(tdec.out_caps(TensorsSpec.from_shapes([shape],
                                                         np.float32)))
        assert "frames=" not in caps and "width=48" in caps
        assert caps == str(jdec.out_caps(JTensorsSpec.from_shapes(
            [shape], np.float32)))


def test_mobilenet_ssd_priors_file_matches_jax(tmp_path):
    """option3 names a box-priors file for ``mobilenet-ssd``: both
    packages decode against it (here a shifted anchor table, so the
    synthesized one would give other boxes)."""
    from nnstreamer_tpu_torch.models import feature_sizes_for, ssd_anchors

    priors = ssd_anchors(SIZE_IN, feature_sizes_for(SIZE_IN)) + 0.01
    path = tmp_path / "priors.txt"
    np.savetxt(path, priors)
    loc, cls = _ssd_tensors(9)
    jdec, tdec = _decoders("mobilenet-ssd", str(path))
    assert tdec.priors is not None and tdec.priors.shape == priors.shape
    want = jdec.decode(JBuffer.of(loc, cls), None)
    got = tdec.decode(Buffer.of(loc, cls), None)
    _, plain = _decoders("mobilenet-ssd")
    other = plain.decode(Buffer.of(loc, cls), None)
    assert want.meta["detections"]
    assert _key(got.meta["detections"]) == _key(want.meta["detections"])
    assert _key(other.meta["detections"]) != _key(got.meta["detections"])
