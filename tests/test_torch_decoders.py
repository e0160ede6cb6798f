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

``ov-person-detection`` and ``mp-palm-detection``: detections and
canvases equal to the JAX package's (the palm anchors too, and option3's
palm threshold).  Label text (option2): the host canvas equals the JAX
package's byte for byte (both packages see the same PIL in one process)
and differs from the box-only canvas in label pixels only;
``option7=device`` with option2 warns once and draws the box-only
device canvas.  ``direct_video`` and ``octet_stream`` equal the JAX
package's output and caps.  ``refcompat`` (the reference-exact decode
and render) equals the JAX package's on seeded tensors.

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


def test_unported_scheme_and_labels_raise(tmp_path):
    """Every scheme the JAX package decodes is accepted; a scheme neither
    package knows and a missing label file raise."""
    dec = BoundingBoxes()
    for scheme in ("ov-person-detection", "mp-palm-detection"):
        dec.set_option(0, scheme)
        assert dec.scheme == scheme
    with pytest.raises(ValueError, match="no-such-scheme"):
        dec.set_option(0, "no-such-scheme")
    from nnstreamer_tpu.core import Buffer as JBuffer
    from nnstreamer_tpu.decoders.boundingbox import BoundingBoxes as JBB

    jdec = JBB()
    jdec.set_option(0, "no-such-scheme")
    with pytest.raises(ValueError, match="no-such-scheme"):
        jdec.decode(JBuffer.of(np.zeros(4, np.float32)), None)
    missing = str(tmp_path / "no-labels.txt")
    for cls in (BoundingBoxes, JBB):
        with pytest.raises(FileNotFoundError):
            cls().set_option(1, missing)


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


# -- ov-person, mp-palm, label text ------------------------------------------


def _ov_rows(seed):
    rng = np.random.default_rng(seed)
    rows = np.zeros((200, 7), np.float32)
    n = 12
    x0, y0 = rng.uniform(0, 0.7, n), rng.uniform(0, 0.7, n)
    rows[:n] = np.stack([np.zeros(n), rng.integers(0, 4, n),
                         rng.uniform(0.5, 1.0, n), x0, y0,
                         x0 + rng.uniform(0.05, 0.3, n),
                         y0 + rng.uniform(0.05, 0.3, n)], -1)
    rows[n][0] = -1                              # the list ends here
    rows[n + 1] = [0, 1, 0.99, 0.1, 0.1, 0.5, 0.5]  # never read
    return rows


def _palm_tensors(seed):
    rng = np.random.default_rng(seed)
    boxes = (rng.standard_normal((2016, 18)) * 20).astype(np.float32)
    scores = rng.normal(-6, 3, (2016, 1)).astype(np.float32)
    scores[rng.choice(2016, 30, replace=False)] = 150.0   # clamped
    return boxes, scores


def _both(scheme, *opts):
    decs = []
    for cls in (jbb.BoundingBoxes, tbb.BoundingBoxes):
        d = cls()
        d.set_option(0, scheme)
        for i, v in opts:
            d.set_option(i, v)
        decs.append(d)
    return decs


@pytest.mark.parametrize("seed", [0, 1])
def test_ov_person_matches_jax(seed):
    rows = _ov_rows(seed)
    jdec, tdec = _both("ov-person-detection", (3, "160:120"))
    want = jdec.decode(JBuffer.of(rows), None)
    got = tdec.decode(Buffer.of(rows), None)
    assert want.meta["detections"]
    assert _key(got.meta["detections"]) == _key(want.meta["detections"])
    assert all(d.score >= 0.8 for d in got.meta["detections"])
    assert got.tensors[0].np().tobytes() == want.tensors[0].tobytes()


@pytest.mark.parametrize("seed,opt3", [(0, ""), (1, "0.7:4:1.0:1.0"),
                                       (2, "0.3")])
def test_mp_palm_matches_jax(seed, opt3):
    boxes, scores = _palm_tensors(seed)
    opts = [(3, "160:120"), (4, "300:300")] + ([(2, opt3)] if opt3 else [])
    jdec, tdec = _both("mp-palm-detection", *opts)
    np.testing.assert_array_equal(tdec._palm_anchors(), jdec._palm_anchors())
    assert tdec._palm_anchors().shape == (2016, 4)
    want = jdec.decode(JBuffer.of(boxes, scores), None)
    got = tdec.decode(Buffer.of(boxes, scores), None)
    assert want.meta["detections"]
    assert _key(got.meta["detections"]) == _key(want.meta["detections"])
    assert got.tensors[0].np().tobytes() == want.tensors[0].tobytes()
    if opt3:
        assert tdec._palm_thresh == float(opt3.split(":")[0])


def _pp_frame(seed):
    boxes, classes, scores, num = _detections(seed)
    return boxes[0], classes[0].astype(np.float32), scores[0], num[:1]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("batched", [False, True])
def test_label_text_matches_jax(tmp_path, seed, batched):
    path = tmp_path / "labels.txt"
    path.write_text("".join(f"obj{i}\n" for i in range(12)))
    if batched:
        b, c, s, n = _detections(seed)
        arrays = (b, c.astype(np.float32), s, n)
    else:
        arrays = _pp_frame(seed)
    jdec, tdec = _both("mobilenet-ssd-postprocess", (1, str(path)),
                       (3, f"{W}:{H}"))
    _, plain = _both("mobilenet-ssd-postprocess", (3, f"{W}:{H}"))
    want = jdec.decode(JBuffer.of(*arrays), None)
    got = tdec.decode(Buffer.of(*arrays), None)
    box_only = plain.decode(Buffer.of(*arrays), None)
    canvas = got.tensors[0].np()
    assert canvas.tobytes() == want.tensors[0].tobytes()
    dets = got.meta["detections"]
    flat = [d for f in dets for d in f] if batched else dets
    assert flat and all(d.label == f"obj{d.class_id}" for d in flat
                        if d.class_id < 12)
    # the labels add pixels: each is the color of a detection's box, and
    # every box pixel of the box-only canvas is still there or under text
    plain_canvas = box_only.tensors[0].np()
    diff = (canvas != plain_canvas).any(-1)
    assert diff.any()
    colors = {tuple(boxutil.PALETTE[d.class_id % 6]) for d in flat}
    assert {tuple(px) for px in canvas[diff]} <= colors
    text = np.zeros(canvas.shape[:-1], bool)
    lay = canvas.reshape(-1, H, W, 4)
    for i, f in enumerate(dets if batched else [dets]):
        mask = np.zeros((H, W, 4), np.uint8)
        for d in f:
            f32 = np.float32
            x0 = min(max(int(f32(d.x) * f32(W)), 0), W - 1)
            y0 = min(max(int(f32(d.y) * f32(H)), 0), H - 1)
            from nnstreamer_tpu_torch.decoders.font import (
                draw_text,
                label_anchor,
            )
            lx, ly = label_anchor(x0, y0)
            draw_text(mask, lx, ly, d.label, (1, 1, 1, 1))
        text.reshape(-1, H, W)[i] = mask.any(-1)
    assert not (diff & ~text).any()
    assert lay.shape[0] == (3 if batched else 1)


def test_device_labels_warn_once_and_draw_boxes_only(tmp_path, caplog):
    path = tmp_path / "labels.txt"
    path.write_text("a\nb\nc\n")
    b, c, s, n = _detections(1)
    tensors = [torch.from_numpy(x) for x in (b, c, s, n)]
    dev = BoundingBoxes()
    for i, v in ((0, "mobilenet-ssd-postprocess"), (1, str(path)),
                 (3, f"{W}:{H}"), (6, "device")):
        dev.set_option(i, v)
    plain = BoundingBoxes()
    for i, v in ((0, "mobilenet-ssd-postprocess"), (3, f"{W}:{H}"),
                 (6, "device")):
        plain.set_option(i, v)
    assert not dev.wants_host_input()
    with caplog.at_level("WARNING", logger="nnstreamer_tpu_torch"):
        outs = [dev.decode(Buffer.of(*tensors), None) for _ in range(3)]
    warned = [r for r in caplog.records if "label text" in r.getMessage()]
    assert len(warned) == 1
    want = plain.decode(Buffer.of(*tensors), None).tensors[0].np()
    for o in outs:
        assert np.array_equal(o.tensors[0].np(), want)


# -- direct_video, octet_stream ---------------------------------------------------

@pytest.mark.parametrize("ch,opt", [(3, ""), (3, "BGR"), (1, ""), (4, "")])
def test_direct_video_matches_jax(ch, opt):
    x = np.random.default_rng(ch).integers(0, 256, (1, 6, 5, ch),
                                           dtype=np.uint8)
    outs = []
    for find, buf, spec in (
            (find_decoder, Buffer, TensorsSpec),
            (_jfind, JBuffer, JTensorsSpec)):
        d = find("direct_video")()
        if opt:
            d.set_option(0, opt)
        sp = spec.from_shapes([x.shape], np.uint8)
        outs.append((str(d.out_caps(sp)),
                     d.decode(buf.of(x), sp).tensors[0].np().tobytes()))
    assert outs[0] == outs[1]
    assert outs[0][1] == x.tobytes()
    with pytest.raises(ValueError):
        find_decoder("direct_video")().out_caps(
            TensorsSpec.from_shapes([(1, 6, 5, 2)], np.uint8))


def test_octet_stream_matches_jax():
    arrays = (np.arange(6, dtype=np.uint8), np.array([1.5, -2.5], np.float32),
              np.arange(4, dtype=np.int64).reshape(2, 2))
    outs = []
    for find, buf, spec in ((find_decoder, Buffer, TensorsSpec),
                            (_jfind, JBuffer, JTensorsSpec)):
        d = find("octet_stream")()
        sp = spec.from_shapes([a.shape for a in arrays],
                              [a.dtype for a in arrays])
        outs.append((str(d.out_caps(sp)),
                     d.decode(buf.of(*arrays), sp).tensors[0].np()
                     .tobytes()))
    assert outs[0] == outs[1]
    assert outs[0][1] == b"".join(a.tobytes() for a in arrays)
    assert find_decoder("octet_stream")().decode(
        Buffer.of(torch.from_numpy(arrays[1])), None).tensors[0].np() \
        .tobytes() == arrays[1].tobytes()


from nnstreamer_tpu.decoders import find_decoder as _jfind  # noqa: E402
from nnstreamer_tpu.decoders import list_decoders as _jlist  # noqa: E402
from nnstreamer_tpu_torch.decoders import list_decoders  # noqa: E402


def test_every_jax_decoder_mode_is_registered():
    assert list_decoders() == _jlist()
    assert len(list_decoders()) == 11


# -- refcompat ---------------------------------------------------------------------

from nnstreamer_tpu.decoders import refcompat as jref  # noqa: E402
from nnstreamer_tpu_torch.decoders import refcompat as tref  # noqa: E402


def _ref_key(dets):
    return [(d.x, d.y, d.width, d.height, d.class_id, d.prob) for d in dets]


@pytest.mark.parametrize("v8", [True, False])
@pytest.mark.parametrize("scaled", [True, False])
def test_refcompat_yolo_decode_matches_jax(v8, scaled):
    arr = _yolo_tensor(v8, 3 + v8, ties=True)
    arr = arr[0].T if v8 else arr[0]                   # (A, 4|5 + C)
    if not scaled:
        arr = arr.copy()
        arr[:, :4] /= SIZE_IN
    kw = dict(v8=v8, conf_threshold=0.3, iou_threshold=0.45,
              in_w=SIZE_IN, in_h=SIZE_IN, scaled_output=scaled)
    want = jref.yolo_decode(arr, **kw)
    got = tref.yolo_decode(arr, **kw)
    assert want and _ref_key(got) == _ref_key(want)
    for out_size in (SIZE_IN, 100):
        g = tref.draw_reference(got, out_size, out_size, SIZE_IN, SIZE_IN)
        w = jref.draw_reference(want, out_size, out_size, SIZE_IN, SIZE_IN)
        assert g.dtype == np.uint32 and np.array_equal(g, w)
        assert (g == tref.PIXEL_VALUE).any()
    labels = [f"c{i}" for i in range(C)]
    np.testing.assert_array_equal(
        tref.label_mask(got, labels, 80, 80, SIZE_IN, SIZE_IN, track=True),
        jref.label_mask(want, labels, 80, 80, SIZE_IN, SIZE_IN, track=True))


def test_refcompat_nms_and_iou_match_jax():
    rng = np.random.default_rng(12)
    dets = [tref.RefDetection(int(x), int(y), int(w), int(h), int(c),
                              float(p))
            for x, y, w, h, c, p in zip(
                rng.integers(0, 50, 40), rng.integers(0, 50, 40),
                rng.integers(1, 30, 40), rng.integers(1, 30, 40),
                rng.integers(0, 3, 40), rng.choice([0.5, 0.7, 0.9], 40))]
    jdets = [jref.RefDetection(d.x, d.y, d.width, d.height, d.class_id,
                               d.prob) for d in dets]
    for thr in (0.0, 0.3, 0.6):
        assert _ref_key(tref.ref_nms(dets, thr)) == \
            _ref_key(jref.ref_nms(jdets, thr))
    for a, b in zip(dets[:-1], dets[1:]):
        ja = jref.RefDetection(a.x, a.y, a.width, a.height, 0, 0)
        jb = jref.RefDetection(b.x, b.y, b.width, b.height, 0, 0)
        assert tref.ref_iou(a, b) == jref.ref_iou(ja, jb)


def test_refcompat_ssd_and_palm_decodes_match_jax(tmp_path):
    from nnstreamer_tpu_torch.models import feature_sizes_for, ssd_anchors

    priors = ssd_anchors(SIZE_IN, feature_sizes_for(SIZE_IN))
    path = tmp_path / "box_priors.txt"
    np.savetxt(path, priors.T)                       # 4 lines x A columns
    np.testing.assert_array_equal(tref.load_box_priors(str(path)),
                                  jref.load_box_priors(str(path)))
    loc, cls = _ssd_tensors(6)
    cls = cls + 3.0
    kw = dict(threshold=0.5, iou_threshold=0.5, in_w=SIZE_IN, in_h=SIZE_IN)
    want = jref.mobilenet_ssd_decode(loc, cls, priors, **kw)
    assert want
    assert _ref_key(tref.mobilenet_ssd_decode(loc, cls, priors, **kw)) == \
        _ref_key(want)
    b, c, s, n = _pp_frame(3)
    assert _ref_key(tref.ssd_pp_decode(b, c, s, int(n[0]), 300, 300)) == \
        _ref_key(jref.ssd_pp_decode(b, c, s, int(n[0]), 300, 300))
    np.testing.assert_array_equal(tref.palm_anchors(), jref.palm_anchors())
    boxes, scores = _palm_tensors(4)
    anchors = tref.palm_anchors()
    want = jref.palm_decode(boxes, scores, anchors, 0.5, 192, 192)
    assert want
    assert _ref_key(tref.palm_decode(boxes, scores, anchors, 0.5, 192,
                                     192)) == _ref_key(want)


@pytest.mark.parametrize("scheme,reduces", [
    ("mobilenet-ssd-postprocess", False), ("mobilenet-ssd", False),
    ("ov-person-detection", False), ("mp-palm-detection", False),
    ("yolov5", True), ("yolov8", True)])
def test_box_prereduce_only_for_yolo_on_a_device_tensor(scheme, reduces):
    dec = BoundingBoxes()
    dec.set_option(0, scheme)
    x = np.zeros((1, 10, 4), np.float32)
    assert dec.prereduce_active(Buffer.of(torch.from_numpy(x))) is reduces
    assert not dec.prereduce_active(Buffer.of(x))


def test_box_element_drains_a_host_scheme_in_one_copy(monkeypatch):
    """tensor_decoder drains the postprocess scheme's four tensors in one
    packed copy a buffer; the decoder reads no tensor on its own."""
    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.core import buffer as tbuf
    from nnstreamer_tpu_torch.runtime import parse_launch

    rng = np.random.default_rng(2)
    arrays = [rng.uniform(0, 1, (1, 10, 4)).astype(np.float32),
              rng.integers(0, 5, (1, 10)).astype(np.float32),
              rng.uniform(0, 1, (1, 10)).astype(np.float32),
              np.array([10], np.int32)]
    copies, single = [], []
    cpu, to_numpy = torch.Tensor.cpu, tbuf.to_numpy

    def counting(self, *a, **kw):
        copies.append(tuple(self.shape))
        return cpu(self, *a, **kw)

    def one_tensor(t):
        single.append(tuple(t.shape))
        return to_numpy(t)

    p = parse_launch("appsrc name=src ! tensor_decoder mode=bounding_boxes "
                     "option1=mobilenet-ssd-postprocess option4=64:64 "
                     "option5=64:64 ! appsink name=out", device="cpu")
    p["src"].spec = TensorsSpec.from_shapes([a.shape for a in arrays],
                                            [a.dtype for a in arrays])
    bufs = [Buffer.of(*[torch.from_numpy(a) for a in arrays])
            for _ in range(3)]
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    monkeypatch.setattr(tbuf, "to_numpy", one_tensor)
    with p:
        for b in bufs:
            p["src"].push_buffer(b)
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    monkeypatch.undo()
    assert copies == [(sum(a.nbytes for a in arrays),)] * 3
    assert single == []
    want = BoundingBoxes()
    for i, v in ((0, "mobilenet-ssd-postprocess"), (3, "64:64"),
                 (4, "64:64")):
        want.set_option(i, v)
    ref = want.decode(Buffer.of(*arrays), None).tensors[0].np()
    for _ in bufs:
        assert p["out"].pull(timeout=1).tensors[0].np().tobytes() == \
            ref.tobytes()
