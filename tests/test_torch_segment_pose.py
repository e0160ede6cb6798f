"""The port's ``image_segment`` and ``pose_estimation`` decoders against
the JAX package's, on the CPU.

``image_segment``: score maps with C = 21 (DeepLab's classes) and index
maps (``option1=index``, a last axis wider than 64, a rank under 3) give
the same class map, RGBA frame and caps in both packages, exactly.
``pose_estimation``: heatmaps with and without ``heatmap-offset``
offsets give keypoint dicts equal to the JAX package's within 1e-6 in x,
y and score (names exact) and the same skeleton canvas.  Ties (integer
heatmaps) resolve to the first maximum in both.

Each decoder's pre-reduction (a tensor that lives on a device; here a
CPU torch tensor) equals its host path on numpy, and the JAX package's
own device path on a JAX array.  Through ``tensor_decoder`` in a
pipeline a pre-reducing decoder makes no whole-tensor copy: only the
reduced rows cross to the host.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import TensorsSpec as JTensorsSpec
from nnstreamer_tpu.decoders import imagesegment as jseg
from nnstreamer_tpu.decoders import pose as jpose
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.decoders import imagesegment as tseg
from nnstreamer_tpu_torch.decoders import pose as tpose
from nnstreamer_tpu_torch.runtime import parse_launch


def _decoder(cls, *opts):
    d = cls()
    for i, v in enumerate(opts):
        if v:
            d.set_option(i, v)
    return d


# -- image_segment -------------------------------------------------------------

SEG_CASES = [
    ("scores (1,H,W,21)", "", lambda r: r.standard_normal(
        (1, 17, 13, 21)).astype(np.float32)),
    ("scores (H,W,21)", "tflite-deeplab", lambda r: r.standard_normal(
        (9, 11, 21)).astype(np.float32)),
    ("scores with ties", "", lambda r: r.integers(
        0, 3, (1, 8, 8, 21)).astype(np.float32)),
    ("index map", "index", lambda r: r.integers(
        0, 80, (1, 12, 10)).astype(np.int32)),
    ("index map, wide", "", lambda r: r.integers(
        0, 200, (5, 70)).astype(np.int32)),
]


@pytest.mark.parametrize("name,scheme,make", SEG_CASES,
                         ids=[c[0] for c in SEG_CASES])
def test_image_segment_matches_jax(name, scheme, make):
    x = make(np.random.default_rng(len(name)))
    j = _decoder(jseg.ImageSegment, scheme)
    t = _decoder(tseg.ImageSegment, scheme)
    jspec = JTensorsSpec.from_shapes([x.shape], x.dtype)
    tspec = TensorsSpec.from_shapes([x.shape], x.dtype)
    jc, tc = j.out_caps(jspec).first(), t.out_caps(tspec).first()
    assert (jc.get("width"), jc.get("height")) == \
        (tc.get("width"), tc.get("height"))
    jo = j.decode(JBuffer.of(x), jspec)
    to = t.decode(Buffer.of(x), tspec)
    np.testing.assert_array_equal(to.meta["segment_map"],
                                  jo.meta["segment_map"])
    assert to.meta["segment_map"].dtype == jo.meta["segment_map"].dtype
    np.testing.assert_array_equal(to.tensors[0].np(), jo.tensors[0].np())
    assert to.tensors[0].np().shape[-1] == 4


@pytest.mark.parametrize("ties", [False, True])
def test_image_segment_prereduce_equals_host_and_jax_device(ties):
    rng = np.random.default_rng(5)
    x = (rng.integers(0, 4, (1, 16, 12, 21)) if ties else
         rng.standard_normal((1, 16, 12, 21))).astype(np.float32)
    t = tseg.ImageSegment()
    dev_buf = Buffer.of(torch.from_numpy(x))
    assert t.prereduce_active(dev_buf)
    assert not t.prereduce_active(Buffer.of(x))
    dev = t.decode(dev_buf, None)
    host = t.decode(Buffer.of(x), None)
    jdev = jseg.ImageSegment().decode(JBuffer.of(jnp.asarray(x)), None)
    for ref in (host, jdev):
        np.testing.assert_array_equal(dev.meta["segment_map"],
                                      ref.meta["segment_map"])
        np.testing.assert_array_equal(dev.tensors[0].np(),
                                      ref.tensors[0].np())
    m = tseg.argmax_channel(torch.from_numpy(x))
    assert m.dtype == torch.int32 and tuple(m.shape) == (16, 12)


def test_image_segment_index_map_is_not_prereduced():
    x = np.arange(12, dtype=np.int32).reshape(1, 3, 4)
    t = _decoder(tseg.ImageSegment, "index")
    assert not t.prereduce_active(Buffer.of(torch.from_numpy(x)))
    out = t.decode(Buffer.of(torch.from_numpy(x)), None)
    np.testing.assert_array_equal(out.meta["segment_map"], x[0])


# -- pose_estimation -------------------------------------------------------------

def _pose_inputs(seed, h=9, w=9, k=17, ties=False):
    rng = np.random.default_rng(seed)
    hm = (rng.integers(0, 3, (1, h, w, k)) if ties else
          rng.standard_normal((1, h, w, k))).astype(np.float32)
    off = (rng.standard_normal((1, h, w, 2 * k)) * 8).astype(np.float32)
    return hm, off


def _kp_close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x["index"], x["name"]) == (y["index"], y["name"])
        for key in ("x", "y", "score"):
            assert abs(x[key] - y[key]) <= 1e-6, (key, x, y)


POSE_OPTS = [
    ("posenet 257, offsets", ("257:257", "257:257", "", "heatmap-offset")),
    ("no offsets", ("64:48", "192:192", "", "")),
    ("offsets, small canvas", ("33:21", "129:97", "", "heatmap-offset")),
]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name,opts", POSE_OPTS,
                         ids=[o[0] for o in POSE_OPTS])
def test_pose_matches_jax(name, opts, ties, tmp_path):
    names = tmp_path / "kp.txt"
    names.write_text("\n".join(f"kp{i}" for i in range(12)) + "\n")
    opts = (opts[0], opts[1], str(names), opts[3])
    hm, off = _pose_inputs(len(name), ties=ties)
    j = _decoder(jpose.PoseEstimation, *opts)
    t = _decoder(tpose.PoseEstimation, *opts)
    jo = j.decode(JBuffer.of(hm, off), None)
    to = t.decode(Buffer.of(hm, off), None)
    _kp_close(to.meta["keypoints"], jo.meta["keypoints"])
    np.testing.assert_array_equal(to.tensors[0].np(), jo.tensors[0].np())
    # the JAX package's own device path (its jitted pre-reduction)
    jd = j.decode(JBuffer.of(jnp.asarray(hm), jnp.asarray(off)), None)
    _kp_close(to.meta["keypoints"], jd.meta["keypoints"])


@pytest.mark.parametrize("offsets", [False, True])
def test_pose_prereduce_equals_host(offsets):
    hm, off = _pose_inputs(11, h=13, w=7, k=5)
    t = _decoder(tpose.PoseEstimation, "40:40", "97:193", "",
                 "heatmap-offset" if offsets else "")
    dev_buf = Buffer.of(torch.from_numpy(hm), torch.from_numpy(off))
    assert t.prereduce_active(dev_buf)
    rows_dev, _, _ = t._keypoint_rows(dev_buf)
    rows_host, _, _ = t._keypoint_rows(Buffer.of(hm, off))
    assert rows_dev.shape == (5, 5 if offsets else 3)
    np.testing.assert_array_equal(rows_dev, rows_host)
    assert t.decode(dev_buf, None).meta["keypoints"] == \
        t.decode(Buffer.of(hm, off), None).meta["keypoints"]
    # host offsets beside device heatmaps: no pre-reduction
    if offsets:
        assert not t.prereduce_active(
            Buffer.of(torch.from_numpy(hm), off))


def test_keypoint_rows_follow_the_flat_index_split():
    """``peak // W``, ``peak % W`` and dy = channel k, dx = channel K+k."""
    h, w, k = 5, 7, 3
    hm = np.zeros((h, w, k), np.float32)
    off = np.zeros((h, w, 2 * k), np.float32)
    for kk, (y, x) in enumerate(((4, 6), (0, 3), (2, 0))):
        hm[y, x, kk] = 1.0
        off[y, x, kk] = 10 + kk          # dy
        off[y, x, k + kk] = 20 + kk      # dx
    rows = tpose.keypoint_rows(torch.from_numpy(hm),
                               torch.from_numpy(off)).numpy()
    np.testing.assert_array_equal(rows, [[4, 6, 1, 10, 20], [0, 3, 1, 11, 21],
                                         [2, 0, 1, 12, 22]])


@pytest.mark.parametrize("mode,opts,shapes", [
    ("image_segment", "", [(1, 16, 16, 21)]),
    ("pose_estimation", "option1=64:64 option2=257:257 "
     "option4=heatmap-offset", [(1, 9, 9, 17), (1, 9, 9, 34)]),
])
def test_prereducing_decoder_copies_only_the_rows(mode, opts, shapes,
                                                  monkeypatch):
    """Through ``tensor_decoder``: one copy a buffer, of the reduced
    result, never of the whole input."""
    copied = []
    cpu = torch.Tensor.cpu

    def counting(self, *a, **kw):
        copied.append(tuple(self.shape))
        return cpu(self, *a, **kw)

    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in shapes]
    p = parse_launch(f"appsrc name=src ! tensor_decoder mode={mode} {opts} "
                     "! appsink name=out", device="cpu")
    p["src"].spec = TensorsSpec.from_shapes(shapes, np.float32)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    with p:
        for _ in range(2):
            p["src"].push_buffer(Buffer.of(*xs))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    want = (16, 16) if mode == "image_segment" else (17, 5)
    assert copied == [want, want]
