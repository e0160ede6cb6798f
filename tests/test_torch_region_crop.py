"""The detect → tensor_region → tensor_crop cascade of the port against
the JAX package's, on the CPU.

- ``tensor_region``: the same detections through both packages' decoders
  give the same regions (top-N by score, pixel coordinates of the target
  frame, the whole frame when nothing passes the threshold), caps and
  detections; from the postprocess layout and from the raw mobilenet-ssd
  layout.  A batched layout (B > 1) is refused by both packages: the
  JAX package fails sorting per-frame lists, the port names the batch.
- ``tensor_crop`` under each sync policy (nosync, slowest, basepad,
  refresh): the same arrivals in the same order give the same crops, pts
  and pairing in both packages.  Each crop of a frame that lives on a
  device is a contiguous tensor of its own, not a view of the frame.
- The cascade at a small width (``appsrc ! tee``, one branch through the
  normalize transform, a detector and ``tensor_region`` into
  ``crop.sink_info``, the other into ``crop.sink_raw``): the crops equal
  the JAX package's byte for byte, with the frame on the host and as a
  tensor.  The detector is exact elementwise arithmetic of the frame, so
  both packages see the same boxes bit for bit.
- ``tee`` + ``donate=true``: the transform branch of a tee'd frame
  never writes into it in place, and marks it donated, so the other
  branch's later read raises ``DonatedTensorError`` in both packages and
  never sees changed bytes.
- ``tensor_region`` is a host decoder of four tensors: through
  ``tensor_decoder`` the four come to the host in one copy a buffer.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu.core as jcore
import nnstreamer_tpu_torch.core as tcore
from nnstreamer_tpu.decoders import tensorregion as jreg
from nnstreamer_tpu.elements.crop import TensorCrop as JCrop
from nnstreamer_tpu.filters import jax_xla
from nnstreamer_tpu.runtime import parse_launch as jparse
from nnstreamer_tpu_torch.decoders import tensorregion as treg
from nnstreamer_tpu_torch.elements.crop import TensorCrop as TCrop
from nnstreamer_tpu_torch.filters import register_model
from nnstreamer_tpu_torch.runtime import parse_launch as _tparse

tparse = functools.partial(_tparse, device="cpu")


def _decoder(cls, *opts):
    d = cls()
    for i, v in enumerate(opts):
        if v:
            d.set_option(i, v)
    return d


def _pp(seed, n=6, batch=None):
    rng = np.random.default_rng(seed)
    y0 = rng.uniform(-0.1, 0.8, n)
    x0 = rng.uniform(-0.1, 0.8, n)
    boxes = np.stack([y0, x0, y0 + rng.uniform(0, 0.5, n),
                      x0 + rng.uniform(0, 0.5, n)], -1).astype(np.float32)
    classes = rng.integers(0, 5, n).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[1] = scores[3]                       # a tie in the top-N sort
    num = np.array([n - 1], np.int32)
    if batch:
        return (np.stack([boxes] * batch), np.stack([classes] * batch),
                np.stack([scores] * batch), np.full((batch,), n, np.int32))
    return boxes, classes, scores, num


def _region_pair(opts, arrays):
    j = _decoder(jreg.TensorRegion, *opts)
    t = _decoder(treg.TensorRegion, *opts)
    jo = j.decode(jcore.Buffer.of(*arrays, pts=7), None)
    to = t.decode(tcore.Buffer.of(*arrays, pts=7), None)
    return jo, to


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("opts", [("1", "", ""), ("3", "", "320:240"),
                                  ("10", "", "64:48")])
def test_tensor_region_matches_jax(seed, opts, tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("a\nb\nc\n")
    opts = (opts[0], str(labels), opts[2])
    jo, to = _region_pair(opts, _pp(seed))
    np.testing.assert_array_equal(to.tensors[0].np(), jo.tensors[0].np())
    assert to.tensors[0].np().dtype == np.uint32
    assert to.format == tcore.TensorFormat.FLEXIBLE and to.pts == 7
    assert [(d.x, d.y, d.w, d.h, d.class_id, d.score)
            for d in to.meta["detections"]] == \
        [(d.x, d.y, d.w, d.h, d.class_id, d.score)
         for d in jo.meta["detections"]]
    spec = tcore.TensorsSpec.from_shapes([(6, 4)], np.float32)
    assert treg.TensorRegion().out_caps(spec).first().get("format") == \
        "flexible"


def test_tensor_region_empty_detections_give_the_whole_frame():
    boxes, classes, scores, num = _pp(4)
    scores[:] = 0.1                              # nothing passes 0.25
    jo, to = _region_pair(("2", "", "300:200"), (boxes, classes, scores,
                                                 num))
    np.testing.assert_array_equal(to.tensors[0].np(), [[0, 0, 300, 200]])
    np.testing.assert_array_equal(to.tensors[0].np(), jo.tensors[0].np())


def test_tensor_region_raw_ssd_layout_matches_jax():
    rng = np.random.default_rng(9)
    loc = rng.standard_normal((1, 40, 4)).astype(np.float32)
    cls = rng.standard_normal((1, 40, 5)).astype(np.float32)
    jo, to = _region_pair(("3", "", "96:96"), (loc, cls))
    np.testing.assert_array_equal(to.tensors[0].np(), jo.tensors[0].np())


def test_tensor_region_refuses_a_batch_in_both_packages():
    arrays = _pp(3, batch=2)
    with pytest.raises(Exception):
        jreg.TensorRegion().decode(jcore.Buffer.of(*arrays), None)
    with pytest.raises(ValueError, match="batch of 2"):
        treg.TensorRegion().decode(tcore.Buffer.of(*arrays), None)
    # a leading axis of 1 is one frame: both decode it
    one = [a[:1] for a in arrays]
    jo = jreg.TensorRegion().decode(jcore.Buffer.of(*one), None)
    to = treg.TensorRegion().decode(tcore.Buffer.of(*one), None)
    np.testing.assert_array_equal(to.tensors[0].np(), jo.tensors[0].np())


# -- tensor_crop ----------------------------------------------------------------

def _frame(i, h=12, w=10):
    return (np.arange(h * w * 3, dtype=np.int64).reshape(h, w, 3) * 7
            + i * 31).astype(np.uint8)


def _regions(i):
    return np.array([[i % 4, 1, 5, 4], [0, 0, 2, 3],
                     [8, 10, 9, 9]], np.uint32)[:1 + i % 3]


ARRIVALS = [  # (pad, index, pts): the two pads' buffers in arrival order
    ("sink_raw", 0, 0), ("sink_info", 0, 0), ("sink_raw", 1, 10),
    ("sink_raw", 2, 20), ("sink_info", 1, 15), ("sink_info", 2, 30),
    ("sink_raw", 3, 30), ("sink_raw", 4, 40), ("sink_info", 3, 45),
]


def _run_crop(cls, core, mode, option, device):
    crop = cls(name="crop", sync_mode=mode, sync_option=option)
    got = []
    crop.push = lambda buf, pad=None: got.append(buf)
    crop.start()
    pads = {p.name: p for p in crop.sinkpads}
    for pad, i, pts in ARRIVALS:
        if pad == "sink_raw":
            f = _frame(i)
            data = torch.from_numpy(f) if device else f
        else:
            data = _regions(i)
        crop.chain(pads[pad], core.Buffer.of(data, pts=pts))
    return got


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("mode,option", [("nosync", ""), ("slowest", ""),
                                         ("basepad", "0:5"),
                                         ("basepad", "1:0"),
                                         ("refresh", "")])
def test_tensor_crop_sync_policies_match_jax(mode, option, device):
    want = _run_crop(JCrop, jcore, mode, option, False)
    got = _run_crop(TCrop, tcore, mode, option, device)
    assert len(got) == len(want) and want
    for g, w in zip(got, want):
        assert g.pts == w.pts and g.format == tcore.TensorFormat.FLEXIBLE
        assert [t.np().tobytes() for t in g.tensors] == \
            [t.np().tobytes() for t in w.tensors]
        assert [t.np().shape for t in g.tensors] == \
            [t.np().shape for t in w.tensors]


def test_device_crops_are_their_own_tensors():
    frame = torch.from_numpy(_frame(1))
    crop = TCrop(name="crop")
    got = []
    crop.push = lambda buf, pad=None: got.append(buf)
    crop.start()
    pads = {p.name: p for p in crop.sinkpads}
    crop.chain(pads["sink_raw"], tcore.Buffer.of(frame))
    crop.chain(pads["sink_info"], tcore.Buffer.of(
        np.array([[0, 0, 10, 5], [2, 3, 4, 4]], np.uint32)))
    patches = [t.torch() for t in got[0].tensors]
    want = [p.clone() for p in patches]
    frame += 1                                   # a later in-place write
    for p, w in zip(patches, want):
        assert p.is_contiguous() and p._base is None
        assert p.untyped_storage().data_ptr() != \
            frame.untyped_storage().data_ptr()
        assert torch.equal(p, w)


# -- the cascade at a small width ---------------------------------------------

H, W, N = 24, 32, 4
NORM = "typecast:float32,add:-127.5,div:127.5"
CASCADE = (
    "tensor_crop name=crop ! appsink name=out max-buffers=16 "
    "appsrc name=src ! tee name=t "
    "t. ! queue ! tensor_transform mode=arithmetic option={norm} "
    "! tensor_filter framework={fw} model=region_crop_detector "
    "! tensor_decoder mode=tensor_region option1=2 option3={w}:{h} "
    "! crop.sink_info "
    "t. ! queue ! crop.sink_raw")


def _detect(x, xp):
    """Detections of a (1, H, W, 3) frame normalized to [-1, 1]: the
    pixel bytes are recovered exactly (the two packages' normalize may
    differ in the last ulp), then boxes come from pixel row 0 and scores
    from row 1 by exact arithmetic, so both see the same bits."""
    u = xp.round((x + 1) * 127.5)
    a = u[0, 0, :N, :]
    ymin = a[:, 0] / 1024
    xmin = a[:, 1] / 1024
    boxes = xp.stack([ymin, xmin, ymin + 0.375, xmin + 0.25], -1)[None]
    classes = xp.floor(a[:, 2] / 64)[None]
    scores = (u[0, 1, :N, 0] / 255)[None]
    return boxes, classes, scores


def _register_detector():
    shape = [(1, H, W, 3)]

    def jax_fn(x):
        b, c, s = _detect(x, jnp)
        return b, c, s, jnp.full((1,), N, jnp.int32)

    def port_fn(x):
        b, c, s = _detect(x, torch)
        return b, c, s, torch.full((1,), N, dtype=torch.int32)

    jax_xla.register_model("region_crop_detector", jax_fn, in_shapes=shape,
                           in_dtypes=np.float32)
    register_model("region_crop_detector", port_fn, in_shapes=shape,
                   in_dtypes=np.float32)


def _cascade_frames():
    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (5, 1, H, W, 3), dtype=np.uint8)
    frames[2, 0, 1, :N, 0] = 0                  # no detection: whole frame
    return frames


def _run_cascade(parse, core, fw, frames, as_tensor=False):
    p = parse(CASCADE.format(norm=NORM, fw=fw, w=W, h=H))
    p["src"].spec = core.TensorsSpec.from_shapes([(1, H, W, 3)], np.uint8)
    with p:
        for i, f in enumerate(frames):
            data = torch.from_numpy(f.copy()) if as_tensor else f
            p["src"].push_buffer(core.Buffer.of(data, pts=i * 10))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=120)
    out = {}
    while (b := p["out"].pull(timeout=0)) is not None:
        out[b.pts] = [(t.np().shape, t.np().tobytes()) for t in b.tensors]
    return out


@pytest.mark.parametrize("as_tensor", [False, True])
def test_cascade_matches_jax_byte_for_byte(as_tensor):
    _register_detector()
    frames = _cascade_frames()
    want = _run_cascade(jparse, jcore, "jax-xla", frames)
    got = _run_cascade(tparse, tcore, "torch-cuda", frames, as_tensor)
    assert sorted(got) == [i * 10 for i in range(len(frames))]
    assert got == want
    assert got[20] == [((1, H, W, 3), frames[2].tobytes())]
    assert all(1 <= len(v) <= 2 for v in got.values())


def test_region_decoder_copies_its_four_tensors_once(monkeypatch):
    copied = []
    cpu = torch.Tensor.cpu

    def counting(self, *a, **kw):
        copied.append(tuple(self.shape))
        return cpu(self, *a, **kw)

    arrays = [torch.from_numpy(a) for a in _pp(6)]
    p = tparse("appsrc name=src ! tensor_decoder mode=tensor_region "
               "option1=2 ! appsink name=out")
    p["src"].spec = tcore.TensorsSpec.from_shapes(
        [a.shape for a in arrays], [np.float32] * 3 + [np.int32])
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    with p:
        for _ in range(3):
            p["src"].push_buffer(tcore.Buffer.of(*arrays))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    nbytes = sum(a.numel() * a.element_size() for a in arrays)
    assert copied == [(nbytes,)] * 3


# -- tee + donate ------------------------------------------------------------------

TEE_DONATE = (
    "appsrc name=src ! tee name=t "
    "t. ! queue ! tensor_transform mode=arithmetic option=mul:2.0 "
    "donate=true ! appsink name=a "
    "t. ! queue ! appsink name=b")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_tee_with_donate_never_shows_changed_bytes(pkg):
    x = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    if pkg == "jax":
        p, core, data = jparse(TEE_DONATE), jcore, jnp.asarray(x)
        err = jcore.DonatedTensorError
    else:
        data = torch.from_numpy(x.copy())
        p, core = tparse(TEE_DONATE), tcore
        err = tcore.DonatedTensorError
    p["src"].spec = core.TensorsSpec.from_shapes([(3, 4)], np.float32)
    with p:
        p["src"].push_buffer(core.Buffer.of(data))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    a, b = p["a"].pull(timeout=1), p["b"].pull(timeout=1)
    np.testing.assert_array_equal(a.tensors[0].np(), x * 2)
    assert b.tensors[0].is_donated
    with pytest.raises(err):
        b.tensors[0].np()
    if pkg == "port":
        # the frame's memory was not written in place
        np.testing.assert_array_equal(data.numpy(), x)
