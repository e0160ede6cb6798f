"""The port's pipelines against the JAX package's, on the CPU.

1. Golden replay: the committed golden cases of the ported paths'
   elements (``transform_arithmetic``, ``transform_typecast``, the
   decoders ``boundingbox_pp``, ``image_labeling``, ``yolov8``,
   ``yolov5``, ``direct_video``, ``image_segment``, ``pose``,
   ``tensor_region``, ``octet_stream``, ``flexbuf``, ``flatbuf``,
   ``protobuf`` and ``ov_person``, then ``wire_roundtrip_protobuf``,
   ``converter_octet``, ``crop_regions`` and ``python3_converter``) run
   their own case code from ``tests/golden_cases.py`` with the port's
   ``parse_launch(device="cpu")``, ``TensorsSpec`` and ``Buffer`` in
   place of the JAX package's, and must reproduce the committed files
   byte for byte.  ``converter_flexible_to_static`` imports the JAX
   package's ``TensorFormat`` inside its case, so its pipeline is built
   here with the port's and compared with the same golden.
   ``decoder_mp_palm`` reads recorded palm-model tensors that are not in
   the tree (the JAX package cannot run its case either) and joins them
   with ``tensor_mux``: its golden canvas holds one box, so palm tensors
   whose one confident anchor decodes to that box are built here and
   pushed as one two-tensor buffer through the case's decoder options in
   both packages; both reproduce the golden byte for byte.
2. The composite detection pipeline (device_src → transform with
   ``backend=pallas`` → SSD filter with in-model decode + NMS → device
   overlay decoder) at batch 2, 64x64 input, f32 compute, through both
   packages on the same frames (``device_src frames=``) and the same
   weights.  Detections: boxes/scores within atol 1e-4 + rtol 1e-4 (the
   two frameworks sum convolutions in a different order), classes and num
   equal.  The port's renderer on the JAX detections is byte-equal to the
   JAX canvas; the two end-to-end canvases agree on at least 99.9% of
   pixels (a box edge within 1e-4 of a pixel boundary may truncate to the
   neighbouring pixel).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_cases
from nnstreamer_tpu.filters import jax_xla
from nnstreamer_tpu.models import ssd as jssd
from nnstreamer_tpu.runtime import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.decoders.boxutil import device_render
from nnstreamer_tpu_torch.filters import register_model
from nnstreamer_tpu_torch.models import convert, ssd
from nnstreamer_tpu_torch.runtime import parse_launch

BATCH, SIZE, NUM_CLASSES, MAX_OUT = 2, 64, 91, 10

COMPOSITE = (
    "device_src name=src num-buffers=2 ! "
    "tensor_transform name=norm mode=arithmetic "
    "option=typecast:float32,add:-127.5,div:127.5 backend=pallas ! "
    "tensor_filter name=net framework={fw} model=torch_parity_ssd ! "
    "tensor_decoder name=overlay mode=bounding_boxes "
    "option1=mobilenet-ssd-postprocess option4={s}:{s} option5={s}:{s} "
    "option7=device ! appsink name=out max-buffers=4")


def _golden(case):
    with open(os.path.join(golden_cases.GOLDEN_DIR, f"{case}.golden"),
              "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", ["transform_arithmetic",
                                  "transform_typecast",
                                  "decoder_boundingbox_pp",
                                  "decoder_image_labeling",
                                  "decoder_yolov8",
                                  "decoder_yolov5",
                                  "decoder_direct_video",
                                  "decoder_image_segment",
                                  "decoder_pose",
                                  "decoder_tensor_region",
                                  "decoder_octet_stream",
                                  "decoder_flexbuf",
                                  "decoder_flatbuf",
                                  "decoder_protobuf",
                                  "decoder_ov_person",
                                  "wire_roundtrip_protobuf",
                                  "converter_octet",
                                  "crop_regions",
                                  "python3_converter"])
def test_golden_replay_byte_exact(case, tmp_path, monkeypatch):
    monkeypatch.setattr(golden_cases, "parse_launch",
                        lambda desc: parse_launch(desc, device="cpu"))
    monkeypatch.setattr(golden_cases, "TensorsSpec", TensorsSpec)
    monkeypatch.setattr(golden_cases, "Buffer", Buffer)
    out = str(tmp_path / f"{case}.out")
    golden_cases.run_case(case, out)   # image_labeling: the labels file
    got = open(out, "rb").read()
    want = _golden(case)
    assert got == want, f"{case}: {len(got)}B differs from golden " \
        f"({len(want)}B)"


def test_golden_converter_flexible_to_static(tmp_path):
    """``converter_flexible_to_static`` with the port's ``TensorFormat``
    (the case itself imports the JAX package's)."""
    from nnstreamer_tpu_torch.core import TensorFormat

    out = str(tmp_path / "flex.out")
    p = parse_launch(
        "appsrc name=src ! tensor_converter input-dim=4:1 "
        f"input-type=float32 ! filesink location={out}", device="cpu")
    p["src"].spec = TensorsSpec(format=TensorFormat.FLEXIBLE)
    with p:
        p["src"].push_buffer(Buffer.of(
            np.array([[0.5, 1.5, -2.5, 4.0]], np.float32),
            format=TensorFormat.FLEXIBLE))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=120)
    assert open(out, "rb").read() == \
        _golden("converter_flexible_to_static")


@functools.lru_cache(maxsize=None)
def _weights():
    tree = jssd.ssd_mobilenet_v2_init(jax.random.PRNGKey(0), NUM_CLASSES)
    anchors = ssd.ssd_anchors(SIZE, ssd.feature_sizes_for(SIZE))
    return tree, anchors


def _register_both():
    tree, anchors = _weights()

    def jax_detect(p, x):
        boxes, scores, classes = jssd.ssd_detect_apply(
            p, x, anchors, max_out=MAX_OUT, dtype=jnp.float32)
        num = jnp.sum((scores > 0.25).astype(jnp.int32), axis=-1)
        return boxes, classes, scores, num

    def port_detect(p, x):
        boxes, scores, classes = ssd.ssd_detect_apply(
            p["model"], x, p["anchors"], max_out=MAX_OUT,
            dtype=torch.float32)
        num = (scores > 0.25).sum(dim=-1).to(torch.int32)
        return boxes, classes, scores, num

    shapes = [(BATCH, SIZE, SIZE, 3)]
    jax_xla.register_model("torch_parity_ssd", jax_detect, params=tree,
                           in_shapes=shapes, in_dtypes=np.float32)
    register_model("torch_parity_ssd", port_detect,
                   params={"model": convert.ssd_from_jax(tree),
                           "anchors": torch.from_numpy(anchors)},
                   in_shapes=shapes, in_dtypes=np.float32)


def _run(p, frames):
    p["src"].frames = frames
    with p:
        assert p.wait_eos(timeout=300)
    bufs = []
    while (b := p["out"].pull(timeout=0)) is not None:
        bufs.append(b)
    assert len(bufs) == len(frames)
    return bufs


def test_composite_pipeline_matches_jax():
    _register_both()
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
              for _ in range(2)]
    jp = jax_parse_launch(COMPOSITE.format(fw="jax-xla", s=SIZE))
    jbufs = _run(jp, frames)
    tp = parse_launch(COMPOSITE.format(fw="torch-cuda", s=SIZE),
                      device="cpu")
    tbufs = _run(tp, frames)
    assert [(s.transforms, s.filter, s.decoder)
            for s in tp.fused_segments] == [(("norm",), "net", "overlay")]
    for jb, tb in zip(jbufs, tbufs):
        jd = {k: np.asarray(v)
              for k, v in jb.meta["detections_device"].items()}
        td = {k: v.numpy() for k, v in tb.meta["detections_device"].items()}
        np.testing.assert_array_equal(td["classes"], jd["classes"])
        np.testing.assert_array_equal(td["num"], jd["num"])
        assert td["classes"].dtype == td["num"].dtype == np.int32
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(td[k], jd[k], rtol=1e-4, atol=1e-4)
        jcanvas = np.asarray(jb.tensors[0].jax())
        tcanvas = tb.tensors[0].np()
        assert tcanvas.shape == jcanvas.shape == (BATCH, SIZE, SIZE, 4)
        rendered = device_render(*(torch.from_numpy(jd[k].copy()) for k in
                                   ("boxes", "classes", "scores", "num")),
                                 SIZE, SIZE, 0.25)
        assert np.array_equal(rendered.numpy(), jcanvas)
        agree = (tcanvas == jcanvas).all(axis=-1).mean()
        assert agree >= 0.999, agree


def test_queue_thread_boundary_matches_jax():
    """appsrc ! queue ! typecast ! appsink: the queue's thread hands every
    buffer on, in order, with the same bytes as the JAX package."""
    import nnstreamer_tpu.core as jcore

    desc = ("appsrc name=src ! queue max-size-buffers=2 ! tensor_transform "
            "mode=typecast option=int16 ! appsink name=out max-buffers=16")
    xs = [np.linspace(-40.7, 40.7, 12, dtype=np.float32).reshape(3, 4) * k
          for k in range(1, 7)]
    outs = []
    for p, spec_cls, buf_cls in (
            (jax_parse_launch(desc), jcore.TensorsSpec, jcore.Buffer),
            (parse_launch(desc, device="cpu"), TensorsSpec, Buffer)):
        p["src"].spec = spec_cls.parse("4:3", "float32")
        with p:
            for i, x in enumerate(xs):
                p["src"].push_buffer(buf_cls.of(x, pts=i))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
        got = []
        while (b := p["out"].pull(timeout=0)) is not None:
            got.append((b.pts, b.tensors[0].tobytes()))
        outs.append(got)
    assert [pts for pts, _ in outs[1]] == list(range(len(xs)))
    assert outs[0] == outs[1]


def _palm_tensors_for_box(x0, y0, x1, y1, out_w=160, out_h=120, size=300):
    """(2016, 18) boxes and (2016, 1) scores whose only anchor over the
    threshold (anchor 0: centre (0.5/24, 0.5/24), unit scale) decodes to
    a box drawn at pixels x0..x1, y0..y1 of an out_w x out_h canvas."""
    x, y = (x0 + 0.5) / out_w, (y0 + 0.5) / out_h
    w, h = (x1 - x0) / out_w, (y1 - y0) / out_h
    a = 0.5 / 24
    boxes = np.zeros((2016, 18), np.float32)
    boxes[0, :4] = [(y + h / 2 - a) * size, (x + w / 2 - a) * size,
                    h * size, w * size]
    scores = np.full((2016, 1), -100.0, np.float32)
    scores[0] = 5.0
    return boxes, scores


def test_golden_decoder_mp_palm_from_its_box(tmp_path):
    want = _golden("decoder_mp_palm")
    canvas = np.frombuffer(want, np.uint8).reshape(120, 160, 4)
    ys, xs = np.nonzero(canvas[..., 3])
    arrays = _palm_tensors_for_box(xs.min(), ys.min(), xs.max(), ys.max())
    import nnstreamer_tpu.core as jcore

    desc = ("appsrc name=src ! tensor_decoder mode=bounding_boxes "
            "option1=mp-palm-detection "
            "option3=0.5:4:1.0:1.0:0.5:0.5:8:16:16:16 "
            "option4=160:120 option5=300:300 ! filesink location={}")
    for name, parse, core in (("jax", jax_parse_launch, jcore),
                              ("port", functools.partial(
                                  parse_launch, device="cpu"), None)):
        out = str(tmp_path / f"{name}.out")
        p = parse(desc.format(out))
        spec_cls = core.TensorsSpec if core else TensorsSpec
        buf_cls = core.Buffer if core else Buffer
        p["src"].spec = spec_cls.parse("18:2016,1:2016", "float32,float32")
        with p:
            p["src"].push_buffer(buf_cls.of(*arrays))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=120)
        assert open(out, "rb").read() == want, name
