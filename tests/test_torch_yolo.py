"""The port's YOLO family against the JAX package's, on the same weights
and inputs (numpy seeds), on the CPU, at width 8 with 5 classes at 64 px
(``tests/test_yolo.py``'s size).

Tolerances: bit-exact for the parameter init (``early`` is drawn after
``b0..b2``); atol 1e-4 + rtol 1e-4 for the raw f32 forward (the two
frameworks sum convolutions in another order); atol 5e-2 + rtol 5e-2 for
the bf16 forward; ``yolo_detect_apply`` at f32: classes and ``num`` equal,
boxes and scores within 1e-5.  The ``register_yolo`` pipelines (raw and
end to end) run through both packages' ``parse_launch``; and the port
versions of ``tests/test_yolo.py``'s cases, with ``appsink`` in place of
``tensor_sink``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import TensorsSpec as JTensorsSpec
from nnstreamer_tpu.filters import jax_xla
from nnstreamer_tpu.models import yolo as jyolo
from nnstreamer_tpu.runtime import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.filters import unregister_model
from nnstreamer_tpu_torch.models import convert, params_io, yolo
from nnstreamer_tpu_torch.runtime import parse_launch

SIZE, NCLS, WIDTH = 64, 5, 8


@functools.lru_cache(maxsize=None)
def _jax_tree(seed=0, depth=1):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) if hasattr(a, "shape") else a,
        jyolo.yolo_init(jax.random.PRNGKey(seed), num_classes=NCLS,
                        width=WIDTH, depth=depth))


@functools.lru_cache(maxsize=None)
def _port_model(seed=0, depth=1):
    return convert.yolo_from_jax(_jax_tree(seed, depth))


def _frame(seed=0, batch=1):
    return np.random.default_rng(seed).uniform(
        0, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("seed,depth", [(0, 1), (2, 2), (5, 3)])
def test_numpy_init_equals_jax_init(seed, depth):
    want = list(_leaves(_jax_tree(seed, depth)))
    got = list(_leaves(yolo.yolo_init(seed, num_classes=NCLS, width=WIDTH,
                                      depth=depth)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert np.array_equal(g, w), path
        else:
            assert g == w, path


def test_converter_reads_width_depth_classes_off_the_tree():
    model = _port_model(2, 2)
    assert model.num_classes == NCLS and len(model.b0.refines) == 1
    assert model.stem.weight.shape == (WIDTH, 3, 3, 3)
    assert set(model.state_dict()) == set(
        convert.yolo_params_from_jax(_jax_tree(2, 2)))


@pytest.mark.parametrize("depth", [1, 2])
def test_raw_f32_matches_jax(depth):
    x = _frame(1, batch=2)
    want = np.asarray(jyolo.yolo_raw_apply(_jax_tree(0, depth), x,
                                           dtype=jnp.float32))
    with torch.inference_mode():
        got = yolo.yolo_raw_apply(_port_model(0, depth), torch.from_numpy(x),
                                  torch.float32)
    a = sum((SIZE // s) ** 2 for s in (8, 16, 32))
    assert tuple(got.shape) == want.shape == (2, 4 + NCLS, a)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_raw_bf16_matches_jax():
    x = _frame(3)
    want = np.asarray(jyolo.yolo_raw_apply(_jax_tree(), x))
    with torch.inference_mode():
        got = yolo.yolo_raw_apply(_port_model(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("seed,depth", [(4, 1), (6, 2)])
def test_detect_f32_matches_jax(seed, depth):
    x = _frame(seed, batch=2)
    jb, jc, js, jn = (np.asarray(t) for t in jyolo.yolo_detect_apply(
        _jax_tree(0, depth), x, max_out=10, dtype=jnp.float32))
    with torch.inference_mode():
        b, c, s, n = (t.numpy() for t in yolo.yolo_detect_apply(
            _port_model(0, depth), torch.from_numpy(x), max_out=10,
            dtype=torch.float32))
    assert c.dtype == jc.dtype == np.float32 and n.dtype == np.int32
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_allclose(b, jb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-5)


def test_bf16_resident_weights_same_bits():
    tree = _jax_tree()
    m16 = convert.yolo_from_jax(params_io.weights_to_bf16(tree))
    assert m16.b1.refines is not None and m16.head0.weight.dtype == \
        torch.bfloat16 and m16.head0.scale.dtype == torch.float32
    x = torch.from_numpy(_frame(8))
    with torch.inference_mode():
        assert torch.equal(yolo.yolo_raw_apply(_port_model(), x),
                           yolo.yolo_raw_apply(m16, x))


# -- tests/test_yolo.py, on the port -------------------------------------------


class TestRawLayout:
    def test_v8_wire_shape_and_ranges(self):
        with torch.inference_mode():
            out = yolo.yolo_raw_apply(_port_model(),
                                      torch.from_numpy(_frame())).numpy()
        a = sum((SIZE // s) ** 2 for s in (8, 16, 32))
        assert out.shape == (1, 4 + NCLS, a)
        xywh, cls = out[0, :4], out[0, 4:]
        assert (cls >= 0).all() and (cls <= 1).all()
        assert (xywh[0] >= 0).all() and (xywh[0] <= SIZE).all()  # cx px
        assert (xywh[2] > 0).all()                               # w px

    def test_host_yolov8_decoder_consumes_it(self):
        with torch.inference_mode():
            out = yolo.yolo_raw_apply(_port_model(),
                                      torch.from_numpy(_frame())).numpy()
        a = out.shape[-1]
        p = parse_launch(
            "appsrc name=src ! tensor_decoder mode=bounding_boxes "
            f"option1=yolov8 option3=0.05:0.5 option4={SIZE}:{SIZE} "
            f"option5={SIZE}:{SIZE} ! appsink name=out", device="cpu")
        p["src"].spec = TensorsSpec.parse(f"{a}:{4 + NCLS}:1", "float32")
        with p:
            p["src"].push_buffer(Buffer.of(out))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
        got = p["out"].pull(timeout=0)
        assert got.tensors[0].np().shape == (SIZE, SIZE, 4)
        dets = got.meta["detections"]
        assert dets
        for d in dets:
            assert 0 <= d.class_id < NCLS and d.score >= 0.05


class TestEndToEnd:
    def test_device_head_postprocess_contract(self):
        with torch.inference_mode():
            b, c, s, n = (t.numpy() for t in yolo.yolo_detect_apply(
                _port_model(), torch.from_numpy(_frame(batch=2)),
                max_out=10))
        assert b.shape == (2, 10, 4) and c.shape == s.shape == (2, 10)
        assert n.shape == (2,)
        assert (b[..., 2] >= b[..., 0] - 1e-6).all()   # ymax >= ymin
        assert (np.diff(s, axis=-1) <= 1e-6).all()     # scores descending

    def test_full_pipeline_with_device_overlay(self):
        name = yolo.register_yolo("torch_test_yolo_e2e", batch=2,
                                  image_size=SIZE, num_classes=NCLS,
                                  max_out=8, seed=0)
        try:
            p = parse_launch(
                "appsrc name=src ! "
                f"tensor_filter framework=torch-cuda model={name} ! "
                "tensor_decoder mode=bounding_boxes "
                "option1=mobilenet-ssd-postprocess "
                f"option4={SIZE}:{SIZE} option7=device ! "
                "appsink name=out", device="cpu")
            p["src"].spec = TensorsSpec.from_shapes([(2, SIZE, SIZE, 3)],
                                                    np.float32)
            with p:
                p["src"].push_buffer(Buffer.of(_frame(batch=2)))
                p["src"].end_of_stream()
                assert p.wait_eos(timeout=120)
            got = p["out"].pull(timeout=0)
            assert got.tensors[0].np().shape == (2, SIZE, SIZE, 4)
            assert "detections_device" in got.meta
        finally:
            unregister_model(name)


# -- register_yolo through both packages' pipelines ------------------------------


def _pipeline_out(parse, buffer_cls, spec_cls, desc, x, **kw):
    p = parse(desc, **kw)
    p["src"].spec = spec_cls.from_shapes([x.shape], np.float32)
    with p:
        p["src"].push_buffer(buffer_cls.of(x))
        out = p["out"].pull(timeout=120)
        p["src"].end_of_stream()
    return out


@pytest.mark.parametrize("raw", [True, False])
def test_register_yolo_through_both_pipelines(raw):
    name = f"torch_parity_yolo_{'raw' if raw else 'e2e'}"
    kw = dict(batch=1, image_size=SIZE, num_classes=NCLS, raw=raw,
              max_out=10, seed=3, width=WIDTH, depth=2)
    jyolo.register_yolo(name, **kw)
    yolo.register_yolo(name, **kw)
    desc = (f"appsrc name=src ! tensor_filter framework={{fw}} model={name} "
            "! appsink name=out")
    x = _frame(11)
    try:
        jout = _pipeline_out(jax_parse_launch, JBuffer, JTensorsSpec,
                             desc.format(fw="jax-xla"), x)
        tout = _pipeline_out(parse_launch, Buffer, TensorsSpec,
                             desc.format(fw="torch-cuda"), x, device="cpu")
    finally:
        jax_xla.unregister_model(name)
        unregister_model(name)
    want = [np.asarray(t.np()) for t in jout.tensors]
    got = [t.np() for t in tout.tensors]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    if raw:
        np.testing.assert_allclose(got[0], want[0], rtol=5e-2, atol=5e-2)
        return
    # bf16 end to end: the contract, and the slate where both agree on it
    b, c, s, n = got
    assert (b[..., 2] >= b[..., 0]).all() and (np.diff(s) <= 0).all()
    assert int(n[0]) <= 10
    np.testing.assert_allclose(s, want[2], rtol=5e-2, atol=5e-2)
