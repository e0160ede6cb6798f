"""The port's SSD-MobileNetV2 against the JAX package's, on the same
weights and inputs (numpy seeds), on the CPU.

Tolerances: bit-exact for the parameter init; rtol 1e-6 for the box
decode and the IoU matrix (elementwise f32 math, at most an ulp apart);
atol 1e-4 + rtol 1e-4 for the network's f32 outputs (the two frameworks
sum the convolutions in a different order); exact equality for the NMS on
hand-built inputs, ties included.  ``register_ssd`` (raw and end to end)
through both packages' ``parse_launch`` at its bf16 compute: raw outputs
within 5e-2 of each tensor's largest magnitude, scores within 5e-2.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nnstreamer_tpu.models import mobilenet as jmob
from nnstreamer_tpu.models import ssd as jssd
from nnstreamer_tpu_torch.models import convert, mobilenet, ssd

NUM_CLASSES = 5


@functools.lru_cache(maxsize=None)
def _jax_tree(seed=0, num_classes=NUM_CLASSES):
    return jssd.ssd_mobilenet_v2_init(jax.random.PRNGKey(seed), num_classes)


@functools.lru_cache(maxsize=None)
def _port_model(seed=0, num_classes=NUM_CLASSES):
    return convert.ssd_from_jax(_jax_tree(seed, num_classes))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.detach().numpy().transpose(2, 3, 1, 0)


@pytest.mark.parametrize("seed", [0, 3])
def test_numpy_init_equals_jax_init(seed):
    want = list(_leaves(_jax_tree(seed)))
    got = list(_leaves(convert.ssd_mobilenet_v2_init(seed, NUM_CLASSES)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert np.array_equal(g, w), path
        else:
            assert g == w, path


def test_params_from_jax_round_trips():
    """JAX tree → state_dict → module → back to HWIO equals the tree."""
    tree = _jax_tree()
    model = _port_model()
    sd = model.state_dict()
    assert set(sd) == set(convert.params_from_jax(tree))
    pairs = [("backbone.stem.", tree["backbone"]["stem"])]
    for i, blk in enumerate(tree["backbone"]["blocks"]):
        pairs += [(f"backbone.blocks.{i}.{k}.", v) for k, v in blk.items()]
    pairs += [(f"extras.{i}.", p) for i, p in enumerate(tree["extras"])]
    for i, h in enumerate(tree["heads"]):
        pairs += [(f"heads.{i}.loc.", h["loc"]), (f"heads.{i}.cls.", h["cls"])]
    for prefix, p in pairs:
        assert np.array_equal(_hwio(sd[prefix + "weight"]), p["w"]), prefix
        for k in ("scale", "bias", "mean", "var"):
            assert np.array_equal(sd[prefix + k].numpy(), p[k]), prefix + k
    # depthwise: (3,3,1,C) HWIO → (C,1,3,3)
    dw = sd["backbone.blocks.1.dw.weight"]
    assert dw.shape[1] == 1 and dw.shape[2:] == (3, 3)


@pytest.mark.parametrize("size", [300, 299])
def test_same_padding_asymmetric_at_stride_2(size):
    """Trap: XLA's padding="SAME" at stride 2 pads 0 before / 1 after at
    an even size — nn.Conv2d(padding=1) would shift every window."""
    rng = np.random.default_rng(size)
    p = jmob._conv_init(rng, 3, 3, 3, 8)
    p["scale"] = rng.uniform(0.5, 2, 8).astype(np.float32)
    p["bias"] = rng.standard_normal(8).astype(np.float32)
    p["mean"] = rng.standard_normal(8).astype(np.float32)
    p["var"] = rng.uniform(0.5, 2, 8).astype(np.float32)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jmob._conv_bn(
        p, x, stride=2, dtype=jnp.float32))(x))
    conv = mobilenet.ConvBN(3, 8, 3, stride=2)
    conv.load_state_dict({
        "weight": torch.from_numpy(p["w"].transpose(3, 2, 0, 1).copy()),
        **{k: torch.from_numpy(p[k]) for k in ("scale", "bias", "mean",
                                               "var")}})
    got = conv(torch.from_numpy(x), torch.float32).detach().numpy()
    assert got.shape == want.shape == (1, 150, 150, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert mobilenet.same_padding(size, 3, 2) == \
        ((0, 1) if size % 2 == 0 else (1, 1))
    if size % 2 == 0:
        naive = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                         conv.weight, stride=2, padding=1)
        raw = F.conv2d(F.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                             (0, 1, 0, 1)), conv.weight, stride=2)
        assert not torch.allclose(naive, raw, atol=1e-3)


def test_ssd_apply_f32_matches_jax():
    x = np.random.default_rng(1).uniform(-1, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    tree = _jax_tree()
    loc_w, cls_w = jax.jit(lambda x: jssd.ssd_mobilenet_v2_apply(
        tree, x, dtype=jnp.float32))(x)
    with torch.inference_mode():
        loc, cls = _port_model()(torch.from_numpy(x), dtype=torch.float32)
    fs = ssd.feature_sizes_for(128)
    assert loc.shape == (1, ssd.ssd_anchors(128, fs).shape[0], 4)
    assert cls.shape == (1, loc.shape[1], NUM_CLASSES)
    assert loc.dtype == cls.dtype == torch.float32
    np.testing.assert_allclose(loc.numpy(), np.asarray(loc_w),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_w),
                               rtol=1e-4, atol=1e-4)


def test_head_layout_is_nhwc_before_reshape():
    """Trap: the head output must be flattened in NHWC order — cell by
    cell, 6 anchors each — to match the per-cell interleaved anchor
    table.  One input pixel at cell (row 0, col 1) feeding only the
    channel of (anchor 2, coordinate 1) must land in row 1*6+2 of loc."""
    head = ssd.SSDHead(4, 6, NUM_CLASSES)
    w = torch.zeros_like(head.loc.weight)
    w[4 * 2 + 1, 0, 1, 1] = 1.0        # centre tap, input channel 0
    head.loc.weight.data = w
    x = torch.zeros(1, 2, 2, 4)
    x[0, 0, 1, 0] = 3.0
    with torch.inference_mode():
        out = head.loc(x, torch.float32).reshape(1, -1, 4)
    assert out.shape == (1, 2 * 2 * 6, 4)
    assert int((out.abs() > 1e-6).sum()) == 1
    assert float(out[0, 1 * 6 + 2, 1]) == pytest.approx(3.0, rel=1e-3)


def test_decode_boxes_and_iou_match_jax():
    rng = np.random.default_rng(2)
    anchors = ssd.ssd_anchors(128, ssd.feature_sizes_for(128))
    loc = rng.standard_normal((2, anchors.shape[0], 4)).astype(np.float32)
    want = np.asarray(jax.jit(jssd.decode_boxes)(loc, anchors))
    got = ssd.decode_boxes(torch.from_numpy(loc), torch.from_numpy(anchors))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    boxes = want[0, :64]
    iou_w = np.asarray(jax.jit(jssd._iou_matrix)(boxes))
    iou = ssd._iou_matrix(torch.from_numpy(boxes.copy())[None])[0]
    np.testing.assert_allclose(iou.numpy(), iou_w, rtol=1e-6, atol=1e-7)


def _nms_case(dtype):
    """Hand-built NMS input with exact score ties, overlapping duplicates
    and fewer candidate pairs than max_out."""
    boxes = np.array([
        [0.1, 0.1, 0.5, 0.5], [0.1, 0.1, 0.5, 0.5],   # duplicates
        [0.12, 0.1, 0.5, 0.52], [0.6, 0.6, 0.9, 0.9],
        [0.6, 0.6, 0.9, 0.9], [0.0, 0.0, 0.2, 0.2],
        [0.3, 0.3, 0.7, 0.7]], np.float32)
    scores = np.array([
        # bg, c1,  c2,  c3
        [0.0, 2.0, 2.0, -1.0],
        [0.0, 2.0, 1.0, 0.5],
        [0.0, 1.5, 2.0, 0.5],
        [0.0, 1.0, 1.0, 1.0],
        [0.0, 1.0, 1.0, 1.0],
        [0.0, -3.0, 1.0, 2.0],
        [0.0, 0.5, 0.5, 0.5]], np.float32).astype(dtype)
    return boxes, scores


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_out", [4, 40])
def test_batched_nms_exact_on_ties(dtype, max_out):
    """Trap: lax.top_k puts the lower index first among equals, and the
    final top-k also ranks the -inf fill slots; the port must place the
    same boxes in the same slots."""
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    t_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    boxes, scores = _nms_case(np_dt)
    kw = dict(max_out=max_out, iou_thresh=0.5, score_thresh=0.25,
              pre_topk=5, fill=-np.inf)
    wb, ws, wc = jax.jit(lambda b, s: jssd.batched_nms(b, s, **kw))(
        boxes, jnp.asarray(scores))
    sc = torch.from_numpy(scores.astype(np.float32)).to(t_dt)
    gb, gs, gc = ssd.batched_nms(torch.from_numpy(boxes)[None], sc[None],
                                 **kw)
    assert gc.dtype == torch.int32
    np.testing.assert_array_equal(gb[0].numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gs[0].float().numpy(),
                                  np.asarray(ws).astype(np.float32))
    np.testing.assert_array_equal(gc[0].numpy(), np.asarray(wc))


def test_ssd_detect_apply_f32_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    anchors = ssd.ssd_anchors(64, ssd.feature_sizes_for(64))
    tree = _jax_tree()
    wb, ws, wc = jax.jit(lambda x: jssd.ssd_detect_apply(
        tree, x, anchors, max_out=7, dtype=jnp.float32))(x)
    with torch.inference_mode():
        gb, gs, gc = ssd.ssd_detect_apply(
            _port_model(), torch.from_numpy(x), torch.from_numpy(anchors),
            max_out=7, dtype=torch.float32)
    assert gb.shape == (2, 7, 4) and gs.shape == (2, 7)
    assert gc.dtype == torch.int32
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("end_to_end", [False, True])
def test_register_ssd_through_both_pipelines(end_to_end):
    """``register_ssd`` through both packages' ``parse_launch`` at the
    registration's bf16 compute: the raw ``(loc, cls)`` within 5e-2 of
    each tensor's largest magnitude (the SSD is deep, and one bf16 ulp of
    a large intermediate, summed in another order, lands on the small
    outputs whole; the f32 forward is held at 1e-4 above); end
    to end ``(boxes, scores, classes)`` with the JAX package's dtypes,
    scores within 5e-2 and the contract held (boxes ordered, scores
    descending)."""
    from nnstreamer_tpu.core import Buffer as JBuffer
    from nnstreamer_tpu.core import TensorsSpec as JTensorsSpec
    from nnstreamer_tpu.filters import jax_xla
    from nnstreamer_tpu.runtime import parse_launch as jax_parse_launch
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.filters import unregister_model
    from nnstreamer_tpu_torch.runtime import parse_launch

    name = f"torch_parity_ssd_{int(end_to_end)}"
    kw = dict(num_classes=NUM_CLASSES, batch=1, size=64, max_out=10, seed=2,
              end_to_end=end_to_end)
    jssd.register_ssd(name, **kw)
    ssd.register_ssd(name, **kw)
    desc = (f"appsrc name=src ! tensor_filter framework={{fw}} model={name} "
            "! appsink name=out")
    x = np.random.default_rng(12).uniform(-1, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    outs = []
    try:
        for parse, buf, spec, fw, extra in (
                (jax_parse_launch, JBuffer, JTensorsSpec, "jax-xla", {}),
                (parse_launch, Buffer, TensorsSpec, "torch-cuda",
                 {"device": "cpu"})):
            p = parse(desc.format(fw=fw), **extra)
            p["src"].spec = spec.from_shapes([x.shape], np.float32)
            with p:
                p["src"].push_buffer(buf.of(x))
                outs.append([np.asarray(t.np()) for t in
                             p["out"].pull(timeout=120).tensors])
                p["src"].end_of_stream()
    finally:
        jax_xla.unregister_model(name)
        unregister_model(name)
    want, got = outs
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    if not end_to_end:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=5e-2 * np.abs(w).max())
        return
    boxes, scores, classes = got
    assert (boxes[..., 2] >= boxes[..., 0]).all()
    assert (np.diff(scores, axis=-1) <= 0).all()
    np.testing.assert_allclose(scores, want[1], rtol=5e-2, atol=5e-2)
