"""Tests of the port that need an NVIDIA card (marker ``cuda``).

They skip on a machine without one; on the card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

They import torch and the port only (no JAX), so they run where JAX is
not installed.  Each CUDA kernel is held against its plain PyTorch version
on the card:
- ``scale_bias_cast``: bit-exact expected, 1 ulp accepted;
- ``flash_attention``: f32 atol 1e-5 + rtol 1e-4 (the order of summation
  differs); bf16 atol 1e-2 + rtol 1e-2 (the kernel rounds p to bf16 for
  the p·v product on the tensor cores, the plain version does not); on
  contiguous inputs and on the ViT's strided qkv views alike.
MobileNetV1, the MobileNetV2 classifier and YOLO (raw and end to end) run
on the card against the CPU at f32 with TF32 off (logits and boxes within
1e-4, classes and ``num`` equal), and the yolo decoder's pre-reduce on a
CUDA tensor gives the CPU's rows.  The model lifecycle runs on the card
at small width (a hot swap and a
canary of ViT weights files, each frame against its version alone within
1e-4), and the kernel cache makes a round trip with the real ``nvcc``.
The stream elements on the card: a merge with a host branch and an
aggregator window stay on the card (no device→host copy, each window the
``torch.cat`` of its frames), ``tensor_if`` makes one scalar copy a
verdict, the ``pytorch`` filter runs on ``cuda`` (against the CPU within
atol 1e-5 + rtol 1e-4), and the sparse encoder copies only the indices
and values of a device tensor.
The observability layer on the card: the device-memory table against
``torch.cuda.memory_stats``/``mem_get_info`` read at the same scrape, the
transfer ledger's host↔device counts and bytes against torch.profiler's
copy rows over the same run, the FLOP count of a small model with both
kernels against its hand count, the tracer's records closed at the sink's
fence (each at least its window's device time, residencies summing to it),
and the kill switch leaving the pool's dispatches unsampled.
"""

import os

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inp", [torch.uint8, torch.int8, torch.uint16,
                                 torch.int16, torch.int32, torch.float16,
                                 torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 5), (1, 299, 299, 3)])
def test_scale_bias_cast_kernel_matches_plain(card, inp, out, shape):
    g = torch.Generator().manual_seed(0)
    if inp.is_floating_point:
        x = (torch.randn(shape, generator=g) * 200).to(inp)
    else:
        x = torch.randint(0, 200, shape, generator=g).to(inp)
    x = x.to(card)
    before = kernels.scale_bias_cast.launches
    y = kernels.scale_bias_cast(x, 1 / 127.5, -127.5, out)
    r = kernels.scale_bias_cast_reference(x, 1 / 127.5, -127.5, out)
    torch.cuda.synchronize()
    assert kernels.scale_bias_cast.launches == before + 1
    iv = torch.int32 if out == torch.float32 else torch.int16
    ulps = (y.view(iv).long() - r.view(iv).long()).abs().max()
    assert int(ulps) <= 1


def test_scale_bias_cast_kernel_unaligned_view(card):
    x = torch.arange(1003, dtype=torch.int32, device=card).to(torch.uint8)
    y = kernels.scale_bias_cast(x[3:], 0.5, 1.0)
    assert torch.equal(y, kernels.scale_bias_cast_reference(x[3:], 0.5, 1.0))


def test_scale_bias_cast_kernel_refuses_without_fallback(card):
    with pytest.raises(ValueError, match="float64"):
        kernels.scale_bias_cast(torch.zeros(4, dtype=torch.float64,
                                            device=card), 1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.scale_bias_cast(torch.zeros(4, 4, dtype=torch.uint8,
                                            device=card).t(), 1.0, 0.0)


def test_transform_runs_kernel_on_card(card):
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    p = parse_launch("appsrc name=src ! tensor_transform mode=arithmetic "
                     "option=typecast:float32,add:-127.5,div:127.5 "
                     "backend=cuda ! appsink name=out")
    p["src"].spec = TensorsSpec.parse("3:8:8:2", "uint8")
    x = np.arange(384, dtype=np.int64).astype(np.uint8).reshape(2, 8, 8, 3)
    before = kernels.scale_bias_cast.launches
    with p:
        p["src"].push_buffer(Buffer.of(x))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    got = p["out"].pull(timeout=1).tensors[0].torch()
    assert got.is_cuda and kernels.scale_bias_cast.launches == before + 1
    want = (torch.from_numpy(x).float() + np.float32(-127.5)) \
        * np.float32(1 / 127.5)
    assert torch.equal(got.cpu(), want)


# -- flash attention ----------------------------------------------------------

_FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _qkv(q_shape, kv_shape, dtype, card, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).to(card)
            for s in (q_shape, kv_shape, kv_shape)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,sk", [(17, 17), (100, 100), (256, 256),
                                  (130, 70), (1, 300)])
def test_flash_attention_kernel_matches_plain(card, dtype, d, s, sk):
    """Ragged query and key tiles (17, 100, 130 and 70 are no multiple
    of 64), cross attention, one query row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv((2, 3, s, d), (2, 3, sk, d), dtype, card)
    before = kernels.flash_attention.launches
    o = kernels.flash_attention(q, k, v)
    r = kernels.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape and o.is_cuda
    tol = _FA_TOL[dtype]
    torch.testing.assert_close(o.float(), r.float(), atol=tol, rtol=tol * 10
                               if dtype == torch.float32 else tol)


def test_flash_attention_scale_and_leading_dims(card):
    q, k, v = _qkv((128, 128), (512, 128), torch.float32, card, seed=1)
    o = kernels.flash_attention(q, k, v, scale=0.3)
    r = kernels.flash_attention_reference(q, k, v, scale=0.3)
    torch.testing.assert_close(o, r, atol=1e-5, rtol=1e-4)


def test_flash_attention_refuses_without_fallback(card):
    q, k, v = _qkv((1, 2, 16, 96), (1, 2, 16, 96), torch.bfloat16, card)
    before = kernels.flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        kernels.flash_attention(q, k, v)
    q, k, v = _qkv((1, 2, 16, 64), (1, 2, 16, 64), torch.float64, card)
    with pytest.raises(ValueError, match="float64"):
        kernels.flash_attention(q, k, v)
    q, k, v = _qkv((1, 2, 64, 16), (1, 2, 64, 16), torch.bfloat16, card)
    with pytest.raises(ValueError, match="stride 1"):
        kernels.flash_attention(q.transpose(-1, -2), k.transpose(-1, -2),
                                v.transpose(-1, -2))
    q, k, v = _qkv((1, 2, 16, 68), (1, 2, 16, 68), torch.bfloat16, card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.flash_attention(q[..., 1:65], k[..., :64], v[..., :64])
    with pytest.raises(ValueError, match="multiple of 16"):
        kernels.flash_attention(q[..., :64], k[..., :64], v[..., :64])
    assert kernels.flash_attention.launches == before


def _qkv_views(B, s, sk, H, d, dtype, card, seed=3):
    """q from the first third of a (B, s, 3·H·d) projection, k and v the
    second and third thirds of a (B, sk, 3·H·d) one, split into heads as
    the ViT does: (B, H, S, d) views with strides (S·3Hd, d, 3Hd, 1)."""
    g = torch.Generator().manual_seed(seed)
    D = H * d

    def heads(t, n):
        return t.reshape(B, n, H, d).transpose(1, 2)

    pq = torch.randn(B, s, 3 * D, generator=g).to(dtype).to(card)
    pkv = torch.randn(B, sk, 3 * D, generator=g).to(dtype).to(card)
    return (heads(pq[..., :D], s), heads(pkv[..., D:2 * D], sk),
            heads(pkv[..., 2 * D:], sk))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,sk", [(17, 17), (256, 256), (130, 70), (1, 300)])
def test_flash_attention_kernel_on_qkv_views(card, dtype, d, s, sk):
    """The ViT's layout: q, k, v read by stride out of the qkv projection,
    o written (B, S, H, d), at the same tolerances as contiguous inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv_views(2, s, sk, 4, d, dtype, card)
    if s > 1:  # a one-row view counts as contiguous
        assert not q.is_contiguous() and q.stride(-2) == 3 * 4 * d
    before = kernels.flash_attention.launches
    o = kernels.flash_attention(q, k, v)
    r = kernels.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches == before + 1
    assert o.shape == q.shape and o.dtype == dtype
    assert o.transpose(1, 2).is_contiguous()
    tol = _FA_TOL[dtype]
    torch.testing.assert_close(o.float(), r.float(), atol=tol, rtol=tol * 10
                               if dtype == torch.float32 else tol)


def test_vit_on_card_matches_cpu(card):
    """The tiny ViT at f32 (TF32 off): the card, through the kernels,
    against the CPU's plain versions."""
    from nnstreamer_tpu_torch.models import vit_apply, vit_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = vit_init(0, image_size=32, patch=8, dim=256, depth=2, heads=2,
                     mlp_dim=128, num_classes=5)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    before = kernels.flash_attention.launches
    with torch.inference_mode():
        want = vit_apply(model, x, torch.float32)
        got = vit_apply(model.to(card), x.to(card), torch.float32)
    assert kernels.flash_attention.launches == before + 2   # one per block
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("family", ["v1", "v2"])
def test_mobilenet_on_card_matches_cpu(card, family):
    from nnstreamer_tpu_torch.models import (
        mobilenet_v1_apply,
        mobilenet_v1_from_jax,
        mobilenet_v1_init,
        mobilenet_v2_apply,
        mobilenet_v2_from_jax,
        mobilenet_v2_init,
    )

    _tf32_off()
    init, from_jax, apply = (
        (mobilenet_v1_init, mobilenet_v1_from_jax, mobilenet_v1_apply)
        if family == "v1" else
        (mobilenet_v2_init, mobilenet_v2_from_jax, mobilenet_v2_apply))
    model = from_jax(init(0, 10, 0.25))
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want = apply(model, x, torch.float32)
        got = apply(model.to(card), x.to(card), torch.float32)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("raw", [True, False])
def test_yolo_on_card_matches_cpu(card, raw):
    from nnstreamer_tpu_torch.models import (
        yolo_detect_apply,
        yolo_from_jax,
        yolo_init,
        yolo_raw_apply,
    )

    _tf32_off()
    model = yolo_from_jax(yolo_init(0, num_classes=5, width=8, depth=2))
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        if raw:
            want = yolo_raw_apply(model, x, torch.float32)
            got = yolo_raw_apply(model.to(card), x.to(card), torch.float32)
            torch.testing.assert_close(got.cpu(), want, atol=1e-4,
                                       rtol=1e-4)
            return
        want = yolo_detect_apply(model, x, max_out=10, dtype=torch.float32)
        got = [t.cpu() for t in yolo_detect_apply(
            model.to(card), x.to(card), max_out=10, dtype=torch.float32)]
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=0)


@pytest.mark.parametrize("v8", [True, False])
def test_yolo_prereduce_on_card_matches_cpu(card, v8):
    from nnstreamer_tpu_torch.decoders.boundingbox import yolo_prereduce

    g = torch.Generator().manual_seed(6)
    shape = (1, 4 + 6, 8400) if v8 else (1, 8400, 5 + 6)
    x = torch.rand(shape, generator=g)
    x[..., :3] = 0.75                  # ties: the lower index first
    got = yolo_prereduce(x.to(card), v8)
    assert got.device.type == "cuda" and tuple(got.shape) == (512, 6)
    assert torch.equal(got.cpu(), yolo_prereduce(x, v8))


# -- shared-model serving and the transform modes on the card -----------------

_TRANSFORM_MODES = [
    ("transpose", "1:0:2:3", "float32"), ("dimchg", "0:2", "uint8"),
    ("stand", "default", "float32"), ("stand", "dc-average:per-channel",
                                      "float32"),
    ("clamp", "-0.5:0.5", "float32"), ("padding", "1:2,2:0,value:0.5",
                                       "float32"),
    ("typecast", "int16", "float32"),
    ("arithmetic", "per-channel-mul:1;2;3,add:0.5", "float32"),
]


@pytest.mark.parametrize("mode,option,types", _TRANSFORM_MODES)
def test_transform_mode_card_matches_cpu(card, mode, option, types):
    """Every mode on the card against the CPU, byte for byte; ``stand``
    within 1 f32 ulp (its float64 reductions sum in another order on the
    card)."""
    from nnstreamer_tpu_torch.core import DType, TensorSpec
    from nnstreamer_tpu_torch.elements.transform import _OpChain

    shape = (4, 16, 16, 3)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=g) * 50
    if types == "uint8":
        x = x.abs().to(torch.uint8)
    spec = TensorSpec.from_shape(shape, DType.from_string(types))
    for lead, chain_in in ((0, x), (1, x.reshape((2, 2) + shape[1:]))):
        fspec = spec if lead == 0 else TensorSpec.from_shape(
            chain_in.shape[1:], spec.dtype)
        fn = _OpChain(mode, option).fn_for(fspec, lead)
        want = fn(chain_in)
        got = fn(chain_in.to(card)).cpu()
        assert got.dtype == want.dtype and got.shape == want.shape
        if mode == "stand":
            ulps = (got.view(torch.int32).long()
                    - want.view(torch.int32).long()).abs().max()
            assert int(ulps) <= 1
        else:
            assert torch.equal(got, want)


def _pooled_vit(card, n_streams, n, batch, share):
    """``n_streams`` pipelines of uint8 (1,32,32,3) frames → transform
    (backend=cuda) → a tiny bf16 ViT, ``share-model`` as asked; returns
    the per-stream logits."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.runtime import parse_launch

    register_vit("cuda_pooled_vit", batch=1, image_size=32, patch=8,
                 dim=256, depth=2, heads=2, mlp_dim=128, num_classes=5,
                 seed=4)
    desc = ("appsrc name=src ! queue ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 backend=cuda ! "
            "tensor_filter name=net framework=torch-cuda "
            f"model=cuda_pooled_vit share-model={str(share).lower()} "
            f"batch={batch} batch-timeout-ms=50 ! appsink name=out "
            "max-buffers=64")
    pipes = [parse_launch(desc) for _ in range(n_streams)]
    g = torch.Generator().manual_seed(6)
    frames = [[torch.randint(0, 256, (1, 32, 32, 3), generator=g,
                             dtype=torch.uint8).to(card) for _ in range(n)]
              for _ in range(n_streams)]
    for p in pipes:
        p["src"].spec = TensorsSpec.parse("3:32:32:1", "uint8")
        p.start()
    try:
        for s, p in enumerate(pipes):
            for i, x in enumerate(frames[s]):
                p["src"].push_buffer(Buffer.of(x, pts=i))
            p["src"].end_of_stream()
        out = []
        for p in pipes:
            assert p.wait_eos(timeout=120)
            bufs = [p["out"].pull(timeout=5) for _ in range(n)]
            assert [b.pts for b in bufs] == list(range(n))
            out.append([b.tensors[0].torch().cpu() for b in bufs])
    finally:
        for p in pipes:
            p.stop()
    return out


#: pooled logits against the same frame alone: the rows of a window are
#: computed as they are alone, up to the order of a few f32 sums
POOLED_TOL = 1e-4


def test_pooled_window_matches_per_frame_runs(card):
    """Two streams on one shared, micro-batched ViT: every frame's
    logits within 1e-4 of the same frame run alone (batch 1), while any
    two different frames' logits lie further apart than that — so a
    frame swapped between streams, or a wrong split of the window, would
    fail."""
    pooled = _pooled_vit(card, 2, 6, batch=4, share=True)
    alone = _pooled_vit(card, 2, 6, batch=1, share=False)
    for s in range(2):
        for i in range(6):
            torch.testing.assert_close(pooled[s][i], alone[s][i],
                                       atol=POOLED_TOL, rtol=POOLED_TOL)
    flat = torch.stack([y.reshape(-1) for ys in alone for y in ys])
    apart = (flat[:, None] - flat[None]).abs().amax(-1)
    apart.fill_diagonal_(float("inf"))
    assert float(apart.min()) > 2 * POOLED_TOL


def test_batched_window_of_cuda_tensors_never_takes_a_plain_version(
        card, monkeypatch):
    """The window path on CUDA tensors launches the kernels: with the
    plain versions made to raise it still runs, and the launch counts
    show one flash_attention per block per window."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card's path")

    monkeypatch.setattr(kernels, "flash_attention_reference", refuse)
    monkeypatch.setattr(kernels, "scale_bias_cast_reference", refuse)
    fa, sbc = kernels.flash_attention.launches, kernels.scale_bias_cast.launches
    out = _pooled_vit(card, 2, 4, batch=4, share=True)
    assert all(bool(torch.isfinite(y).all()) for s in out for y in s)
    assert kernels.scale_bias_cast.launches - sbc == 8  # one a frame
    # 2 blocks x (1..8 windows + the forward on zeros at negotiation +
    # up to two lone forwards a window while the fold verdict is open)
    launches = kernels.flash_attention.launches - fa
    assert launches % 2 == 0 and 2 * 2 <= launches <= 2 * 25


# -- model lifecycle and the kernel cache on the card -------------------------

_CARD_VIT = dict(image_size=32, patch=8, dim=256, depth=2, mlp_dim=128,
                 num_classes=5)


def _vit_files(tmp_path):
    """Two bf16 ViT weights files (seeds 0 and 1) in the JAX layout."""
    import json

    from nnstreamer_tpu_torch.models import params_io, vit_tree

    paths = []
    for seed in (0, 1):
        path = str(tmp_path / f"vit_v{seed}.safetensors")
        params_io.save_safetensors(path, vit_tree(seed, **_CARD_VIT), {
            "apply": "nnstreamer_tpu_torch.models.vit:vit_tree_apply",
            "apply_kwargs": json.dumps({"heads": 2}),
            "in_shapes": "[[1, 32, 32, 3]]", "in_dtypes": "float32"})
        paths.append(path)
    return paths


def _lifecycle_rig(card, tmp_path, n_streams, canary=""):
    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    paths = _vit_files(tmp_path)
    desc = ("appsrc name=src ! queue ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 backend=cuda ! "
            f"tensor_filter name=net framework=torch-cuda "
            f"model=file://{paths[0]}@v0 share-model=true batch=4 "
            f"batch-timeout-ms=50 batch-buckets=2,4 is-updatable=true"
            f"{' canary=' + canary if canary else ''} ! appsink name=out "
            "max-buffers=64")
    pipes = [parse_launch(desc) for _ in range(n_streams)]
    for p in pipes:
        p["src"].spec = TensorsSpec.parse("3:32:32:1", "uint8")
        p.start()
    g = torch.Generator().manual_seed(7)
    frames = [[torch.randint(0, 256, (1, 32, 32, 3), generator=g,
                             dtype=torch.uint8).to(card) for _ in range(4)]
              for _ in range(n_streams)]
    return paths, pipes, frames


def _serve(pipes, frames, first_pts):
    from nnstreamer_tpu_torch.core import Buffer

    for s, p in enumerate(pipes):
        for i, x in enumerate(frames[s]):
            p["src"].push_buffer(Buffer.of(x, pts=first_pts + i))
    out = []
    for s, p in enumerate(pipes):
        bufs = [p["out"].pull(timeout=60) for _ in frames[s]]
        assert [b.pts for b in bufs] == \
            list(range(first_pts, first_pts + len(frames[s])))
        out.append([b.tensors[0].torch() for b in bufs])
    return out


def _alone(card, path, frames):
    """Each frame through a lone instance of ``path``'s model."""
    from nnstreamer_tpu_torch.core import DType, TensorSpec
    from nnstreamer_tpu_torch.elements.transform import _OpChain
    from nnstreamer_tpu_torch.filters import TorchCudaFilter
    from nnstreamer_tpu_torch.filters.api import FilterProps

    norm = _OpChain("arithmetic", "typecast:float32,add:-127.5,div:127.5",
                    backend="cuda").fn_for(
        TensorSpec.from_shape((1, 32, 32, 3), DType.UINT8))
    sp = TorchCudaFilter()
    sp.configure(FilterProps(framework="torch-cuda", model=path,
                             device=card))
    try:
        return [[sp.invoke([norm(x)])[0] for x in fs] for fs in frames]
    finally:
        sp.close()


def test_hot_swap_on_card_matches_each_version_alone(card, tmp_path):
    """RELOAD_MODEL on a pooled small ViT loaded from a weights file:
    frames before the swap match v0 alone, frames after match v1 alone
    (within the pooled 1e-4), and the two versions' logits differ."""
    from nnstreamer_tpu_torch.runtime.events import Event

    paths, pipes, frames = _lifecycle_rig(card, tmp_path, 2)
    try:
        before = _serve(pipes, frames, 0)
        pipes[0]["net"].handle_event(None, Event.reload_model(
            f"file://{paths[1]}@v1"))
        lc = pipes[0]["net"].pool.lifecycle
        assert lc.swaps == 1 and lc.baseline.tag == "v1"
        assert lc.last_swap_stall_s < 2e-3
        after = _serve(pipes, frames, 100)
    finally:
        for p in pipes:
            p.stop()
    for served, path in ((before, paths[0]), (after, paths[1])):
        alone = _alone(card, path, frames)
        for s in range(2):
            for y, r in zip(served[s], alone[s]):
                torch.testing.assert_close(y, r, atol=POOLED_TOL,
                                           rtol=POOLED_TOL)
    assert float((before[0][0] - after[0][0]).abs().max()) > 2 * POOLED_TOL


def test_canary_on_card_routes_one_in_n_streams(card, tmp_path):
    """``canary=next:1/2`` on 4 streams: streams 1 and 3 read v1 alone's
    logits, 0 and 2 read v0's; rollback returns them all to v0."""
    paths, pipes, frames = _lifecycle_rig(card, tmp_path, 4,
                                          canary="next:1/2")
    try:
        entry = pipes[0]["net"].pool
        assert entry.reload_model(f"file://{paths[1]}@v1")["streams"] == 2
        served = _serve(pipes, frames, 0)
        entry.lifecycle.rollback()
        rolled = _serve(pipes, frames, 100)
    finally:
        for p in pipes:
            p.stop()
    alone = {v: _alone(card, paths[v], frames) for v in (0, 1)}
    for s in range(4):
        for i in range(4):
            torch.testing.assert_close(served[s][i], alone[s % 2][s][i],
                                       atol=POOLED_TOL, rtol=POOLED_TOL)
            torch.testing.assert_close(rolled[s][i], alone[0][s][i],
                                       atol=POOLED_TOL, rtol=POOLED_TOL)


def test_kernel_cache_round_trip_with_nvcc(card, tmp_path, monkeypatch):
    """``NNS_TPU_TORCH_COMPILE_CACHE_DIR`` with the real compiler: a cold
    process builds and stores, a warm one hits and runs no nvcc, a
    truncated entry is an error and is rebuilt; the library works."""
    from nnstreamer_tpu_torch.ops import build
    from nnstreamer_tpu_torch.runtime import compilecache

    monkeypatch.setenv(compilecache.CACHE_ENV, str(tmp_path))

    def fresh():
        monkeypatch.setattr(build, "_loaded", {})
        monkeypatch.setattr(build, "_nvcc_versions", {})
        monkeypatch.setattr(build, "nvcc_runs", 0)
        compilecache.CACHE_STATS.reset()

    fresh()
    lib = build.build_all(["scale_bias_cast"])["scale_bias_cast"]
    assert compilecache.CACHE_STATS.snapshot() == {
        "hits": 0, "misses": 1, "stores": 1, "errors": 0}
    fresh()
    build.build_all(["scale_bias_cast"])
    assert compilecache.CACHE_STATS.snapshot()["hits"] == 1
    assert build.nvcc_runs == 0
    # truncated, as a torn copy lands: a new file at the entry's path
    # (this process keeps its mapping of the intact one)
    torn = lib.with_suffix(".torn")
    torn.write_bytes(lib.read_bytes()[:4096])
    os.replace(torn, lib)
    fresh()
    build.build_all(["scale_bias_cast"])
    assert compilecache.CACHE_STATS.snapshot() == {
        "hits": 0, "misses": 1, "stores": 1, "errors": 1}
    x = torch.arange(64, dtype=torch.uint8, device=card)
    torch.testing.assert_close(
        kernels.scale_bias_cast(x, 0.5, 1.0),
        kernels.scale_bias_cast_reference(x, 0.5, 1.0), atol=0, rtol=0)
    compilecache.CACHE_STATS.reset()


# -- decoders and the detect → region → crop cascade ------------------------

def test_image_segment_prereduce_on_card_matches_cpu(card):
    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.decoders.imagesegment import ImageSegment

    x = torch.randn(1, 257, 257, 21, generator=torch.Generator()
                    .manual_seed(3))
    dec = ImageSegment()
    got = dec.decode(Buffer.of(x.to(card)), None)
    want = dec.decode(Buffer.of(x.numpy()), None)
    np.testing.assert_array_equal(got.meta["segment_map"],
                                  want.meta["segment_map"])
    np.testing.assert_array_equal(got.tensors[0].np(), want.tensors[0].np())


@pytest.mark.parametrize("offsets", [False, True])
def test_pose_prereduce_on_card_matches_cpu(card, offsets):
    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.decoders.pose import PoseEstimation

    g = torch.Generator().manual_seed(4)
    hm = torch.randn(1, 9, 9, 17, generator=g)
    off = torch.randn(1, 9, 9, 34, generator=g) * 8
    dec = PoseEstimation()
    for i, v in enumerate(("257:257", "257:257", "",
                           "heatmap-offset" if offsets else "")):
        if v:
            dec.set_option(i, v)
    got = dec.decode(Buffer.of(hm.to(card), off.to(card)), None)
    want = dec.decode(Buffer.of(hm.numpy(), off.numpy()), None)
    assert got.meta["keypoints"] == want.meta["keypoints"]
    np.testing.assert_array_equal(got.tensors[0].np(), want.tensors[0].np())


def test_host_decoder_makes_one_copy_a_buffer_on_card(card, monkeypatch):
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    rng = np.random.default_rng(1)
    arrays = [rng.uniform(0, 1, (1, 10, 4)).astype(np.float32),
              rng.integers(0, 5, (1, 10)).astype(np.float32),
              rng.uniform(0, 1, (1, 10)).astype(np.float32),
              np.array([10], np.int32)]
    copies = []
    cpu = torch.Tensor.cpu

    def counting(self, *a, **kw):
        if self.is_cuda:
            copies.append(tuple(self.shape))
        return cpu(self, *a, **kw)

    p = parse_launch("appsrc name=src ! tensor_decoder mode=tensor_region "
                     "option1=4 option3=300:300 ! appsink name=out")
    p["src"].spec = TensorsSpec.from_shapes([a.shape for a in arrays],
                                            [a.dtype for a in arrays])
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    with p:
        for _ in range(3):
            p["src"].push_buffer(Buffer.of(*[torch.from_numpy(a).to(card)
                                             for a in arrays]))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    assert copies == [(sum(a.nbytes for a in arrays),)] * 3


def test_cascade_crops_on_card_equal_cpu(card):
    """appsrc ! tee, a detector and tensor_region into crop.sink_info,
    the frame into crop.sink_raw: the card's crops (cut on the card) are
    byte-equal to the CPU run's."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.runtime import parse_launch

    h, w, n = 48, 64, 4

    def detect(x):
        u = torch.round((x + 1) * 127.5)
        a = u[0, 0, :n, :]
        boxes = torch.stack([a[:, 0] / 1024, a[:, 1] / 1024,
                             a[:, 0] / 1024 + 0.375,
                             a[:, 1] / 1024 + 0.25], -1)[None]
        return (boxes, torch.floor(a[:, 2] / 64)[None],
                (u[0, 1, :n, 0] / 255)[None],
                torch.full((1,), n, dtype=torch.int32, device=x.device))

    register_model("card_cascade_detector", detect, in_shapes=[(1, h, w, 3)],
                   in_dtypes=np.float32)
    desc = ("tensor_crop name=crop ! appsink name=out max-buffers=16 "
            "appsrc name=src ! tee name=t "
            "t. ! queue ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 backend=cuda "
            "! tensor_filter framework=torch-cuda model=card_cascade_detector "
            f"! tensor_decoder mode=tensor_region option1=2 option3={w}:{h} "
            "! crop.sink_info t. ! queue ! crop.sink_raw")
    frames = np.random.default_rng(5).integers(0, 256, (4, 1, h, w, 3),
                                               dtype=np.uint8)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = parse_launch(desc, device=dev)
        p["src"].spec = TensorsSpec.from_shapes([(1, h, w, 3)], np.uint8)
        with p:
            for i, f in enumerate(frames):
                p["src"].push_buffer(Buffer.of(
                    torch.from_numpy(f).to(dev), pts=i))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=120)
        got = []
        while (b := p["out"].pull(timeout=0)) is not None:
            if dev == "cuda":
                assert all(t.torch().is_cuda for t in b.tensors)
            got.append((b.pts, [t.np().tobytes() for t in b.tensors]))
        outs[dev] = got
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 4


# -- stream elements and the pytorch filter on the card --------------------------

def _count_card_copies(monkeypatch):
    """Record the shape of every device→host ``Tensor.cpu``/``.item``."""
    copies = []
    cpu, item = torch.Tensor.cpu, torch.Tensor.item

    def counting_cpu(self, *a, **kw):
        if self.is_cuda:
            copies.append(("cpu", tuple(self.shape)))
        return cpu(self, *a, **kw)

    def counting_item(self):
        if self.is_cuda:
            copies.append(("item", tuple(self.shape)))
        return item(self)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "item", counting_item)
    return copies


def _pull_all(sink):
    out = []
    while (b := sink.pull(timeout=0)) is not None:
        out.append(b)
    return out


def test_aggregator_and_merge_stay_on_card(card, monkeypatch):
    """A window of camera frames is one torch.cat on the card, and a merge
    with a host branch concatenates on the card: no device→host copy."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    frames = [torch.randint(0, 256, (1, 8, 8, 3), dtype=torch.uint8,
                            device=card) for _ in range(6)]
    p = parse_launch(
        "tensor_merge name=m mode=linear option=3 ! tensor_aggregator "
        "frames-in=2 frames-out=4 frames-flush=4 frames-dim=3 ! "
        "appsink name=out appsrc name=a ! m.sink_0 appsrc name=b ! m.sink_1")
    for s in ("a", "b"):
        p[s].spec = TensorsSpec.parse("3:8:8:1", "uint8")
    copies = _count_card_copies(monkeypatch)
    host = [np.full((1, 8, 8, 3), i, np.uint8) for i in range(6)]
    with p:
        for i in range(6):
            p["a"].push_buffer(Buffer.of(frames[i], pts=i))
            p["b"].push_buffer(Buffer.of(host[i], pts=i))
        p["a"].end_of_stream()
        p["b"].end_of_stream()
        assert p.wait_eos(timeout=60)
    out = _pull_all(p["out"])
    assert copies == []
    monkeypatch.undo()
    assert len(out) == 3
    for w, b in enumerate(out):
        x = b.tensors[0].torch()
        assert x.is_cuda and tuple(x.shape) == (4, 8, 8, 3)
        want = torch.cat([torch.cat([frames[j], torch.from_numpy(host[j])
                                     .to(card)]) for j in (2 * w, 2 * w + 1)])
        assert torch.equal(x, want)


def test_tensor_if_one_scalar_copy_on_card(card, monkeypatch):
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    p = parse_launch(
        "appsrc name=src ! tensor_if name=i compared-value=ALL_TENSORS_TOTAL "
        "operator=ge supplied-value=10 then=PASSTHROUGH else=FILL_ZERO "
        "i.src_then ! appsink name=t i.src_else ! appsink name=e")
    p["src"].spec = TensorsSpec.parse("4,2", "int32,float32")
    copies = _count_card_copies(monkeypatch)
    with p:
        for v in (1, 5, 0, 9):
            p["src"].push_buffer(Buffer.of(
                torch.full((4,), v, dtype=torch.int32, device=card),
                torch.full((2,), 0.5, device=card), pts=v))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    then, other = _pull_all(p["t"]), _pull_all(p["e"])
    assert copies == [("item", ())] * 4 and p["i"].verdict_copies == 4
    monkeypatch.undo()
    assert [b.pts for b in then] == [5, 9] and [b.pts for b in other] == [1, 0]
    z = other[0].tensors[0].torch()
    assert z.is_cuda and z.dtype == torch.int32 and int(z.abs().sum()) == 0


def test_pytorch_filter_runs_on_card(card, tmp_path):
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                            torch.nn.Linear(16, 4))
    path = str(tmp_path / "mlp.pt")
    torch.jit.script(m).save(path)
    x = torch.randn(2, 8)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = parse_launch(f"appsrc name=src ! tensor_filter "
                         f"framework=pytorch model={path} input=8:2 "
                         "inputtype=float32 ! appsink name=out", device=dev)
        p["src"].spec = TensorsSpec.parse("8:2", "float32")
        with p:
            p["src"].push_buffer(Buffer.of(x.to(dev)))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
        y = p["out"].pull(timeout=1).tensors[0].torch()
        assert y.device.type == dev
        outs[dev] = y.cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8, torch.int64])
def test_sparse_encoder_copies_only_indices_and_values(card, monkeypatch,
                                                       dtype):
    from nnstreamer_tpu_torch.core import Tensor
    from nnstreamer_tpu_torch.core.buffer import (
        sparse_from_dense,
        sparse_to_dense,
    )

    x = torch.zeros(64, 32, dtype=dtype, device=card)
    x[3, 4], x[10, 0], x[63, 31] = 7, 2, 1
    want = sparse_from_dense(Tensor(x.cpu()))
    copies = _count_card_copies(monkeypatch)
    got = sparse_from_dense(Tensor(x))
    assert copies == [("cpu", (3 * (4 + x.element_size()),))]
    monkeypatch.undo()
    assert got == want
    assert sparse_to_dense(got).tobytes() == Tensor(x).tobytes()


# -- the observability layer on the card -------------------------------------


def test_device_memory_table_equals_memory_stats(card):
    from nnstreamer_tpu_torch.obs import devicemem

    x = torch.empty(64 << 20, dtype=torch.uint8, device=card)
    torch.cuda.synchronize()
    (row,) = [r for r in devicemem.device_memory_table()
              if r["device"] == str(torch.device("cuda", 0))]
    stats = torch.cuda.memory_stats(card)
    assert row["in_use"] == stats["allocated_bytes.all.current"]
    assert row["peak"] == stats["allocated_bytes.all.peak"]
    assert row["reserved"] == stats["reserved_bytes.all.current"]
    assert row["limit"] == torch.cuda.mem_get_info(card)[1]
    assert row["in_use"] >= x.numel()
    del x


def _profiled_copies(fn, tmp_path):
    """(result, {"HtoD": (count, bytes), "DtoH": (count, bytes)}) of the
    memcpy rows torch.profiler's trace shows for ``fn()``."""
    import json

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    rows = {"HtoD": [0, 0], "DtoH": [0, 0]}
    for e in json.load(open(path))["traceEvents"]:
        if e.get("cat") != "gpu_memcpy":
            continue
        for kind in rows:
            if kind in e["name"]:
                rows[kind][0] += 1
                rows[kind][1] += int(e["args"]["bytes"])
    return out, {k: tuple(v) for k, v in rows.items()}


def test_ledger_equals_profiler_copies(card, tmp_path):
    """Host frames uploaded at the filter, one (index, score) pair drained
    a frame by image_labeling: the ledger's counts and bytes are the
    profiler's copy rows."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.runtime import parse_launch

    register_model("cuda_obs_lin", lambda x: x * 2.0 + 1.0,
                   in_shapes=[(1, 16)], in_dtypes=np.float32)
    frames = [np.random.default_rng(i).standard_normal((1, 16))
              .astype(np.float32) for i in range(8)]

    def run():
        p = parse_launch("appsrc name=src ! tensor_filter "
                         "framework=torch-cuda model=cuda_obs_lin ! "
                         "tensor_decoder mode=image_labeling ! "
                         "appsink name=out")
        p["src"].spec = TensorsSpec.parse("16:1", "float32")
        with p:
            for i, f in enumerate(frames):
                p["src"].push_buffer(Buffer.of(f, pts=i))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
        return p

    run()  # the first run warms the card's libraries up
    xfer.LEDGER.clear()
    p, rows = _profiled_copies(run, tmp_path)
    assert xfer.LEDGER.totals(direction="h2d") == rows["HtoD"] == (8, 8 * 64)
    assert xfer.LEDGER.totals(direction="d2h") == rows["DtoH"] == (8, 8 * 8)
    got = [p["out"].pull(timeout=1).meta["label_index"] for _ in range(8)]
    assert got == [int(np.argmax(f * 2 + 1)) for f in frames]


def test_flop_count_with_both_kernels_on_card(card):
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.obs import xlacost

    B, S, D = 2, 64, 128
    x = torch.randint(0, 256, (B, 8, 8, 3), dtype=torch.uint8, device=card)
    w = torch.randn(4, 3, 3, 3, device=card)
    lw = torch.randn(D, 4, device=card)

    def small(x):
        y = kernels.scale_bias_cast(x, 1 / 127.5, -127.5)
        h = F.conv2d(y.permute(0, 3, 1, 2), w, padding=1)
        t = F.linear(h.flatten(2).transpose(1, 2), lw).bfloat16()
        q = t.reshape(B, 1, S, D)
        return kernels.flash_attention(q, q, q)

    before = kernels.flash_attention.launches
    with torch.inference_mode():
        _, flops = xlacost.count(small, x)
    assert kernels.flash_attention.launches == before + 1
    assert flops == (2 * B * 8 * 8 * 3 + 2 * B * 4 * 8 * 8 * 3 * 9
                     + 2 * B * S * 4 * D + 4 * B * S * S * D)


def test_tracer_closes_records_at_the_sink_fence(card):
    """A pooled window on the card under a tracer: every record ends with
    the sink's device-done mark, its residencies sum to its end-to-end
    latency, and that latency is at least its window's device time."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.obs import LatencyTracer
    from nnstreamer_tpu_torch.runtime import parse_launch

    w = torch.randn(512, 512)
    register_model("cuda_obs_mm", lambda p, x: (x @ p["w"]) @ p["w"],
                   params={"w": w}, in_shapes=[(1, 512)],
                   in_dtypes=np.float32)
    pipes = [parse_launch(
        "appsrc name=src ! queue ! tensor_filter name=net "
        "framework=torch-cuda model=cuda_obs_mm share-model=true batch=8 "
        "batch-timeout-ms=2 batch-buckets=8 ! appsink name=out")
        for _ in range(2)]
    with LatencyTracer(sample_every=1) as tr:
        for p in pipes:
            p["src"].spec = TensorsSpec.parse("512:1", "float32")
            p.start()
        try:
            for i in range(16):
                for p in pipes:
                    p["src"].push_buffer(Buffer.of(
                        torch.randn(1, 512, device=card), pts=i))
            for p in pipes:
                p["src"].end_of_stream()
            for p in pipes:
                assert p.wait_eos(timeout=60)
        finally:
            for p in pipes:
                p.stop()
    recs = tr.records()
    assert len(recs) == 32
    for r in recs:
        assert r["marks"][-1][2] == "device-done"
        assert sum(r["residency_s"].values()) == pytest.approx(r["e2e_s"],
                                                               abs=1e-9)
        assert r["e2e_s"] >= r["device_window_s"] > 0


def test_kill_switch_keeps_pool_dispatch_async(card):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, numpy as np, torch\n"
        f"sys.path.insert(0, {repo!r})\n"
        "from nnstreamer_tpu_torch.core import Buffer, TensorsSpec\n"
        "from nnstreamer_tpu_torch.filters import register_model\n"
        "from nnstreamer_tpu_torch.runtime import parse_launch\n"
        "register_model('ks', lambda x: x + 1, in_shapes=[(1, 4)],"
        " in_dtypes=np.float32)\n"
        "p = parse_launch('appsrc name=src ! tensor_filter name=net "
        "framework=torch-cuda model=ks share-model=true batch=4 "
        "batch-buckets=4 latency=1 ! appsink name=out')\n"
        "p['src'].spec = TensorsSpec.parse('4:1', 'float32')\n"
        "with p:\n"
        "    for i in range(8):\n"
        "        p['src'].push_buffer(Buffer.of(torch.zeros(1, 4,"
        " device='cuda'), pts=i))\n"
        "    p['src'].end_of_stream()\n"
        "    assert p.wait_eos(timeout=60)\n"
        "    pool = p['net'].pool\n"
        "    print(pool.stats.phase_samples,"
        " pool._sampler._last_out is None)\n")
    env = dict(os.environ, NNS_TPU_TORCH_OBS_DISABLE="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "True"]
