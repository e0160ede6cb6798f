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
The model lifecycle runs on the card at small width (a hot swap and a
canary of ViT weights files, each frame against its version alone within
1e-4), and the kernel cache makes a round trip with the real ``nvcc``.
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
    """``NNS_TPU_COMPILE_CACHE_DIR`` with the real compiler: a cold
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
