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
  contiguous inputs and on the ViT's strided qkv views alike, and with
  SAM's decomposed relative-position bias at SAM's two shapes (14x14
  windows, the 64x64 grid) and on grids of every kind.
SAM's encoder runs on the card at a small size: one biased launch a
block, f32 against the CPU within 1e-4, bf16 within the benchmark's gap;
at ViT-L's published sizes one forward makes 24 biased launches.
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
The active layer on the card: ``hw.probe()`` against ``torch.cuda``, a
``max-batch`` actuation onto buckets no window reached (their fold
verdicts taken before it returns, each frame within 1e-4 of the frame
alone), and an alert-triggered deep capture whose trace holds both
kernels' device rows.
The edge layer on the card: one host read of a card tensor crosses once
(``tobytes()`` then ``np()``, and the reverse), a query link in one
process keeps card frames on the card in both directions with the
device channel (no ledger row) and crosses once a tensor a hop without
it, and importing the edge layer and linting a ``tensor_query_client``
description in a child opens no CUDA context.  MQTT on the card:
``mqttsink`` drains each card tensor once (one d2h a tensor), and a
``connect-type=hybrid`` query link found through the broker serves card
frames with and without the device channel.
The parallel layer on the card, over 8 virtual device records laid over
the one card: the ViT (bf16, the attention kernel on each shard's batch
slice) and the SSD (f32, TF32 off, the fused ``scale_bias_cast``
prologue) sharded over ``data:4`` and ``data:2,model:2`` against the
unsharded invoke — logits within 5e-2 at bf16 and 1e-4 at f32,
detections equal — each kernel launched once per shard; and
``stage_handoff`` keeping a card frame on the card with one ``d2d`` row.
Training on the card: both kernels' wrappers raise on a card input that
requires grad under grad mode (no backward kernel exists) and launch
under ``torch.no_grad()``; three ``train_step`` steps of MobileNetV1 at
width 0.25 (f32, TF32 off, lr 1e-4) against the CPU's — the first loss
rtol 1e-4, the later ones 5e-3, leaves atol 1e-4 (about 3x the largest
reading on the card, 3.2e-5), and each leaf's update (after − before)
within ``tests/test_torch_training.py``'s relative-norm limits against
the JAX step (0.1 under sgd, 0.4 under adam/adamw); and the
``torch-optim`` trainer fed card samples written on a side stream,
training on the card with the losses of the same samples on the CPU.
The split step (``parallel/syncbn.py``) across distinct devices: ``data:2``
over a card record and a ``cpu`` record against the stacked card step at
the same limits (sgd, adam), and ``data:2`` over two real cards, skipped
where the machine has fewer, naming the count; the card + ``cpu`` split
with the caller on a side stream behind spin kernels, bit-equal to the
default streams; two gloo ranks each over a card record and a ``cpu``
record against the one-process ``data:4`` step over the same records
(the ranks' leaves bit-equal).
The importers on the card (files from ``tests/torch_model_files.py`` at
width 0.25, 96x96): the ONNX QLinear MobileNetV2 in its integer modes
(int8, dequant, bf16) and the TFLite one in ``dequant`` give the CPU's
outputs exactly, TF32 off; the speech graph's clip and mnist's batch
within 1e-5; the native codec loads and encodes a card buffer's bytes as
the Python path does.
"""

import contextlib
import os
import time

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


def _rel_tables(q, grid, seed=7):
    """rel_h (..., S, Kh) and rel_w (..., S, Kw), contiguous f32 on q's
    device, std 1 (a bias term moves a score as much as q·kᵀ·scale)."""
    g = torch.Generator().manual_seed(seed)
    lead = tuple(q.shape[:-1])
    return [torch.randn(lead + (n,), generator=g).to(q.device)
            for n in grid]


def _rel_plain_by_batch(q, k, v, rel_h, rel_w, grid):
    """The plain version a leading index at a time, so the materialized
    (S, Sk) scores of a 4096-token head fit beside the inputs."""
    return torch.cat([kernels.flash_attention_reference(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], rel_h=rel_h[i:i + 1],
        rel_w=rel_w[i:i + 1], key_grid=grid) for i in range(q.shape[0])])


@pytest.mark.parametrize("B,s,grid", [(32 * 25, 196, (14, 14)),
                                      (8, 4096, (64, 64))])
def test_flash_attention_rel_pos_on_qkv_views(card, B, s, grid):
    """SAM's two shapes, windowed (196 tokens of a 14x14 window, ragged in
    both tiles) and global (a 64x64 grid), on the head-split views of a
    qkv projection, bf16, at the unbiased kernel's tolerances; the biased
    launch is counted."""
    q, k, v = _qkv_views(B, s, s, 16, 64, torch.bfloat16, card)
    rel_h, rel_w = _rel_tables(q, grid)
    before = (kernels.flash_attention.launches,
              kernels.flash_attention.rel_pos_launches)
    o = kernels.flash_attention(q, k, v, rel_h=rel_h, rel_w=rel_w,
                                key_grid=grid)
    r = _rel_plain_by_batch(q, k, v, rel_h, rel_w, grid)
    torch.cuda.synchronize()
    assert (kernels.flash_attention.launches,
            kernels.flash_attention.rel_pos_launches) == \
        (before[0] + 1, before[1] + 1)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    tol = _FA_TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), r.float(), atol=tol, rtol=tol)
    # the bias moved the result: without it the output is far off
    unbiased = kernels.flash_attention(q[:2], k[:2], v[:2])
    assert float((unbiased.float() - r[:2].float()).abs().max()) > 10 * tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,s,grid", [(64, 17, (1, 17)), (64, 60, (6, 10)),
                                      (128, 300, (15, 20)),
                                      (64, 255, (17, 15)), (64, 192, (3, 64)),
                                      (64, 64, (1, 64))])
def test_flash_attention_rel_pos_matches_plain(card, dtype, d, s, grid):
    """Grids of every kind: one row, Kw < 8 steps and wraps, a ragged last
    tile, odd Kw, and 64-wide grids (bf16 reads their tables into
    registers) with an odd Kh, so a tile's second grid row is past Sk;
    f32 at head dims 64 and 128 (bf16 takes 64 alone)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv((2, 3, s, d), (2, 3, s, d), dtype, card, seed=2)
    rel_h, rel_w = _rel_tables(q, grid)
    if dtype == torch.bfloat16 and d != 64:
        with pytest.raises(ValueError, match="head dim 64"):
            kernels.flash_attention(q, k, v, rel_h=rel_h, rel_w=rel_w,
                                    key_grid=grid)
        return
    o = kernels.flash_attention(q, k, v, scale=0.2, rel_h=rel_h, rel_w=rel_w,
                                key_grid=grid)
    r = kernels.flash_attention_reference(q, k, v, scale=0.2, rel_h=rel_h,
                                          rel_w=rel_w, key_grid=grid)
    torch.cuda.synchronize()
    tol = _FA_TOL[dtype]
    torch.testing.assert_close(o.float(), r.float(), atol=tol, rtol=tol * 10
                               if dtype == torch.float32 else tol)


def test_flash_attention_rel_pos_refuses_without_fallback(card):
    q, k, v = _qkv((1, 2, 12, 64), (1, 2, 12, 64), torch.bfloat16, card)
    rel_h, rel_w = _rel_tables(q, (3, 4))
    before = kernels.flash_attention.launches
    with pytest.raises(ValueError, match="go together"):
        kernels.flash_attention(q, k, v, rel_h=rel_h, key_grid=(3, 4))
    with pytest.raises(ValueError, match="not a grid"):
        kernels.flash_attention(q, k, v, rel_h=rel_h, rel_w=rel_w,
                                key_grid=(4, 4))
    with pytest.raises(ValueError, match="float32"):
        kernels.flash_attention(q, k, v, rel_h=rel_h.bfloat16(),
                                rel_w=rel_w, key_grid=(3, 4))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.flash_attention(q, k, v, rel_h=rel_h, key_grid=(3, 4),
                                rel_w=rel_w.transpose(1, 2).contiguous()
                                .transpose(1, 2))
    assert kernels.flash_attention.launches == before


def test_sam_encoder_on_the_card(card):
    """SAM's encoder at a small size (a 10x10 grid in 3x3 windows, padded
    to 12, and a global block; 2 heads of 64): one biased launch a block,
    f32 on the card against the CPU within 1e-4 of the largest element
    (TF32 off; the order of summation differs), bf16 within 0.2 of each
    frame's RMS (the benchmark's ``embed_gap`` reads 0.07-0.09 at ViT-L)."""
    from nnstreamer_tpu_torch.models import sam

    torch.backends.cuda.matmul.allow_tf32 = False
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _sam_on_the_card(card, sam)
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32


def _sam_on_the_card(card, sam):
    kw = dict(patch=16, dim=128, depth=3, heads=2, mlp_dim=256,
              out_chans=32, window=3, global_attn_indexes=(1,))
    sd = sam.sam_state_dict(6, 160, **kw)
    x = torch.randn(2, 160, 160, 3, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = sam.sam_apply(sam.sam_from_state_dict(sd), x, torch.float32)
        model = sam.sam_from_state_dict({k: v.to(card) for k, v in sd.items()})
        before = (kernels.flash_attention.launches,
                  kernels.flash_attention.rel_pos_launches)
        got = sam.sam_apply(model, x.to(card), torch.float32)
        torch.cuda.synchronize()
        assert (kernels.flash_attention.launches - before[0],
                kernels.flash_attention.rel_pos_launches - before[1]) == (3, 3)
        bf16 = sam.sam_apply(model, x.to(card)).cpu()
    assert got.shape == (2, 32, 10, 10) and got.is_cuda
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    rms = want.pow(2).mean(dim=(1, 2, 3)).sqrt()
    assert float(((bf16 - want).abs().amax(dim=(1, 2, 3)) / rms).max()) < 0.2


def test_sam_vit_l_forward_launches_24_biased_attentions(card):
    """SAM ViT-L at its published sizes (24 blocks, width 1024, 16 heads
    of 64, global blocks 5, 11, 17 and 23, 14x14 windows padded to 70x70):
    one bf16 forward of a frame launches the attention kernel 24 times,
    each with the bias, and gives the (1, 256, 64, 64) embedding."""
    from nnstreamer_tpu_torch.models import sam

    model = sam.sam_from_state_dict(
        {k: v.to(card) for k, v in sam.sam_state_dict(3).items()})
    x = torch.randn(1, 1024, 1024, 3,
                    generator=torch.Generator().manual_seed(4)).to(card)
    with torch.inference_mode():
        before = (kernels.flash_attention.launches,
                  kernels.flash_attention.rel_pos_launches)
        got = sam.sam_apply(model, x)
        torch.cuda.synchronize()
    assert (kernels.flash_attention.launches - before[0],
            kernels.flash_attention.rel_pos_launches - before[1]) == (24, 24)
    assert got.shape == (1, 256, 64, 64) and bool(torch.isfinite(got).all())


def _ln_inputs(shape, dtype, card, seed=5):
    """x off zero mean with a spread that differs by row, and g and b away
    from ones and zeros, as trained norms hold them."""
    g = torch.Generator().manual_seed(seed)
    width = shape[-1]
    x = torch.randn(shape, generator=g) * (1 + 3 * torch.rand(
        shape[:-1] + (1,), generator=g)) + 2 * torch.randn(
        shape[:-1] + (1,), generator=g)
    gain = 1 + 0.2 * torch.randn(width, generator=g)
    bias = 0.5 * torch.randn(width, generator=g)
    return x.to(dtype).to(card), gain.to(card), bias.to(card)


def _assert_ln_close(y, r):
    """The kernel against its plain version.  Both sum the row in f32 but
    in another order, so mu and var differ in their last f32 bits: a bf16
    result may round to the neighbour of the plain one, 1 bf16 ulp of the
    plain value.  Near zero that ulp shrinks with the value while the f32
    difference does not, so the allowance never falls below 2^-16: far
    above the f32 noise (about 1e-6 at the rows' scale), far below a bf16
    ulp there (2^-7 at 1).  f32 results differ by those last bits alone:
    rtol 1e-5, atol 1e-6 for elements near the mean, where (x - mu) loses
    its leading bits."""
    assert y.shape == r.shape and y.dtype == r.dtype
    assert y.is_contiguous()
    if y.dtype == torch.float32:
        torch.testing.assert_close(y, r, rtol=1e-5, atol=1e-6)
        return
    yf, rf = y.float(), r.float()
    ulp = torch.exp2(torch.floor(torch.log2(rf.abs().clamp_min(2 ** -40)))
                     - 7)
    diff = (yf - rf).abs()
    allowed = ulp.clamp_min(2 ** -16)
    bad = diff > allowed
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} elements beyond 1 bf16 ulp; "
        f"worst {float(diff.max())}")


@pytest.mark.parametrize("shape,dtype", [
    ((64, 196, 768), torch.bfloat16),     # the ViT-B/16 cell's rows
    ((3, 256, 512), torch.bfloat16),      # chip_smoke phase 7's width
    ((1, 1, 768), torch.bfloat16),        # one row
    ((1001, 768), torch.bfloat16),        # not a multiple of 8 rows a block
    ((2, 16, 256), torch.float32),        # test_vit_on_card_matches_cpu's
    ((37, 64), torch.bfloat16),           # masked lanes: 8 of 32 hold a vector
    ((37, 128), torch.bfloat16),
    ((5, 2048), torch.bfloat16),          # the widest: 8 vectors a lane
    ((5, 1024), torch.float32),
])
def test_layer_norm_kernel_matches_plain(card, shape, dtype):
    x, gain, bias = _ln_inputs(shape, dtype, card)
    before = kernels.layer_norm.launches
    y = kernels.layer_norm(x, gain, bias, 1e-6)
    r = kernels.layer_norm_reference(x, gain, bias, 1e-6)
    torch.cuda.synchronize()
    assert kernels.layer_norm.launches == before + 1
    _assert_ln_close(y, r)


def test_layer_norm_kernel_on_strided_rows_and_bf16_params(card):
    """Rows a multiple of 16 bytes apart (the first 768 columns of wider
    rows) go in without a copy; bf16 g and b are widened exactly."""
    x, gain, bias = _ln_inputs((40, 1024), torch.bfloat16, card)
    view = x[:, 128:896]
    y = kernels.layer_norm(view, gain[:768].bfloat16(), bias[:768].bfloat16())
    r = kernels.layer_norm_reference(view, gain[:768].bfloat16().float(),
                                     bias[:768].bfloat16().float())
    _assert_ln_close(y, r)


def test_layer_norm_refuses_without_fallback(card):
    x, gain, bias = _ln_inputs((4, 768), torch.bfloat16, card)
    before = kernels.layer_norm.launches
    with pytest.raises(RuntimeError, match="layer_norm"):
        kernels.layer_norm(x, gain.clone().requires_grad_(), bias)
    with pytest.raises(ValueError, match="stride 1"):
        kernels.layer_norm(torch.zeros(768, 8, dtype=torch.bfloat16,
                                       device=card).t(), gain, bias)
    flat = torch.zeros(4 * 768 + 8, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.layer_norm(flat[1:1 + 4 * 768].view(4, 768), gain, bias)
    wide = torch.zeros(4, 772, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.layer_norm(wide[:, :768], gain, bias)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match=str(dt)):
            kernels.layer_norm(x.to(dt), gain, bias)
    big = torch.zeros(2, 4104, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="width 4104"):
        kernels.layer_norm(big, torch.ones(4104, device=card),
                           torch.zeros(4104, device=card))
    with pytest.raises(ValueError, match="width 770"):
        kernels.layer_norm(torch.zeros(2, 770, dtype=torch.bfloat16,
                                       device=card),
                           torch.ones(770, device=card),
                           torch.zeros(770, device=card))
    with pytest.raises(ValueError, match="g must be"):
        kernels.layer_norm(x, gain[:512], bias)
    assert kernels.layer_norm.launches == before


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
    ln_before = kernels.layer_norm.launches
    with torch.inference_mode():
        want = vit_apply(model, x, torch.float32)
        got = vit_apply(model.to(card), x.to(card), torch.float32)
    assert kernels.flash_attention.launches == before + 2   # one per block
    assert kernels.layer_norm.launches == ln_before + 2 * 2 + 1
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


# -- the active observability layer on the card -------------------------------


def test_hw_probe_on_card(card):
    from nnstreamer_tpu_torch.utils import hw

    caps = hw.probe()
    devs = caps["cuda"]
    assert len(devs) == torch.cuda.device_count()
    for i, d in enumerate(devs):
        free, total = torch.cuda.mem_get_info(i)
        assert d["kind"] == torch.cuda.get_device_name(i)
        assert d["bytes_limit"] == total
        assert 0 < d["bytes_in_use"] <= total
    assert caps["cpu"] and hw.accelerator_available("gpu")


def _vit_pool_rig(card, name, buckets):
    from nnstreamer_tpu_torch.core import TensorsSpec
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.runtime import parse_launch

    register_vit(name, batch=1, image_size=32, patch=8, dim=256, depth=2,
                 heads=2, mlp_dim=128, num_classes=5, seed=4)
    desc = ("appsrc name=src ! queue ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 backend=cuda ! "
            f"tensor_filter name=net framework=torch-cuda model={name} "
            f"share-model=true batch={buckets[-1]} batch-timeout-ms=5 "
            f"batch-buckets={','.join(map(str, buckets))} ! "
            "appsink name=out max-buffers=256")
    p = parse_launch(desc)
    p["src"].spec = TensorsSpec.parse("3:32:32:1", "uint8")
    return p


def _frames(card, n, seed=6):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (1, 32, 32, 3), generator=g,
                          dtype=torch.uint8).to(card) for _ in range(n)]


def test_max_batch_actuation_onto_unchecked_bucket_on_card(card):
    """max-batch steered onto buckets no window reached yet: their fold
    verdicts are taken before the actuation returns, every later window
    is a verdict hit, and each frame's logits equal the frame alone."""
    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.runtime.actuators import find_actuators

    p = _vit_pool_rig(card, "cuda_ctl_vit", (2, 4, 8))
    frames = _frames(card, 24)
    with p:
        entry = p["net"].pool
        sp = entry.subplugin
        for i in range(2):
            p["src"].push_buffer(Buffer.of(frames[i], pts=i))
        first = [p["out"].pull(timeout=60) for _ in range(2)]
        before = set(sp.hot_buckets())
        (act,) = find_actuators("pool", entry.label(), "max-batch")
        act.actuate(7)
        assert {2, 4, 8} <= set(sp.hot_buckets()) and before != {2, 4, 8}
        misses = sp.batch_cache_misses
        for i in range(2, 24):
            p["src"].push_buffer(Buffer.of(frames[i], pts=i))
        rest = [p["out"].pull(timeout=60) for _ in range(22)]
        assert sp.batch_cache_misses == misses
        outs = first + rest
        assert [b.pts for b in outs] == list(range(24))
        logits = [b.tensors[0].torch().cpu() for b in outs]
    # the same ViT (seed 4) on the same frames (seed 6), each alone
    alone = _pooled_vit(card, 1, 24, batch=1, share=False)[0]
    for i in range(24):
        torch.testing.assert_close(logits[i], alone[i], atol=POOLED_TOL,
                                   rtol=POOLED_TOL)


def test_deep_capture_device_rows_on_card(card, tmp_path):
    """An alert-triggered deep capture with the device session: the
    trace it writes holds both hand-written kernels' device rows, and
    frames pushed open-loop (every 4 ms, never waiting for a result)
    while the session starts and stops all arrive, in order."""
    import json
    import threading

    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.obs import prof

    p = _vit_pool_rig(card, "cuda_deep_vit", (4,))
    frames = _frames(card, 64, seed=7)
    prof.DEEP.arm(str(tmp_path), seconds=0.5, hz=100.0, min_interval_s=0.0,
                  device=True)
    sent = []

    def camera(stop):
        while not stop.is_set():
            i = len(sent)
            p["src"].push_buffer(Buffer.of(frames[i % 64], pts=i))
            sent.append(i)
            time.sleep(0.004)

    try:
        with p:
            for i in range(8):
                p["src"].push_buffer(Buffer.of(frames[i], pts=i))
            outs = [p["out"].pull(timeout=60) for _ in range(8)]
            sent.extend(range(8))
            stop = threading.Event()
            cam = threading.Thread(target=camera, args=(stop,))
            cam.start()
            try:
                assert prof.deep_trigger("card")
                deadline = time.monotonic() + 30
                while not prof.DEEP.captures and \
                        time.monotonic() < deadline:
                    outs.append(p["out"].pull(timeout=60))
            finally:
                stop.set()
                cam.join(10)
            while len(outs) < len(sent):
                outs.append(p["out"].pull(timeout=60))
        assert [b.pts for b in outs] == list(range(len(sent)))
        assert prof.DEEP.device_failures == 0, prof.DEEP.last_device_error
        (path,) = prof.DEEP.device_traces
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        assert any("scale_bias_cast" in n for n in names), sorted(names)[:20]
        assert any("flash_attention" in n for n in names), sorted(names)[:20]
    finally:
        prof.DEEP.disarm()
        prof.DEEP.clear()


# -- queue prefetch-host=, FilterSingle and the analyzer on the card ----------


def test_prefetch_copy_runs_on_a_side_stream(card, tmp_path):
    """``queue prefetch-host=true`` after a card transform: each enqueued
    tensor's device→host copy runs on a stream other than the one the
    transform's kernel ran on (torch.profiler's Chrome trace), the sink
    bytes equal a run without it, and each tensor crosses once."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.runtime import parse_launch

    g = torch.Generator().manual_seed(9)
    frames = [torch.randint(0, 256, (64, 64, 3), generator=g,
                            dtype=torch.uint8).to(card) for _ in range(6)]

    def run(pf):
        p = parse_launch(
            "appsrc name=src ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 backend=cuda ! "
            f"queue prefetch-host={pf} ! appsink name=out max-buffers=16")
        p["src"].spec = TensorsSpec.parse("3:64:64", "uint8")
        xfer.LEDGER.clear()
        with p:
            for i, f in enumerate(frames):
                p["src"].push_buffer(Buffer.of(f, pts=i))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
            outs = [p["out"].pull(timeout=10) for _ in frames]
            data = b"".join(b.tensors[0].np().tobytes() for b in outs)
        rows = [(r["reason"], r["count"]) for r in xfer.LEDGER.snapshot()
                if r["direction"] == "d2h"]
        return data, rows

    plain, plain_rows = run("false")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fetched, rows = run("true")
    assert fetched == plain
    assert rows == [("prefetch", len(frames))]
    assert plain_rows == [("drain", len(frames))]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies = {e["args"]["stream"] for e in events
              if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]}
    kernel = {e["args"]["stream"] for e in events
              if e.get("cat") == "kernel" and "scale_bias_cast" in e["name"]}
    assert copies and kernel and not copies & kernel, (copies, kernel)


def test_prefetched_tensor_then_written_in_place_on_card(card):
    """A card consumer after the prefetching queue (a ``donate=true``
    chain writing in place on the card) runs after the host copy has
    read the payload: the copy of each input holds the frame as it was
    enqueued, and the outputs equal a run without the prefetch.  A
    donated input still raises on ``np()``, its started copy or not."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.core.buffer import DonatedTensorError
    from nnstreamer_tpu_torch.obs import transfer
    from nnstreamer_tpu_torch.runtime import parse_launch

    g = torch.Generator().manual_seed(10)
    frames = [torch.randn((1024, 1024), generator=g).to(card)
              for _ in range(6)]

    def run(pf):
        p = parse_launch(
            f"appsrc name=src ! queue prefetch-host={pf} ! "
            "tensor_transform name=t mode=arithmetic "
            "option=mul:2.0,add:1.0 donate=true ! "
            "appsink name=out max-buffers=16")
        p["src"].spec = TensorsSpec.parse("1024:1024", "float32")
        seen, chain = [], p["t"].chain

        def keep(pad, buf):
            t = buf.tensors[0]
            seen.append((t, t._fetch))
            chain(pad, buf)

        p["t"].chain = keep
        with p:
            for i, f in enumerate(frames):
                p["src"].push_buffer(Buffer.of(f.clone(), pts=i))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
            outs = [p["out"].pull(timeout=10).tensors[0].np().copy()
                    for _ in frames]
        return seen, outs

    want = [(f * 2.0 + 1.0).cpu().numpy() for f in frames]
    for pf in ("false", "true"):
        seen, outs = run(pf)
        for got, w in zip(outs, want):
            np.testing.assert_array_equal(got, w)
    # the prefetched inputs were written in place, their copies were not
    assert all(t.prefetching and t.is_donated for t, _ in seen)
    for (t, fetch), f in zip(seen, frames):
        with pytest.raises(DonatedTensorError):
            t.np()
        with pytest.raises(DonatedTensorError):
            t.tobytes()
        np.testing.assert_array_equal(transfer.prefetched(fetch).numpy(),
                                      f.cpu().numpy())


def test_filter_single_equals_the_pipeline_on_card(card):
    """``FilterSingle`` on the card runs the same program as the
    pipeline's filter: the same logits, ``flash_attention`` launched once
    per layer per invoke, and a synchronous invoke in its stats."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.elements.filter import FilterSingle
    from nnstreamer_tpu_torch.models import register_vit
    from nnstreamer_tpu_torch.runtime import parse_launch

    register_vit("cuda_single_vit", batch=2, image_size=32, patch=8,
                 dim=256, depth=2, heads=2, mlp_dim=128, num_classes=5,
                 seed=5)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 32, 32, 3), generator=g).to(card)
    p = parse_launch("appsrc name=src ! tensor_filter framework=torch-cuda "
                     "model=cuda_single_vit ! appsink name=out")
    p["src"].spec = TensorsSpec.parse("3:32:32:2", "float32")
    with p:
        p["src"].push_buffer(Buffer.of(x))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
        want = p["out"].pull(timeout=10).tensors[0].torch()
    with FilterSingle(framework="torch-cuda", model="cuda_single_vit") as fs:
        assert fs.subplugin.device.type == "cuda"
        before = kernels.flash_attention.launches
        got = fs.invoke([x])[0]
        assert kernels.flash_attention.launches == before + 2
        assert fs.stats.total_invoke_num == 1
    assert got.is_cuda
    torch.testing.assert_close(got, want, atol=5e-2, rtol=5e-2)


def test_lint_opens_no_cuda_context(card):
    """A full lint in a child — a description whose ViT the dry run opens
    on the meta device, the static corpus, ``--self`` and
    ``--concurrency`` — leaves ``torch.cuda.is_initialized()`` False and
    launches no kernel."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import io, json, torch\n"
        "from nnstreamer_tpu_torch.models import register_vit\n"
        "from nnstreamer_tpu_torch.analyze.cli import main\n"
        "from nnstreamer_tpu_torch.ops import kernels\n"
        "register_vit('lint_vit', batch=2, image_size=32, patch=8, dim=64,"
        " depth=2, heads=2, mlp_dim=128, num_classes=5)\n"
        "out = io.StringIO()\n"
        "rc = main(['device_src spec=3:32:32:2/uint8 ! tensor_transform "
        "mode=arithmetic option=typecast:float32,div:255.0 backend=cuda ! "
        "tensor_filter framework=torch-cuda model=lint_vit ! tensor_sink',"
        " '--examples', '--self', '--concurrency', '--strict', '--json'],"
        " out=out)\n"
        "doc = json.loads(out.getvalue())\n"
        "print(json.dumps([rc, doc['summary'], torch.cuda.is_initialized(),"
        " kernels.flash_attention.launches,"
        " kernels.scale_bias_cast.launches]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0, r.stderr[-2000:]
    rc, summary, initialized, fa, sbc = json.loads(
        r.stdout.strip().splitlines()[-1])
    assert (rc, summary["error"], summary["warning"]) == (0, 0, 0), summary
    assert initialized is False
    assert (fa, sbc) == (0, 0)


# -- the edge layer ---------------------------------------------------------


@pytest.mark.parametrize("order", ["tobytes-np", "np-tobytes"])
def test_one_host_read_of_a_card_tensor_crosses_once(card, order):
    from nnstreamer_tpu_torch.core import Tensor
    from nnstreamer_tpu_torch.obs import transfer as xfer

    x = torch.arange(4096, dtype=torch.float32, device=card)
    t = Tensor(x)
    xfer.LEDGER.clear()
    if order == "tobytes-np":
        raw, arr = t.tobytes(), t.np()
    else:
        arr, raw = t.np(), t.tobytes()
    assert xfer.LEDGER.totals(direction="d2h") == (1, 4096 * 4)
    assert raw == arr.tobytes()
    np.testing.assert_array_equal(arr, np.arange(4096, dtype=np.float32))


@pytest.mark.parametrize("devch", [True, False])
def test_edge_query_link_on_card(card, devch):
    """``tensor_transform backend=cuda`` served over TCP in this process:
    with the device channel the frames and replies stay on the card (no
    ledger row, every deposit taken); without it one d2h a tensor a hop
    and one h2d a frame at the server's card element."""
    from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
    from nnstreamer_tpu_torch.edge import devicechannel
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.runtime import parse_launch

    caps = ("other/tensors,format=static,num_tensors=1,dimensions=4:8:1,"
            "types=float32")
    srv = parse_launch(
        f"tensor_query_serversrc name=qsrc connect-type=tcp "
        f"host=127.0.0.1 port=0 id=301 caps={caps} ! tensor_transform "
        "mode=arithmetic option=mul:3 backend=cuda ! "
        "tensor_query_serversink id=301")
    srv.start()
    frames = [torch.full((1, 8, 4), float(i + 1), device=card)
              for i in range(6)]
    try:
        cli = parse_launch(
            "appsrc name=src ! tensor_query_client name=cli host=127.0.0.1 "
            f"port={srv['qsrc'].port} connect-type=tcp caps={caps} "
            f"device-channel={'true' if devch else 'false'} ! "
            "appsink name=out")
        cli["src"].spec = TensorsSpec.parse("4:8:1", "float32")
        with cli:
            devicechannel.reset()
            xfer.LEDGER.clear()
            for i, f in enumerate(frames):
                cli["src"].push_buffer(Buffer(tensors=[Tensor(f)], pts=i))
            outs = [cli["out"].pull(timeout=60) for _ in frames]
            d2h = xfer.LEDGER.totals(direction="d2h")
            h2d = xfer.LEDGER.totals(direction="h2d")
            st = devicechannel.stats()
            cli["src"].end_of_stream()
            assert cli.wait_eos(timeout=60)
    finally:
        srv.stop()
    assert [b.pts for b in outs] == list(range(6))
    for i, b in enumerate(outs):
        np.testing.assert_array_equal(
            b.tensors[0].np(), np.full((1, 8, 4), 3.0 * (i + 1), np.float32))
    if devch:
        assert (d2h, h2d) == ((0, 0), (0, 0))
        assert st["deposits"] == st["takes"] == 12 and st["evicted"] == 0
        assert all(b.tensors[0].is_device for b in outs)
    else:
        assert (d2h[0], h2d[0]) == (12, 6) and st["deposits"] == 0


def test_edge_import_and_lint_open_no_cuda_context(card):
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json, torch\n"
        "import nnstreamer_tpu_torch.edge\n"
        "from nnstreamer_tpu_torch.analyze import analyze_description\n"
        "caps = ('other/tensors,format=static,num_tensors=1,'\n"
        "        'dimensions=4:1,types=float32')\n"
        "diags, _ = analyze_description(\n"
        "    f'appsrc caps={caps} ! tensor_query_client caps={caps} '\n"
        "    'dest-host=198.51.100.7 dest-port=5432 ! tensor_sink')\n"
        "print(json.dumps([sorted({d.code for d in diags}),\n"
        "                  torch.cuda.is_initialized()]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0, r.stderr[-2000:]
    codes, initialized = json.loads(r.stdout.strip().splitlines()[-1])
    assert "NNS506" in codes
    assert initialized is False


def test_mqttsink_drains_each_card_tensor_once(card):
    """Two card tensors a buffer through ``mqttsink``: one d2h a tensor at
    the publisher, the subscriber's bytes the card tensors'."""
    from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
    from nnstreamer_tpu_torch.edge.mqtt import MiniBroker
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.runtime import parse_launch

    broker = MiniBroker()
    frames = [(torch.full((2, 4), float(i), device=card),
               torch.arange(3, device=card) + i) for i in range(4)]
    try:
        sub = parse_launch(
            f"mqttsrc host=127.0.0.1 port={broker.port} sub-topic=cam "
            "num-buffers=4 ! appsink name=out", device="cpu")
        sub.start()
        pub = parse_launch(
            f"appsrc name=src ! mqttsink host=127.0.0.1 port={broker.port} "
            "pub-topic=cam")
        pub.name = "mq-card-pub"
        pub["src"].spec = TensorsSpec.parse("4:2,3", "float32,int64")
        pub.start()
        try:
            time.sleep(0.2)  # let the subscription settle
            xfer.LEDGER.clear()
            for i, (a, b) in enumerate(frames):
                pub["src"].push_buffer(Buffer(tensors=[Tensor(a), Tensor(b)],
                                              pts=i))
            assert sub.wait_eos(timeout=60)
            d2h = xfer.LEDGER.totals(pipeline="mq-card-pub", direction="d2h")
            got = [sub["out"].pull(timeout=5) for _ in frames]
        finally:
            pub.stop()
            sub.stop()
    finally:
        broker.stop()
    assert d2h == (8, 4 * (32 + 24))
    for g, (a, b) in zip(got, frames):
        assert g.tensors[0].tobytes() == a.cpu().numpy().tobytes()
        assert g.tensors[1].tobytes() == b.cpu().numpy().tobytes()


@pytest.mark.parametrize("devch", [True, False])
def test_hybrid_query_link_on_card(card, devch):
    """``tensor_transform backend=cuda`` served behind
    ``connect-type=hybrid``: the client finds the data port through the
    broker; with the device channel the frames stay on the card, without
    it one d2h a tensor a hop and one h2d a frame."""
    from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
    from nnstreamer_tpu_torch.edge import devicechannel
    from nnstreamer_tpu_torch.edge.mqtt import MiniBroker
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.runtime import parse_launch

    caps = ("other/tensors,format=static,num_tensors=1,dimensions=4:8:1,"
            "types=float32")
    broker = MiniBroker()
    srv = parse_launch(
        f"tensor_query_serversrc name=qsrc connect-type=hybrid "
        f"host=127.0.0.1 port={broker.port} topic=hy-card id=302 "
        f"caps={caps} ! tensor_transform mode=arithmetic option=mul:3 "
        "backend=cuda ! tensor_query_serversink id=302")
    frames = [torch.full((1, 8, 4), float(i + 1), device=card)
              for i in range(6)]
    try:
        srv.start()
        cli = parse_launch(
            "appsrc name=src ! tensor_query_client name=cli host=127.0.0.1 "
            f"port={broker.port} connect-type=hybrid topic=hy-card "
            f"caps={caps} device-channel={'true' if devch else 'false'} ! "
            "appsink name=out")
        cli["src"].spec = TensorsSpec.parse("4:8:1", "float32")
        with cli:
            devicechannel.reset()
            xfer.LEDGER.clear()
            for i, f in enumerate(frames):
                cli["src"].push_buffer(Buffer(tensors=[Tensor(f)], pts=i))
            outs = [cli["out"].pull(timeout=60) for _ in frames]
            d2h = xfer.LEDGER.totals(direction="d2h")
            h2d = xfer.LEDGER.totals(direction="h2d")
            st = devicechannel.stats()
            cli["src"].end_of_stream()
            assert cli.wait_eos(timeout=60)
    finally:
        srv.stop()
        broker.stop()
    assert [b.pts for b in outs] == list(range(6))
    for i, b in enumerate(outs):
        np.testing.assert_array_equal(
            b.tensors[0].np(), np.full((1, 8, 4), 3.0 * (i + 1), np.float32))
    if devch:
        assert (d2h, h2d) == ((0, 0), (0, 0))
        assert st["deposits"] == st["takes"] == 12 and st["evicted"] == 0
    else:
        assert (d2h[0], h2d[0]) == (12, 6) and st["deposits"] == 0


# -- the parallel layer on the card -----------------------------------------


@pytest.fixture
def virtual_cards(card):
    from nnstreamer_tpu_torch.parallel import mesh

    mesh.set_virtual_devices(8, "cuda")
    yield card
    mesh.clear_virtual_devices()


@pytest.mark.parametrize("placement", ["mesh=data:4", "mesh=data:8"])
def test_sharded_vit_equals_unsharded_on_card(virtual_cards, placement):
    """A window of 8 ViT frames: one attention launch a layer per shard,
    each shard's qkv rows through the kernel, logits within 5e-2 (bf16)
    of the unsharded window."""
    from nnstreamer_tpu_torch.elements.filter import FilterSingle
    from nnstreamer_tpu_torch.filters import unregister_model
    from nnstreamer_tpu_torch.models import register_vit

    register_vit("cuda_mesh_vit", batch=1, image_size=32, patch=8, dim=256,
                 depth=2, heads=2, mlp_dim=128, num_classes=10)
    try:
        frames = [[torch.from_numpy(np.random.default_rng(i).standard_normal(
            (1, 32, 32, 3)).astype(np.float32)).cuda()] for i in range(8)]
        plain = FilterSingle(framework="torch-cuda", model="cuda_mesh_vit")
        meshed = FilterSingle(framework="torch-cuda", model="cuda_mesh_vit",
                              mesh=placement.split("=")[1])
        shards = len(meshed.subplugin._placement.groups)
        want = plain.subplugin.invoke_batched(frames, 8)
        meshed.subplugin.invoke_batched(frames, 8)  # the fold probe
        n0 = kernels.flash_attention.launches
        got = meshed.subplugin.invoke_batched(frames, 8)
        torch.cuda.synchronize()
        assert kernels.flash_attention.launches - n0 == 2 * shards
        for a, b in zip(got, want):
            torch.testing.assert_close(a[0], b[0], rtol=5e-2, atol=5e-2)
    finally:
        unregister_model("cuda_mesh_vit")


@pytest.mark.parametrize("placement", [dict(mesh="data:4"),
                                       dict(mesh="data:2,model:2",
                                            sharding="tp")])
def test_sharded_ssd_equals_unsharded_on_card(virtual_cards, placement):
    """The SSD at f32 (TF32 off) behind the fused normalize prologue:
    sharded raw heads within 1e-4 of the unsharded ones, the prologue
    kernel launched once per data shard."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.filters import register_model, \
        unregister_model
    from nnstreamer_tpu_torch.models import convert
    from nnstreamer_tpu_torch.runtime import parse_launch

    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = convert.ssd_from_jax(convert.ssd_mobilenet_v2_init(0, 5))
    register_model("cuda_mesh_ssd", lambda m, x: m(x, dtype=torch.float32),
                   params=model, in_shapes=[(8, 64, 64, 3)])
    x = np.random.default_rng(1).integers(0, 255, (8, 64, 64, 3),
                                          dtype=np.uint8)

    def run(**kw):
        props = " ".join(f"{k}={v}" for k, v in kw.items())
        p = parse_launch(
            "appsrc name=src ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 backend=cuda ! "
            "tensor_filter "
            f"framework=torch-cuda model=cuda_mesh_ssd {props} ! "
            "appsink name=out")
        p["src"].spec = TensorsSpec.from_shapes([x.shape], np.uint8)
        with p:
            # the second frame's launches: the first pays the build
            p["src"].push_buffer(Buffer.of(x))
            assert p["out"].pull(timeout=120) is not None
            n0 = kernels.scale_bias_cast.launches
            p["src"].push_buffer(Buffer.of(x))
            out = p["out"].pull(timeout=120)
            p["src"].end_of_stream()
            torch.cuda.synchronize()
            return out, kernels.scale_bias_cast.launches - n0

    try:
        want, _ = run()
        got, launches = run(**placement)
        shards = 2 if "model" in placement["mesh"] else 4
        assert launches == shards
        for a, b in zip(got.tensors, want.tensors):
            torch.testing.assert_close(a.torch(), b.torch(), rtol=1e-4,
                                       atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        unregister_model("cuda_mesh_ssd")


def test_stage_handoff_on_card(virtual_cards):
    """A card frame handed to another device record's stage stays on the
    card: a fresh copy, one d2d/handoff row of its bytes, no host
    crossing."""
    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.edge import devicechannel as devch
    from nnstreamer_tpu_torch.obs import transfer as xfer
    from nnstreamer_tpu_torch.parallel import mesh

    x = torch.arange(1024, dtype=torch.float32, device="cuda")
    target = mesh.local_devices("cuda")[4]
    t0 = xfer.LEDGER.totals(direction="d2d", reason="handoff")
    h0 = xfer.LEDGER.totals(direction="d2h")[0] + \
        xfer.LEDGER.totals(direction="h2d")[0]
    out = devch.stage_handoff(Buffer.of(x), target, chan=("stage", "c"))
    y = out.tensors[0].torch()
    t1 = xfer.LEDGER.totals(direction="d2d", reason="handoff")
    h1 = xfer.LEDGER.totals(direction="d2h")[0] + \
        xfer.LEDGER.totals(direction="h2d")[0]
    assert y.is_cuda and out.residency == "device"
    assert y.data_ptr() != x.data_ptr() and torch.equal(y, x)
    assert mesh.device_ids_of(y) == (4,)
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (1, 4096) and h1 == h0


# -- training on the card ----------------------------------------------------------


def test_kernel_wrappers_refuse_grad_on_card(card):
    """No backward kernel: a card input that requires grad raises under
    grad mode, naming the kernel; under no_grad both kernels launch."""
    x = torch.rand(2, 8, 8, 3, device=card, requires_grad=True)
    q = torch.randn(1, 2, 64, 64, device=card, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="scale_bias_cast"):
        kernels.scale_bias_cast(x, 2.0, 1.0)
    with pytest.raises(RuntimeError, match="flash_attention"):
        kernels.flash_attention(q, q.detach(), q.detach())
    n0 = (kernels.scale_bias_cast.launches, kernels.flash_attention.launches)
    with torch.no_grad():
        y = kernels.scale_bias_cast(x, 2.0, 1.0)
        o = kernels.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert (kernels.scale_bias_cast.launches,
            kernels.flash_attention.launches) == (n0[0] + 1, n0[1] + 1)
    torch.testing.assert_close(
        y, kernels.scale_bias_cast_reference(x.detach(), 2.0, 1.0))
    assert bool(torch.isfinite(o).all())
    # the plain versions keep autograd on the CPU
    xc = torch.rand(2, 3, requires_grad=True)
    kernels.scale_bias_cast(xc, 2.0, 1.0).sum().backward()
    assert torch.equal(xc.grad, torch.full((2, 3), 2.0))


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_train_step_on_card_matches_cpu(card, name, monkeypatch):
    import functools

    from nnstreamer_tpu_torch.models import convert, mobilenet
    from nnstreamer_tpu_torch.parallel import mesh, sharded
    from nnstreamer_tpu_torch.trainers.torch_optim import _make_optimizer

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((3, 16, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, (3, 16)).astype(np.int32)
    tree = mobilenet.mobilenet_v1_init(0, 10, 0.25)
    apply = functools.partial(convert.mobilenet_v1_tree_apply,
                              dtype=torch.float32)
    lr = 1e-4
    runs = {}
    for dev in ("cuda", "cpu"):
        recs = mesh.local_devices(dev)[:1]
        step, p, o = sharded.train_step(
            mesh.make_mesh("data:1", recs), apply, tree,
            optimizer=_make_optimizer({"optimizer": name, "lr": lr}))
        losses = []
        for x, y in zip(xs, ys):
            p, o, loss = step(p, o, x, y)
            assert loss.device.type == dev
            losses.append(float(loss))
        runs[dev] = (losses, sharded.trained_tree(p))
    assert runs["cuda"][0][0] == pytest.approx(runs["cpu"][0][0], rel=1e-4)
    assert runs["cuda"][0] == pytest.approx(runs["cpu"][0], rel=5e-3)

    def leaves(t):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k])
        elif isinstance(t, list):
            for v in t:
                yield from leaves(v)
        else:
            yield t

    limit = {"sgd": 0.1, "adam": 0.4, "adamw": 0.4}[name]
    for a, b, i0 in zip(leaves(runs["cuda"][1]), leaves(runs["cpu"][1]),
                        leaves(tree)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        nb = np.linalg.norm(b - i0)
        if nb:
            assert np.linalg.norm(a - b) / nb <= limit
        else:
            assert np.array_equal(a, b)


def _split_small_run(recs, name, spec=None):
    """3 ``train_step`` steps of MobileNetV1 w0.25 (f32, lr 1e-4) over a
    ``data:len(recs)`` mesh of ``recs`` (or ``spec``): (losses, the
    trained tree, the step)."""
    import functools

    from nnstreamer_tpu_torch.models import convert, mobilenet
    from nnstreamer_tpu_torch.parallel import mesh, sharded
    from nnstreamer_tpu_torch.trainers.torch_optim import _make_optimizer

    rng = np.random.default_rng(3)
    xs = rng.standard_normal((3, 16, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, (3, 16)).astype(np.int32)
    step, p, o = sharded.train_step(
        mesh.make_mesh(spec or f"data:{len(recs)}", recs),
        functools.partial(convert.mobilenet_v1_tree_apply,
                          dtype=torch.float32),
        mobilenet.mobilenet_v1_init(0, 10, 0.25),
        optimizer=_make_optimizer({"optimizer": name, "lr": 1e-4}))
    losses = []
    for x, y in zip(xs, ys):
        p, o, loss = step(p, o, x, y)
        losses.append(float(loss))
    return losses, sharded.trained_tree(p), step


def _tree_leaves(t):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _tree_leaves(t[k])
    elif isinstance(t, list):
        for v in t:
            yield from _tree_leaves(v)
    else:
        yield t


def _hold_split_leaves(lp, tp, ls, ts, name):
    """The split step's losses and tree against the stacked step's, at the
    limits of ``test_train_step_on_card_matches_cpu``."""
    from nnstreamer_tpu_torch.models import mobilenet

    assert lp[0] == pytest.approx(ls[0], rel=1e-4)
    assert lp == pytest.approx(ls, rel=5e-3)
    limit = {"sgd": 0.1, "adam": 0.4, "adamw": 0.4}[name]
    for a, b, i0 in zip(_tree_leaves(tp), _tree_leaves(ts), _tree_leaves(
            mobilenet.mobilenet_v1_init(0, 10, 0.25))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        nb = np.linalg.norm(b - i0)
        if nb:
            assert np.linalg.norm(a - b) / nb <= limit
        else:
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_train_step_split_over_card_and_cpu_matches_stacked(card, name,
                                                             monkeypatch):
    """``data:2`` over a card record and a ``cpu`` record — two distinct
    real devices, one shard on each, the batch statistics combined across
    them — against the stacked ``data:1`` step on the card."""
    from nnstreamer_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cuda0 = mesh.Device("cuda", 0, 0, torch.device("cuda", 0))
    ls, ts, _ = _split_small_run([cuda0], name)
    lp, tp, step = _split_small_run(
        [cuda0, mesh.Device("cpu", 1, 0, torch.device("cpu"))], name)
    assert step.devices == [torch.device("cuda", 0), torch.device("cpu")]
    _hold_split_leaves(lp, tp, ls, ts, name)


def test_train_step_split_over_two_cards_matches_stacked(card, monkeypatch):
    """``data:2`` over two real cards against the stacked step on the
    first: runs only where the machine has two."""
    from nnstreamer_tpu_torch.parallel import mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards, the machine has {n}")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    recs = mesh.local_devices("cuda")[:2]
    ls, ts, _ = _split_small_run(recs[:1], "sgd")
    lp, tp, step = _split_small_run(recs, "sgd")
    assert step.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    _hold_split_leaves(lp, tp, ls, ts, "sgd")


RANK_WORKER = """\
import functools, pickle, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from nnstreamer_tpu_torch.models import convert, mobilenet
from nnstreamer_tpu_torch.parallel import mesh, multihost, sharded
from nnstreamer_tpu_torch.trainers.torch_optim import _make_optimizer

rank, port, out, spec, det = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4], sys.argv[5] == "1")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = det
multihost.initialize(coordinator_address="127.0.0.1:" + port,
                     num_processes=2, process_id=rank, backend="gloo")
devs = (torch.device("cuda", 0), torch.device("cpu"))
recs = [mesh.Device(d.type, 2 * r + i, r, d)
        for r in range(2) for i, d in enumerate(devs)]
rng = np.random.default_rng(3)
xs = rng.standard_normal((3, 16, 32, 32, 3)).astype(np.float32)
ys = rng.integers(0, 10, (3, 16)).astype(np.int32)
step, p, o = sharded.train_step(
    mesh.make_mesh(spec, recs),
    functools.partial(convert.mobilenet_v1_tree_apply, dtype=torch.float32),
    mobilenet.mobilenet_v1_init(0, 10, 0.25),
    optimizer=_make_optimizer({{"optimizer": "sgd", "lr": 1e-4}}))
assert step.devices == list(devs)
# data:4: each rank its 8 rows; model:2,data:2: every model group spans
# the ranks, and each rank runs both data shards on all 16 rows
rows = slice(8 * rank, 8 * rank + 8) if spec == "data:4" else slice(None)
losses = []
for x, y in zip(xs, ys):
    p, o, loss = step(p, o, x[rows], y[rows])
    losses.append(float(loss))
step.close()
with open(out, "wb") as f:
    pickle.dump((losses, sharded.trained_tree(p)), f)
multihost.shutdown()
"""


def _two_rank_run(tmp_path, spec, deterministic):
    """The two gloo ranks of ``RANK_WORKER`` on ``spec`` over (card, cpu)
    records each, cuDNN ``deterministic`` or not: [(losses, tree)] by
    rank."""
    import pickle
    import socket
    import subprocess
    import sys

    script = tmp_path / "rank_worker.py"
    script.write_text(RANK_WORKER.format(repo=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), port,
         str(tmp_path / f"rank{r}.pkl"), spec, str(int(deterministic))],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(2)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=300)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"rank {r}:\n{out}"
    got = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


def _hold_two_ranks(tmp_path, monkeypatch, spec, deterministic=True):
    """Two gloo ranks, each with a card record and a ``cpu`` record (two
    distinct devices of one rank: the backward runs on the card's
    autograd thread and the CPU's, and every rank must issue its
    collectives in one order), cuDNN ``deterministic`` or not on the
    ranks, against the one-process step on the same mesh over the same
    four records (deterministic), at the split step's limits; the ranks'
    losses and leaves bit-equal."""
    from nnstreamer_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    (l0, t0), (l1, t1) = _two_rank_run(tmp_path, spec, deterministic)
    assert l0 == l1
    for a, b in zip(_tree_leaves(t0), _tree_leaves(t1)):
        assert a.tobytes() == b.tobytes()
    devs = (torch.device("cuda", 0), torch.device("cpu"))
    recs = [mesh.Device(d.type, i, 0, d) for i, d in enumerate(devs * 2)]
    lp, tp, _ = _split_small_run(recs, "sgd", spec)
    _hold_split_leaves(l0, t0, lp, tp, "sgd")


def test_two_ranks_over_a_card_and_a_cpu_record_each_match_one_process(
        card, tmp_path, monkeypatch):
    """``data:4``: a data shard a record, against one process."""
    _hold_two_ranks(tmp_path, monkeypatch, "data:4")


def test_model_groups_across_two_ranks_over_a_card_and_a_cpu_record(
        card, tmp_path, monkeypatch):
    """``model:2,data:2``: every model group spans the ranks (the card
    shard's group both ranks' card records, the other both ``cpu``
    records), its split layers gathered over them, each rank running
    both data shards on all 16 rows; against one process on the same
    mesh.  The ranks run cuDNN's default algorithms, whose backward
    sums are not bit-reproducible: each rank of a group computes the
    replicated layers' gradients itself, and their leaves stay bit-equal
    only because the step sums those gradients over every rank."""
    _hold_two_ranks(tmp_path, monkeypatch, "model:2,data:2",
                    deterministic=False)


#: cycles of each spin kernel of the side-stream test (about 10 ms)
SIDE_SPIN_CYCLES = 20_000_000


def _spin_apply(params, x, train=False):
    """Two normalized layers of a small model; on a card shard a spin
    kernel runs ahead of each ``batch_moments``, so that a shard reading
    the card shard's moments unordered reads memory not yet written."""
    from nnstreamer_tpu_torch.parallel import syncbn

    h = x @ params["w1"]
    if h.is_cuda:
        torch.cuda._sleep(SIDE_SPIN_CYCLES)
    mean, var = syncbn.batch_moments(h, (0,))
    h = torch.relu((h - mean) * torch.rsqrt(var + 1e-3)) @ params["w2"]
    if h.is_cuda:
        torch.cuda._sleep(SIDE_SPIN_CYCLES)
    mean, var = syncbn.batch_moments(h, (0,))
    return (h - mean) * torch.rsqrt(var + 1e-3) + params["b"]


def _side_run(model, recs, side):
    """3 sgd steps of ``model`` over ``data:2`` of ``recs``, the caller
    inside ``torch.cuda.stream(side)`` with a spin kernel on it ahead of
    each step (``side`` None: the default streams); (losses, tree)."""
    import functools

    from nnstreamer_tpu_torch.models import convert, mobilenet
    from nnstreamer_tpu_torch.parallel import mesh, sharded
    from nnstreamer_tpu_torch.trainers.torch_optim import _make_optimizer

    rng = np.random.default_rng(12)
    if model == "spin":
        apply = _spin_apply
        tree = {"w1": rng.standard_normal((64, 32)).astype(np.float32) * .1,
                "w2": rng.standard_normal((32, 10)).astype(np.float32) * .1,
                "b": np.zeros(10, np.float32)}
        xs = rng.standard_normal((3, 16, 64)).astype(np.float32)
    else:
        apply = functools.partial(convert.mobilenet_v1_tree_apply,
                                  dtype=torch.float32)
        tree = mobilenet.mobilenet_v1_init(0, 10, 0.25)
        xs = rng.standard_normal((3, 16, 32, 32, 3)).astype(np.float32)
    ys = rng.integers(0, 10, (3, 16)).astype(np.int32)
    step, p, o = sharded.train_step(
        mesh.make_mesh("data:2", recs), apply, tree,
        optimizer=_make_optimizer({"optimizer": "sgd", "lr": 1e-2}))
    losses = []
    ctx = torch.cuda.stream(side) if side is not None else \
        contextlib.nullcontext()
    with ctx:
        for x, y in zip(xs, ys):
            if side is not None:
                torch.cuda._sleep(SIDE_SPIN_CYCLES)
            p, o, loss = step(p, o, x, y)
            losses.append(float(loss))
    torch.cuda.synchronize()
    step.close()
    return losses, sharded.trained_tree(p)


@pytest.mark.parametrize("model", ["spin", "mobilenet"])
def test_split_step_on_a_side_stream_equals_the_default_stream(
        card, model, monkeypatch):
    """The split step over a card record and a ``cpu`` record with the
    caller inside ``torch.cuda.stream(side)`` and a spin kernel on it
    ahead of the forward (and, for ``spin``, ahead of each moment): the
    ``cpu`` shard's thread reads the card shard's rows, leaves and
    moments through its own streams, which wait on the caller's and the
    poster's events (``parallel/syncbn.py``, ``parallel/sharded.py``).
    ``spin``'s losses and leaves equal the default-stream run's bit for
    bit (the side run goes first, so no block it reads can hold the
    default run's values; without the poster's event its losses go NaN).
    MobileNetV1 is held at the split step's limits: a leaf it reads
    twice on the card shard gets three gradient terms, two from the card
    and one from the ``cpu`` shard, and autograd adds them in the order
    its device threads deliver them, so two default-stream runs differ
    in the last bits too."""
    from nnstreamer_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    recs = [mesh.Device("cuda", 0, 0, torch.device("cuda", 0)),
            mesh.Device("cpu", 1, 0, torch.device("cpu"))]
    ls, ts = _side_run(model, recs, torch.cuda.Stream())
    ld, td = _side_run(model, recs, None)
    if model == "mobilenet":
        _hold_split_leaves(ls, ts, ld, td, "sgd")
        return
    assert ls == ld
    for a, b in zip(_tree_leaves(ts), _tree_leaves(td)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_trainer_on_card_with_side_stream_samples(card, monkeypatch):
    """Card samples written on a side stream and pushed with it current
    (as a streaming thread on its own stream would): the trainer waits on
    their events before it stacks them on its worker thread, trains on
    the card, and its epoch losses equal the CPU trainer's on the same
    samples."""
    from nnstreamer_tpu_torch.trainers import TrainerProps
    from nnstreamer_tpu_torch.trainers.torch_optim import TorchOptimTrainer

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    def apply(params, x, train=False):
        return x @ params["w"] + params["b"]

    rng = np.random.default_rng(4)
    xs = rng.standard_normal((32, 1, 256)).astype(np.float32)
    ys = (xs.sum(axis=(1, 2)) > 0).astype(np.int32).reshape(32, 1, 1)
    losses = {}
    side = torch.cuda.Stream()
    for dev in ("cuda", "cpu"):
        seen = []
        sp = TorchOptimTrainer()
        sp.configure(TrainerProps(
            model_config={"apply": apply, "init": {
                "w": np.zeros((256, 2), np.float32),
                "b": np.zeros(2, np.float32)}, "batch_size": 8, "lr": 0.1},
            num_training_samples=32, num_epochs=2, device=dev),
            lambda ev, data: seen.append(data.get("training_loss"))
            if ev == "epoch-completion" else None)
        sp.start()
        try:
            for _ in range(2):
                for x, y in zip(xs, ys):
                    if dev == "cpu":
                        sp.push_data([x], [y])
                        continue
                    with torch.cuda.stream(side):
                        t = torch.from_numpy(x).to(card) * 1.0
                        for _ in range(20):   # a long write
                            t = t * 1.0
                        sp.push_data([t], [torch.from_numpy(y)])
            assert sp.finished.wait(120)
            assert sp.error is None
            assert sp.built[2]["w"].device.type == dev
        finally:
            sp.stop()
        losses[dev] = seen
    assert len(losses["cuda"]) == 2
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-5)


# -- the importers and the native codec -------------------------------------


@pytest.fixture
def importer_files(card, tmp_path_factory, monkeypatch):
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_model_files as mf

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    d = tmp_path_factory.mktemp("importers")
    return {"onnx": mf.write_onnx_qlinear(str(d / "q.onnx"), 0, 0.25, 96,
                                          1000),
            "tflite": mf.write_tflite_quant(str(d / "q.tflite"), 0, 0.25,
                                            96, 1001),
            "speech": mf.write_speech_pb(str(d / "s.pb"), filters=8),
            "mnist": mf.write_mnist_pb(str(d / "m.pb")), "mf": mf}


def _single(fw, path, x, device, **kw):
    from nnstreamer_tpu_torch.elements.filter import FilterSingle

    out = FilterSingle(framework=fw, model=path, device=device,
                       **kw).invoke([x])[0]
    return out.cpu().numpy()


@pytest.mark.parametrize("fw,qmode", [("onnx", "int8"), ("onnx", "dequant"),
                                      ("onnx", "bf16"),
                                      ("tensorflow-lite", "dequant")])
def test_importer_integer_modes_on_card_equal_cpu(importer_files, fw,
                                                  qmode):
    q = np.random.default_rng(3).integers(0, 256, (2, 96, 96, 3),
                                          dtype=np.uint8)
    if fw == "onnx":
        x = np.ascontiguousarray(np.transpose(
            q.astype(np.float32) / 127.5 - 1.0, (0, 3, 1, 2)))
        path = importer_files["onnx"]
    else:
        x, path = q, importer_files["tflite"]
    got = _single(fw, path, x, "cuda", custom=f"qmode:{qmode}")
    want = _single(fw, path, x, "cpu", custom=f"qmode:{qmode}")
    np.testing.assert_array_equal(got, want)


def test_importer_tf_graphs_on_card_match_cpu(importer_files):
    from nnstreamer_tpu_torch.core import TensorsSpec

    clip = importer_files["mf"].seeded_clip(1)
    got = _single("tensorflow", importer_files["speech"], clip, "cuda")
    want = _single("tensorflow", importer_files["speech"], clip, "cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    x = np.random.default_rng(2).random((4, 784)).astype(np.float32)
    spec = TensorsSpec.parse("784:4", "float32")
    np.testing.assert_allclose(
        _single("tensorflow", importer_files["mnist"], x, "cuda",
                input_spec=spec),
        _single("tensorflow", importer_files["mnist"], x, "cpu",
                input_spec=spec), rtol=1e-5, atol=1e-6)


def test_native_codec_on_the_card_machine(card):
    from nnstreamer_tpu_torch import nativelib
    from nnstreamer_tpu_torch.converters import codecs
    from nnstreamer_tpu_torch.core import Buffer, Tensor

    lib = nativelib.get_native()
    assert lib is not None, "the native codec did not build here"
    b = Buffer(tensors=[Tensor(torch.arange(24, dtype=torch.float32,
                                            device=card).reshape(2, 3, 4))])
    native = codecs.protobuf_encode(b)
    try:
        nativelib._lib = None
        python = codecs.protobuf_encode(b)
    finally:
        nativelib._lib = lib
    assert native == python
    out, _ = codecs.protobuf_decode(native)
    np.testing.assert_array_equal(out.tensors[0].np(),
                                  np.arange(24, dtype=np.float32).reshape(
                                      2, 3, 4))
