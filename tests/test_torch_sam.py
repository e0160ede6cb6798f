"""SAM's image encoder on the port (``models/sam.py``) against the
benchmark's plain reference (``portbench/reference/sam.py``: float32,
``image_encoder.py`` line by line, attention on materialized scores), on
the CPU at a small size: image 256, patch 16 (a 16x16 grid), window 6 (the
grid padded to 18, 9 windows), depth 4 with block 2 global, width 128, 2
heads of 64, neck 32.

Tolerances, each with its reason:

- float32 on both sides: ``FP32_TOL`` = 1e-4 of the reference's largest
  element.  The two compute the same function in float32 and differ only
  in the order of summation (the plain attention's einsum against the
  reference's matmuls, the relative-position products, the convolution
  algorithms): the reading is 8.4e-7.  The faults below read 0.46 (rel_w
  dropped) and 0.69 (row and column swapped).
- bf16 on the port: ``BF16_GAP`` = 0.2 of the frame's reference RMS, as
  the benchmark's ``embed_gap`` measures.  Every product rounds its
  operands to bf16 over 4 blocks and a neck: the readings are 0.036 and
  0.046; the reference with float8 operands reads 0.43 and 0.46.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.models import sam as tsam
from nnstreamer_tpu_torch.runtime import parse_launch
from portbench.reference import common
from portbench.reference import sam as ref

CFG = {"image_size": 256, "patch": 16, "hidden_size": 128, "num_layers": 4,
       "num_heads": 2, "mlp_dim": 256, "out_chans": 32, "window_size": 6,
       "global_attn_indexes": [2], "ln_eps": 1e-6,
       "normalize": {"sub": 127.5, "div": 127.5},
       "weights": {"dtype": "float32", "gain": 1.0, "pos_std": 0.02,
                   "rel_pos_std": 0.125, "bias": 0.02, "ln": 0.1}}
FP32_TOL = 1e-4
BF16_GAP = 0.2


def _frames(n, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, CFG["image_size"], CFG["image_size"], 3),
                         dtype=torch.uint8, generator=g)


@pytest.fixture(scope="module")
def case():
    """The reference's tree (seed 9), the port built from it, two frames
    normalized and the reference's embeddings of them."""
    tree = ref.make_tree(CFG, 9, "cpu")
    x = common.normalize(_frames(2), 127.5, 127.5)
    with torch.inference_mode():
        want = ref.embed(tree, x, CFG)
    return tree, tsam.sam_from_state_dict(tree), x, want


def _port(model, x, dtype=torch.float32):
    with torch.inference_mode():
        return tsam.sam_apply(model, x, dtype)


def _gap(got, want):
    """The largest absolute difference over the largest reference
    element."""
    return float((got - want).abs().max() / want.abs().max())


def test_encoder_matches_the_reference_in_float32(case):
    tree, model, x, want = case
    got = _port(model, x)
    assert got.shape == (2, 32, 16, 16) and got.dtype == torch.float32
    assert got.is_contiguous()
    assert _gap(got, want) < FP32_TOL


def test_encoder_in_bf16_is_within_the_benchmarks_gap(case):
    tree, model, x, want = case
    got = _port(model, x, torch.bfloat16)
    assert got.dtype == torch.float32
    rms = want.pow(2).mean(dim=(1, 2, 3)).sqrt()
    gap = (got - want).abs().amax(dim=(1, 2, 3)) / rms
    assert float(gap.max()) < BF16_GAP


def test_the_sizes_come_from_the_state_dict(case):
    _, model, _, _ = case
    assert [b.window for b in model.blocks] == [6, 6, 0, 6]
    assert [b.attn.grid for b in model.blocks] == [6, 6, 16, 6]
    assert model.blocks[0].attn.heads == 2 and model.grid == 16
    assert model.neck_w2.shape == (32, 32, 3, 3)


def test_the_published_layout_loads_with_its_prefix():
    """A whole checkpoint's keys (``image_encoder.`` and the prompt
    encoder's and mask decoder's beside them): the encoder's are taken,
    Linear weights (out, in) transposed into the products' (in, out)."""
    sd = tsam.sam_state_dict(4, image_size=64, patch=16, dim=128, depth=2,
                             heads=2, mlp_dim=256, out_chans=16, window=3,
                             global_attn_indexes=(1,))
    whole = {"image_encoder." + k: v for k, v in sd.items()}
    whole["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = \
        torch.zeros(2, 128)
    whole["mask_decoder.iou_token.weight"] = torch.zeros(1, 256)
    model = tsam.sam_from_state_dict(whole)
    assert [b.window for b in model.blocks] == [3, 0]
    blk = model.blocks[0]
    assert torch.equal(blk.attn.qkv.w,
                       sd["blocks.0.attn.qkv.weight"].t())
    assert torch.equal(blk.mlp2.w, sd["blocks.0.mlp.lin2.weight"].t())
    assert torch.equal(blk.attn.rel_pos_h, sd["blocks.0.attn.rel_pos_h"])
    assert torch.equal(model.neck_w1, sd["neck.0.weight"][:, :, 0, 0].t())
    x = torch.randn(1, 64, 64, 3)
    plain = tsam.sam_from_state_dict(sd)
    assert torch.equal(_port(model, x), _port(plain, x))


def _attention_with(monkeypatch, change):
    """The port's attention with its tables changed by ``change(rel_h,
    rel_w)`` on their way to the kernel."""
    real = tsam.flash_attention

    def faulty(q, k, v, rel_h, rel_w, key_grid):
        rel_h, rel_w = change(rel_h, rel_w)
        return real(q, k, v, rel_h=rel_h, rel_w=rel_w, key_grid=key_grid)

    monkeypatch.setattr(tsam, "flash_attention", faulty)


@pytest.mark.parametrize("fault", [
    lambda h, w: (h, torch.zeros_like(w)),
    lambda h, w: (w, h),
], ids=["rel_w-dropped", "row-and-column-swapped"])
def test_a_wrong_bias_fails_the_float32_tolerance(case, monkeypatch, fault):
    """Dropping ``rel_w``, or indexing the key grid as ``rel_h[i, j % Kw]
    + rel_w[i, j // Kw]`` (the square grid's tables swapped), fails the
    tolerance the sound encoder meets."""
    tree, model, x, want = case
    _attention_with(monkeypatch, fault)
    assert _gap(_port(model, x), want) > 100 * FP32_TOL


def test_padded_keys_take_part_unmasked(case, monkeypatch):
    """The windows at the grid's edge hold 2 rows or columns of padding
    (16 = 2·6 + 4): the port matches the reference, whose padded keys are
    unmasked, and not the reference with those keys masked."""
    tree, model, x, want = case
    state = {}
    attention, rel_pos = ref._attention, ref.add_decomposed_rel_pos

    def note_padding(tree_, pre, xw, heads, cast):
        # a padded token is exactly zero after norm1; no real one is
        state["pad"] = (xw == 0).all(-1).flatten(1).repeat_interleave(
            heads, 0)
        return attention(tree_, pre, xw, heads, cast)

    def masked(attn, q, *a):
        return rel_pos(attn, q, *a).masked_fill(state["pad"][:, None, :],
                                                float("-inf"))

    monkeypatch.setattr(ref, "_attention", note_padding)
    monkeypatch.setattr(ref, "add_decomposed_rel_pos", masked)
    with torch.inference_mode():
        masked_want = ref.embed(tree, x, CFG)
    assert bool(state["pad"].any())
    got = _port(model, x)
    assert _gap(got, want) < FP32_TOL
    assert _gap(got, masked_want) > 100 * FP32_TOL


def test_window_partition_round_trip():
    x = torch.randn(2, 16, 16, 8)
    w = tsam.window_partition(x, 6)
    assert w.shape == (2 * 9, 36, 8)
    # window (0, 2) of frame 0 holds columns 12..15 and 2 padded ones
    win = w[2].view(6, 6, 8)
    assert torch.equal(win[:, :4], x[0, :6, 12:16])
    assert not bool(win[:, 4:].any())
    assert torch.equal(tsam.window_unpartition(w, 6, 16, 16), x)


def test_register_sam_through_the_filter():
    """``register_sam``: the model a ``tensor_filter`` names, bf16
    compute, the embedding equal to ``sam_apply`` on the same weights."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec

    kw = dict(patch=16, dim=128, depth=2, heads=2, mlp_dim=256,
              out_chans=16, window=3, global_attn_indexes=(1,))
    name = tsam.register_sam("torch_sam_registered", batch=1, image_size=64,
                             seed=5, **kw)
    p = parse_launch("appsrc name=src ! tensor_transform mode=arithmetic "
                     "option=typecast:float32,div:255.0 ! tensor_filter "
                     f"framework=torch-cuda model={name} ! appsink name=out",
                     device="cpu")
    p["src"].spec = TensorsSpec.from_shapes([(1, 64, 64, 3)], np.uint8)
    x = np.random.default_rng(1).integers(0, 255, (1, 64, 64, 3), np.uint8)
    with p:
        p["src"].push_buffer(Buffer.of(x))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    got = p["out"].pull(timeout=1).tensors[0].np()
    model = tsam.sam_from_state_dict(tsam.sam_state_dict(5, 64, **kw))
    want = _port(model, torch.from_numpy(x).float() / 255.0, torch.bfloat16)
    assert got.shape == (1, 16, 4, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want.numpy())
