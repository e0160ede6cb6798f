"""Plain reference of SAM's ViT image encoder (Segment Anything,
arXiv:2304.02643; ``segment_anything/modeling/image_encoder.py``,
``ImageEncoderViT`` as ``build_sam_vit_l`` builds it): its weights from the
seed in the published state-dict layout, the float32 forward, and the
judge that holds the program's embeddings against it.

Plain ``torch`` in float32 with TF32 off, following ``image_encoder.py``
line by line: the patch convolution and ``pos_embed``; blocks that pad
the token grid after ``norm1`` to a multiple of the window (padded tokens
unmasked), partition it, attend, unpartition and crop, or attend over the
whole grid; attention on materialized scores, ``(q·scale)·kᵀ`` plus
``add_decomposed_rel_pos`` (the unscaled q against ``rel_pos_h`` and
``rel_pos_w`` gathered at ``q − k + K − 1``), a softmax, the product with
v; the exact GELU; the neck's two convolutions with their channel layer
norms (eps 1e-6).  The control rounds both operands of every product,
convolution and relative-position einsum to float8 e4m3.  A frame at a
time, so a global block's scores (heads × 4096² float32) fit.  Nothing
here imports the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .common import generator, no_tf32, normalize, operand_cast

#: frames of a checked window held against the reference: its first and
#: last, and this many more drawn from the seed
DRAWN_FRAMES = 30


class Tree(dict):
    """The state dict, which remembers the seed it was drawn from (the
    judge draws the frames it checks from it)."""
    seed: int = 0


def _sizes(cfg):
    d, p = int(cfg["hidden_size"]), int(cfg["patch"])
    return (d, p, int(cfg["image_size"]) // p, int(cfg["num_layers"]),
            int(cfg["num_heads"]), int(cfg["mlp_dim"]), int(cfg["out_chans"]),
            int(cfg["window_size"]), set(cfg["global_attn_indexes"]))


def make_tree(cfg, seed: int, device) -> Tree:
    """The encoder's weights from ``seed`` in the published layout (Linear
    weights (out, in)), made on ``device`` in two draws (matrices and
    tables, then vectors), in the configuration's weights dtype: matrices
    normal clipped at 2σ with std ``gain/√fan_in``, ``pos_embed`` std
    ``pos_std``, ``rel_pos_h``/``rel_pos_w`` std ``rel_pos_std``, biases
    and norm offsets uniform in ±``bias``, norm gains 1 ± ``ln``."""
    w_cfg = cfg["weights"]
    dtype = getattr(torch, w_cfg["dtype"])
    d, p, g, depth, heads, m, oc, ws, glob = _sizes(cfg)
    dh = d // heads
    mats = [("patch_embed.proj.weight", (d, 3, p, p), 3 * p * p),
            ("pos_embed", (1, g, g, d), "pos_std")]
    vecs = [("patch_embed.proj.bias", d, "b")]
    for i in range(depth):
        k = g if i in glob else ws
        b = f"blocks.{i}."
        mats += [(b + "attn.qkv.weight", (3 * d, d), d),
                 (b + "attn.proj.weight", (d, d), d),
                 (b + "attn.rel_pos_h", (2 * k - 1, dh), "rel_pos_std"),
                 (b + "attn.rel_pos_w", (2 * k - 1, dh), "rel_pos_std"),
                 (b + "mlp.lin1.weight", (m, d), d),
                 (b + "mlp.lin2.weight", (d, m), m)]
        vecs += [(b + "norm1.weight", d, "g"), (b + "norm1.bias", d, "b"),
                 (b + "attn.qkv.bias", 3 * d, "b"),
                 (b + "attn.proj.bias", d, "b"),
                 (b + "norm2.weight", d, "g"), (b + "norm2.bias", d, "b"),
                 (b + "mlp.lin1.bias", m, "b"), (b + "mlp.lin2.bias", d, "b")]
    mats += [("neck.0.weight", (oc, d, 1, 1), d),
             ("neck.2.weight", (oc, oc, 3, 3), 9 * oc)]
    vecs += [("neck.1.weight", oc, "g"), ("neck.1.bias", oc, "b"),
             ("neck.3.weight", oc, "g"), ("neck.3.bias", oc, "b")]
    sizes = [math.prod(s) for _, s, _ in mats]
    gen = generator(seed, "weights", device)
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2, 2)
    vec = torch.rand(sum(n for _, n, _ in vecs), generator=gen,
                     device=device) * 2 - 1
    gain, bias, ln = (float(w_cfg["gain"]), float(w_cfg["bias"]),
                      float(w_cfg["ln"]))
    tree = Tree()
    tree.seed = int(seed)
    off = 0
    for (name, shape, fan), n in zip(mats, sizes):
        std = float(w_cfg[fan]) if isinstance(fan, str) \
            else gain / math.sqrt(fan)
        tree[name] = (flat[off:off + n].view(shape) * std).to(dtype)
        off += n
    off = 0
    for name, n, kind in vecs:
        v = vec[off:off + n]
        tree[name] = ((1 + ln * v) if kind == "g" else bias * v).to(dtype)
        off += n
    return tree


def _ln(x: torch.Tensor, w, b, eps: float) -> torch.Tensor:
    """``nn.LayerNorm`` over the last dim."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w.float() + b.float()


def _ln2d(x: torch.Tensor, w, b, eps: float) -> torch.Tensor:
    """``LayerNorm2d`` over the channels of NCHW."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return w.float()[:, None, None] * x + b.float()[:, None, None]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor):
    """``get_rel_pos`` for tables of their full length (2·max − 1), as
    the published sizes have them: ``rel_pos[q − k + k_size − 1]``."""
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] \
        * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] \
        * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos.float()[rel.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size,
                           cast):
    q_h, q_w = q_size
    k_h, k_w = k_size
    r_h = get_rel_pos(q_h, k_h, rel_pos_h)
    r_w = get_rel_pos(q_w, k_w, rel_pos_w)
    b, _, dim = q.shape
    r_q = cast(q.reshape(b, q_h, q_w, dim))
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, cast(r_h))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, cast(r_w))
    attn = (attn.view(b, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b, q_h * q_w, k_h * k_w)
    return attn


def window_partition(x: torch.Tensor, window_size: int):
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window_size, window_size, wp // window_size,
               window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window_size, window_size, c)
    return windows, (hp, wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.view(b, hp // window_size, wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w, :].contiguous()
    return x


def _attention(tree, pre: str, x: torch.Tensor, heads: int, cast):
    b, h, w, _ = x.shape
    qkv = cast(x) @ cast(tree[pre + "qkv.weight"].float()).t() \
        + tree[pre + "qkv.bias"].float()
    qkv = qkv.reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
    scale = q.shape[-1] ** -0.5
    attn = cast(q * scale) @ cast(k).transpose(-2, -1)
    attn = add_decomposed_rel_pos(attn, q, tree[pre + "rel_pos_h"],
                                  tree[pre + "rel_pos_w"], (h, w), (h, w),
                                  cast)
    attn = attn.softmax(dim=-1)
    x = (cast(attn) @ cast(v)).view(b, heads, h, w, -1).permute(
        0, 2, 3, 1, 4).reshape(b, h, w, -1)
    return cast(x) @ cast(tree[pre + "proj.weight"].float()).t() \
        + tree[pre + "proj.bias"].float()


def _block(tree, i: int, x: torch.Tensor, cfg, cast) -> torch.Tensor:
    d, p, g, depth, heads, m, oc, ws, glob = _sizes(cfg)
    eps = float(cfg["ln_eps"])
    pre = f"blocks.{i}."
    window_size = 0 if i in glob else ws
    shortcut = x
    x = _ln(x, tree[pre + "norm1.weight"], tree[pre + "norm1.bias"], eps)
    if window_size > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window_size)
    x = _attention(tree, pre + "attn.", x, heads, cast)
    if window_size > 0:
        x = window_unpartition(x, window_size, pad_hw, (h, w))
    x = shortcut + x
    y = _ln(x, tree[pre + "norm2.weight"], tree[pre + "norm2.bias"], eps)
    y = cast(y) @ cast(tree[pre + "mlp.lin1.weight"].float()).t() \
        + tree[pre + "mlp.lin1.bias"].float()
    y = F.gelu(y)
    y = cast(y) @ cast(tree[pre + "mlp.lin2.weight"].float()).t() \
        + tree[pre + "mlp.lin2.bias"].float()
    return x + y


def embed(tree: Tree, x: torch.Tensor, cfg,
          precision: str = "float32") -> torch.Tensor:
    """Normalized NHWC float32 frames → (N, out_chans, G, G) embeddings."""
    cast = operand_cast(precision)
    d, p, g, depth, heads, m, oc, ws, glob = _sizes(cfg)
    eps = float(cfg["ln_eps"])
    x = F.conv2d(cast(x.permute(0, 3, 1, 2)),
                 cast(tree["patch_embed.proj.weight"].float()),
                 tree["patch_embed.proj.bias"].float(), stride=p)
    x = x.permute(0, 2, 3, 1)
    x = x + tree["pos_embed"].float()
    for i in range(depth):
        x = _block(tree, i, x, cfg, cast)
    x = x.permute(0, 3, 1, 2)
    x = F.conv2d(cast(x), cast(tree["neck.0.weight"].float()))
    x = _ln2d(x, tree["neck.1.weight"], tree["neck.1.bias"], eps)
    x = F.conv2d(cast(x), cast(tree["neck.2.weight"].float()), padding=1)
    return _ln2d(x, tree["neck.3.weight"], tree["neck.3.bias"], eps)


def checked_frames(tree: Tree, batch: int) -> List[int]:
    """The frames of a window the judge holds: the first, the last and
    ``DRAWN_FRAMES`` more drawn from the tree's seed (all of a small
    window)."""
    if batch <= DRAWN_FRAMES + 2:
        return list(range(batch))
    g = generator(tree.seed, "check_frames", "cpu")
    drawn = (torch.randperm(batch - 2, generator=g)[:DRAWN_FRAMES] + 1)
    return sorted({0, batch - 1, *drawn.tolist()})


def _embeds(tree, cfg, frames_u8, frames, device, precision):
    norm = cfg["normalize"]
    for f in frames:
        x = normalize(frames_u8[f:f + 1].to(device), norm["sub"], norm["div"])
        yield f, embed(tree, x, cfg, precision)[0]


def judge(tree: Tree, cfg, samples, frames_of, device,
          precision: str = "float32") -> Dict[str, float]:
    """Hold the program's embeddings against the reference.

    ``samples``: dicts with ``embed`` (B, out_chans, G, G) and the
    ``slot`` of the input window, whose uint8 frames ``frames_of(slot)``
    gives.  Returns ``embed_gap``: over the checked frames
    (:func:`checked_frames`), the largest absolute difference between a
    served embedding and the reference's, as a share of the root mean
    square of that frame's reference embedding."""
    no_tf32()
    gap, n = 0.0, 0
    with torch.inference_mode():
        for smp in samples:
            u8 = frames_of(smp["slot"])
            got = smp["embed"]
            for f, ref in _embeds(tree, cfg, u8,
                                  checked_frames(tree, u8.shape[0]), device,
                                  precision):
                rms = ref.pow(2).mean().sqrt()
                err = (got[f].to(device).float() - ref).abs().max()
                gap = max(gap, float(err / rms))
                n += 1
    return {"embed_gap": gap, "frames": float(n)}


def control_outputs(tree: Tree, cfg, frames_u8: torch.Tensor,
                    device) -> Dict[str, torch.Tensor]:
    """The reference computed with fp8 operands, in the program's place:
    one window's embeddings, on the frames the judge checks (the others
    zero)."""
    d, p, g, depth, heads, m, oc, ws, glob = _sizes(cfg)
    out = torch.zeros((frames_u8.shape[0], oc, g, g), device=device)
    with torch.inference_mode():
        for f, e in _embeds(tree, cfg, frames_u8,
                            checked_frames(tree, frames_u8.shape[0]),
                            device, "fp8"):
            out[f] = e
    return {"embed": out}
