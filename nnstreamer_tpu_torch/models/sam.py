"""SAM's image encoder in PyTorch: the ViTDet backbone of Segment Anything
(Kirillov et al., arXiv:2304.02643; ``segment_anything/modeling/
image_encoder.py``), an NHWC image in, its ``(B, out_chans, H/p, W/p)``
f32 embedding out, bf16 compute with f32 weights cast per call.

The blocks are the ViT's parts (``models/vit.py`` ``Dense`` and
``LayerNorm``, so the same ``nns:dense:*`` and ``nns:vit:ln`` spans and
the same ``layer_norm`` kernel) arranged as SAM arranges them:

- a patch embedding (a convolution with stride = patch, with bias) plus a
  learned absolute position embedding of (1, H/p, W/p, dim);
- blocks that attend inside windows of ``window`` x ``window`` tokens: the
  token grid is zero-padded after ``norm1`` to a multiple of the window
  and partitioned, and the padded tokens are not masked (their keys take
  part in the softmax); the blocks of ``global_attn_indexes`` attend over
  the whole grid;
- every attention adds SAM's decomposed relative position to its scores,
  ``rel_h[i, j // Kw] + rel_w[i, j % Kw]``, where ``rel_h`` is the
  unscaled query against ``rel_pos_h[q_row - k_row + K - 1]`` (and
  ``rel_w`` alike): the two tables are bf16 products cast to f32, and
  ``ops.flash_attention`` adds them on its score tiles, so no (S, Sk) bias
  is made;
- the MLP's GELU is the exact (erf) one, layer norms use eps 1e-6;
- a neck: a 1x1 convolution (a product, no bias), a channel layer norm
  (rows of NHWC, so ``layer_norm``), a 3x3 convolution (no bias), a
  channel layer norm.

Spans (``utils/profile.span``): ``nns:sam:embed``, ``nns:sam:window`` (pad,
partition, unpartition and crop), ``nns:sam:relpos`` (the table gather
and the two products), ``nns:sam:attn_window`` and ``nns:sam:attn_global``
(the ``flash_attention`` call alone), ``nns:sam:gelu``,
``nns:sam:residual`` and ``nns:sam:neck``, besides the shared ones, so a
profiler trace puts every kernel of the step under its layer.

:func:`sam_from_state_dict` takes the published checkpoint's key layout
(``patch_embed.proj.weight``, ``pos_embed``, ``blocks.{i}.attn.qkv.weight``,
``blocks.{i}.attn.rel_pos_h``, ``neck.{0,1,2,3}.*``; Linear weights (out,
in); an ``image_encoder.`` prefix is dropped) and reads every size from
the shapes.  :func:`register_sam` serves a model of random weights for
``tensor_filter framework=torch-cuda model=<name>``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import flash_attention
from ..utils.profile import span
from .vit import Dense, LayerNorm, _split_heads

StateDict = Dict[str, torch.Tensor]

PREFIX = "image_encoder."


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous f32 tensor, in one pass."""
    return torch.empty(t.shape, dtype=torch.float32,
                       device=t.device).copy_(t)


def rel_tables(q: torch.Tensor, rel_pos_h: torch.Tensor,
               rel_pos_w: torch.Tensor, grid: int):
    """SAM's ``add_decomposed_rel_pos`` terms for queries and keys on one
    ``grid`` x ``grid`` token grid: q (N, H, grid², dh) → rel_h and rel_w,
    contiguous f32 (N, H, grid², grid), from products in q's type."""
    idx = torch.arange(grid, device=q.device)
    idx = idx[:, None] - idx[None, :] + (grid - 1)
    r_h = rel_pos_h.to(q.dtype)[idx]                  # (q row, k row, dh)
    r_w = rel_pos_w.to(q.dtype)[idx]                  # (q col, k col, dh)
    q5 = q.unflatten(2, (grid, grid))
    rel_h = _f32(torch.einsum("nhywc,ykc->nhywk", q5, r_h))
    rel_w = _f32(torch.einsum("nhywc,wkc->nhywk", q5, r_w))
    return rel_h.flatten(2, 3), rel_w.flatten(2, 3)


class Attention(nn.Module):
    """Multi-head attention over the tokens of one ``grid`` x ``grid``
    grid (a window, or the whole image), with qkv bias and the decomposed
    relative position; ``rel_pos_h``/``rel_pos_w`` (2·grid − 1, dh) are
    shared by the heads."""

    def __init__(self, dim: int, heads: int, grid: int):
        super().__init__()
        self.heads, self.grid = heads, grid
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * grid - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * grid - 1, dim // heads))

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                where: str) -> torch.Tensor:
        """x (N, grid², dim) → (N, grid², dim); ``where`` names the
        attention's span (``attn_window`` or ``attn_global``)."""
        n, s, d = x.shape
        q, k, v = (_split_heads(t, self.heads)
                   for t in self.qkv(x, dtype).split(d, dim=-1))
        with span("sam", "relpos"):
            rel_h, rel_w = rel_tables(q, self.rel_pos_h, self.rel_pos_w,
                                      self.grid)
        with span("sam", where):
            o = flash_attention(q, k, v, rel_h=rel_h, rel_w=rel_w,
                                key_grid=(self.grid, self.grid))
        del rel_h, rel_w
        # on the card o is a (N, S, H, dh) buffer: a view back to (N, S, D)
        return self.proj(o.transpose(1, 2).reshape(n, s, d), dtype)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, Hg, Wg, C) → (B·nH·nW, window², C), the grid zero-padded to a
    multiple of ``window`` first."""
    b, hg, wg, c = x.shape
    ph, pw = (-hg) % window, (-wg) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    nh, nw = (hg + ph) // window, (wg + pw) // window
    x = x.view(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, window * window, c)


def window_unpartition(x: torch.Tensor, window: int, hg: int,
                       wg: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`: (B·nH·nW, window², C) →
    (B, Hg, Wg, C), the padding cropped (a view of the padded grid)."""
    nh, nw = -(-hg // window), -(-wg // window)
    c = x.shape[-1]
    x = x.view(-1, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(-1, nh * window, nw * window, c)
    return x[:, :hg, :wg]


class Block(nn.Module):
    """A pre-norm transformer block; ``window`` 0 attends globally over
    the ``grid`` x ``grid`` image tokens."""

    def __init__(self, dim: int, mlp_dim: int, heads: int, window: int,
                 grid: int):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads, window or grid)
        self.norm2 = LayerNorm(dim)
        self.mlp1 = Dense(dim, mlp_dim)
        self.mlp2 = Dense(mlp_dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, hg, wg, d = x.shape
        h = self.norm1(x)
        if self.window:
            with span("sam", "window"):
                h = window_partition(h, self.window)
            h = self.attn(h, dtype, "attn_window")
            with span("sam", "window"):
                h = window_unpartition(h, self.window, hg, wg)
        else:
            h = self.attn(h.view(b, hg * wg, d), dtype, "attn_global")
            h = h.view(b, hg, wg, d)
        with span("sam", "residual"):
            x = x + h
        del h
        m = self.mlp1(self.norm2(x), dtype)
        with span("sam", "gelu"):
            m = F.gelu(m)
        m = self.mlp2(m, dtype)
        with span("sam", "residual"):
            return x + m


class SamImageEncoder(nn.Module):
    """SAM's ``ImageEncoderViT`` (``use_abs_pos``, ``use_rel_pos``,
    ``qkv_bias``), published sizes as defaults (ViT-L); ``window`` 0
    makes every block global."""

    def __init__(self, image_size: int = 1024, patch: int = 16,
                 dim: int = 1024, depth: int = 24, heads: int = 16,
                 mlp_dim: int = 4096, out_chans: int = 256,
                 window: int = 14,
                 global_attn_indexes: Sequence[int] = (5, 11, 17, 23)):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        grid = image_size // patch
        self.patch, self.grid = patch, grid
        self.patch_w = nn.Parameter(torch.zeros(dim, 3, patch, patch))  # OIHW
        self.patch_b = nn.Parameter(torch.zeros(dim))
        self.pos = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList(
            Block(dim, mlp_dim, heads,
                  0 if i in set(global_attn_indexes) else window, grid)
            for i in range(depth))
        self.neck_w1 = nn.Parameter(torch.zeros(dim, out_chans))   # (in, out)
        self.neck_ln1 = LayerNorm(out_chans)
        self.neck_w2 = nn.Parameter(torch.zeros(out_chans, out_chans, 3, 3))
        self.neck_ln2 = LayerNorm(out_chans)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """(B, H, W, 3) image → (B, out_chans, H/p, W/p) f32 embedding."""
        with span("sam", "embed"):
            x = F.conv2d(x.to(dtype).permute(0, 3, 1, 2),
                         self.patch_w.to(dtype), self.patch_b.to(dtype),
                         stride=self.patch)
            x = (x.permute(0, 2, 3, 1) + self.pos.to(dtype)).contiguous()
        for block in self.blocks:
            x = block(x, dtype)
        with span("sam", "neck"):
            n = self.neck_ln1(x @ self.neck_w1.to(dtype))
            n = F.conv2d(n.permute(0, 3, 1, 2), self.neck_w2.to(dtype),
                         padding=1)
            n = self.neck_ln2(n.permute(0, 2, 3, 1).contiguous())
            return n.permute(0, 3, 1, 2).to(
                torch.float32, memory_format=torch.contiguous_format)


def sam_apply(model: SamImageEncoder, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, H, W, 3) normalized image → (B, out_chans, H/p, W/p) f32
    embedding; compute in ``dtype`` (bf16 by default)."""
    return model(x, torch.bfloat16 if dtype is None else dtype)


def _strip(sd: StateDict) -> StateDict:
    """The encoder's keys of a state dict, ``image_encoder.`` dropped
    where every key of the encoder carries it (a whole SAM checkpoint)."""
    if any(k.startswith(PREFIX) for k in sd):
        return {k[len(PREFIX):]: v for k, v in sd.items()
                if k.startswith(PREFIX)}
    return dict(sd)


def sam_from_state_dict(sd: StateDict) -> SamImageEncoder:
    """A :class:`SamImageEncoder` (eval mode) holding the weights of a
    state dict in the published layout (Linear weights (out, in), the
    neck's convolutions as ``neck.0`` and ``neck.2``, its norms as
    ``neck.1`` and ``neck.3``).  Every size comes from the shapes: the
    head dim from ``rel_pos_h``'s width, each block's window from its
    length (2·window − 1), a block whose window spans the grid attending
    globally.  Tensors keep their device and dtype (products are
    transposed into contiguous (in, out) copies)."""
    from .convert import _assign

    sd = _strip(sd)
    dim, _, patch, _ = sd["patch_embed.proj.weight"].shape
    grid = sd["pos_embed"].shape[1]
    depth = 0
    while f"blocks.{depth}.norm1.weight" in sd:
        depth += 1
    windows = [(sd[f"blocks.{i}.attn.rel_pos_h"].shape[0] + 1) // 2
               for i in range(depth)]
    local = [w for w in windows if w != grid]
    window = local[0] if local else 0
    if any(w != window for w in local):
        raise ValueError(f"blocks with windows {sorted(set(local))}: one "
                         "window size is supported")
    head_dim = sd["blocks.0.attn.rel_pos_h"].shape[1] if depth else dim
    mlp_dim = sd["blocks.0.mlp.lin1.weight"].shape[0] if depth else 1
    out_chans = sd["neck.0.weight"].shape[0]

    def lin(key: str) -> torch.Tensor:
        return sd[key].t().contiguous()

    out = {"patch_w": sd["patch_embed.proj.weight"],
           "patch_b": sd["patch_embed.proj.bias"], "pos": sd["pos_embed"],
           "neck_w1": sd["neck.0.weight"][:, :, 0, 0].t().contiguous(),
           "neck_ln1.g": sd["neck.1.weight"], "neck_ln1.b": sd["neck.1.bias"],
           "neck_w2": sd["neck.2.weight"],
           "neck_ln2.g": sd["neck.3.weight"], "neck_ln2.b": sd["neck.3.bias"]}
    for i in range(depth):
        src, dst = f"blocks.{i}.", f"blocks.{i}."
        for a, b in (("norm1", "norm1"), ("norm2", "norm2")):
            out[f"{dst}{b}.g"] = sd[f"{src}{a}.weight"]
            out[f"{dst}{b}.b"] = sd[f"{src}{a}.bias"]
        for a, b in (("attn.qkv", "attn.qkv"), ("attn.proj", "attn.proj"),
                     ("mlp.lin1", "mlp1"), ("mlp.lin2", "mlp2")):
            out[f"{dst}{b}.w"] = lin(f"{src}{a}.weight")
            out[f"{dst}{b}.b"] = sd[f"{src}{a}.bias"]
        for t in ("rel_pos_h", "rel_pos_w"):
            out[f"{dst}attn.{t}"] = sd[f"{src}attn.{t}"]
    return _assign(
        lambda: SamImageEncoder(
            image_size=grid * patch, patch=patch, dim=dim, depth=depth,
            heads=dim // head_dim, mlp_dim=mlp_dim, out_chans=out_chans,
            window=window,
            global_attn_indexes=[i for i, w in enumerate(windows)
                                 if w == grid]), out)


def sam_state_dict(seed: int = 0, image_size: int = 1024, patch: int = 16,
                   dim: int = 1024, depth: int = 24, heads: int = 16,
                   mlp_dim: int = 4096, out_chans: int = 256,
                   window: int = 14,
                   global_attn_indexes: Sequence[int] = (5, 11, 17, 23)
                   ) -> Dict[str, torch.Tensor]:
    """A random encoder in the published key layout (f32, on the CPU),
    drawn from ``np.random.default_rng(seed)``: products normal with std
    1/√fan_in, ``pos_embed`` std 0.02, the relative-position tables std
    1/√head_dim (so each bias term moves the scores about as much as
    q·kᵀ·scale), biases zero, norms unit."""
    rng = np.random.default_rng(seed)
    grid, dh = image_size // patch, dim // heads

    def normal(shape, std):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    def linear(prefix, din, dout):
        sd[prefix + ".weight"] = normal((dout, din), din ** -0.5)
        sd[prefix + ".bias"] = torch.zeros(dout)

    def norm(prefix, n):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = (torch.ones(n),
                                                        torch.zeros(n))

    sd: Dict[str, torch.Tensor] = {
        "patch_embed.proj.weight": normal((dim, 3, patch, patch),
                                          (3 * patch * patch) ** -0.5),
        "patch_embed.proj.bias": torch.zeros(dim),
        "pos_embed": normal((1, grid, grid, dim), 0.02)}
    for i in range(depth):
        k = grid if i in set(global_attn_indexes) else window
        p = f"blocks.{i}."
        norm(p + "norm1", dim)
        linear(p + "attn.qkv", dim, 3 * dim)
        linear(p + "attn.proj", dim, dim)
        sd[p + "attn.rel_pos_h"] = normal((2 * k - 1, dh), dh ** -0.5)
        sd[p + "attn.rel_pos_w"] = normal((2 * k - 1, dh), dh ** -0.5)
        norm(p + "norm2", dim)
        linear(p + "mlp.lin1", dim, mlp_dim)
        linear(p + "mlp.lin2", mlp_dim, dim)
    sd["neck.0.weight"] = normal((out_chans, dim, 1, 1), dim ** -0.5)
    norm("neck.1", out_chans)
    sd["neck.2.weight"] = normal((out_chans, out_chans, 3, 3),
                                 (9 * out_chans) ** -0.5)
    norm("neck.3", out_chans)
    return sd


def register_sam(name: str = "sam_vit_l", batch: int = 1,
                 image_size: int = 1024, seed: int = 0, **kw) -> str:
    """Register a SAM image encoder of random weights
    (:func:`sam_state_dict`; ViT-L's sizes unless ``kw`` says otherwise)
    for ``tensor_filter framework=torch-cuda model=<name>``: f32 NHWC
    input of ``(batch, image_size, image_size, 3)``, bf16 compute with the
    f32 weights cast per call, the f32 embedding out."""
    from ..filters import register_model

    model = sam_from_state_dict(sam_state_dict(seed, image_size, **kw))
    return register_model(
        name, sam_apply, params=model,
        in_shapes=[(batch, image_size, image_size, 3)],
        in_dtypes=np.float32)
