"""Vision Transformer in PyTorch: the classification model of the ViT path.

Counterpart of the JAX package's ``models/vit.py``, with its names and
its public layout: an NHWC image in, ``(B, num_classes)`` f32 logits out,
bf16 compute with f32 weights cast per call.  The attention and the layer
norm run on hand-written kernels (``ops.flash_attention`` and
``ops.layer_norm``, bound once as this module's names); PyTorch's own
fused attention and layer norm are not used.

Where the JAX code rounds, this code rounds too:

- ``_dense`` is ``x @ w + b`` in two steps, each rounded to the compute
  type (``F.linear`` with a bias would round once);
- ``_ln`` computes in f32 with the population variance and eps 1e-6,
  applies g and b in f32, then casts back (``nn.LayerNorm`` would use
  eps 1e-5): ``ops.layer_norm``, one kernel on the card that reads and
  writes each row once in the compute type, its plain version on the
  CPU;
- ``jax.nn.gelu`` is the tanh approximation;
- the patch embed is a VALID convolution with stride = patch (HWIO
  weights in the JAX tree, OIHW here), then the bias and ``pos`` are
  added in the compute type;
- the head is an f32 product of the bf16 pooled features.

Each layer runs under an ``nns:vit:<layer>`` span (``embed``, ``ln``,
``attn``, ``gelu``, ``residual``, ``head``), and each dense product's
weight casts, product and bias add under ``nns:dense:weights``,
``nns:dense:gemm`` and ``nns:dense:bias``, so a profiler trace puts
every kernel of the step under its layer (``utils/profile.py``).

``vit_init`` draws the JAX package's shapes and scales from a numpy seed
(the bits differ from ``jax.random``'s); ``models/convert.py`` carries a
JAX parameter tree across.  ``vit_tree_apply`` is the ``apply`` of a ViT
weights file (``models/params_io.py``): it runs the JAX-layout tree the
file holds, building its module once per tree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import flash_attention, layer_norm
from ..utils.profile import span

Params = Dict[str, Any]

_LN_EPS = 1e-6


class Dense(nn.Module):
    """``_dense``: ``w`` (din, dout) as in the JAX tree, ``b`` (dout,).
    The product runs in the promotion of ``x``'s type and ``dtype``, as
    JAX promotes ``x @ w.astype(dtype)``: bf16 features into an f32 head
    give an f32 product."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(din, dout))
        self.b = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, dtype)
        with span("dense", "weights"):
            w, b = self.w.to(ct), self.b.to(ct)
        with span("dense", "gemm"):
            y = x.to(ct) @ w
        del w  # freed before the bias add, as in one expression
        with span("dense", "bias"):
            return y + b


class LayerNorm(nn.Module):
    """``_ln``: f32 statistics (population variance), eps 1e-6, through
    ``ops.layer_norm``."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("vit", "ln"):
            return layer_norm(x, self.g, self.b, _LN_EPS)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, D) → (B, H, S, D/H) as a view: for a third of the qkv
    projection, strides (S·3D, D/H, 3D, 1), which the kernel reads as
    they are."""
    B, S, D = t.shape
    return t.reshape(B, S, heads, D // heads).transpose(1, 2)


class Block(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.qkv = Dense(dim, dim * 3)
        self.proj = Dense(dim, dim)
        self.ln2 = LayerNorm(dim)
        self.mlp1 = Dense(dim, mlp_dim)
        self.mlp2 = Dense(mlp_dim, dim)

    def attention(self, x: torch.Tensor, heads: int,
                  dtype: torch.dtype) -> torch.Tensor:
        """``_attention``: q, k, v are contiguous thirds of the qkv
        projection, heads split as (B, S, H, dh) → (B, H, S, dh).  The
        kernel takes those views without a copy and writes o in (B, S, H,
        dh) order, so on the card the reshape back to (B, S, D) is a view
        too."""
        B, S, D = x.shape
        q, k, v = self.qkv(x, dtype).split(D, dim=-1)
        with span("vit", "attn"):
            o = flash_attention(*(_split_heads(t, heads) for t in (q, k, v)))
            o = o.transpose(1, 2).reshape(B, S, D)
        return self.proj(o, dtype)

    def forward(self, x: torch.Tensor, heads: int,
                dtype: torch.dtype) -> torch.Tensor:
        a = self.attention(self.ln1(x), heads, dtype)
        with span("vit", "residual"):
            x = x + a
        h = self.mlp1(self.ln2(x), dtype)
        with span("vit", "gelu"):
            h = gelu(h)
        m = self.mlp2(h, dtype)
        with span("vit", "residual"):
            return x + m


class ViT(nn.Module):
    """The JAX package's ViT as a module; ``heads`` is fixed at
    construction (the JAX code passes it per call)."""

    def __init__(self, image_size: int = 224, patch: int = 16,
                 dim: int = 256, depth: int = 6, heads: int = 2,
                 mlp_dim: int = 512, num_classes: int = 1000):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.patch, self.heads = patch, heads
        n_patches = (image_size // patch) ** 2
        self.embed_w = nn.Parameter(torch.zeros(dim, 3, patch, patch))  # OIHW
        self.embed_b = nn.Parameter(torch.zeros(dim))
        self.pos = nn.Parameter(torch.zeros(n_patches, dim))
        self.blocks = nn.ModuleList(Block(dim, mlp_dim) for _ in range(depth))
        self.ln_f = LayerNorm(dim)
        self.head = Dense(dim, num_classes)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """(B, H, W, 3) image → (B, num_classes) f32 logits."""
        with span("vit", "embed"):
            x = x.to(dtype)
            h = F.conv2d(x.permute(0, 3, 1, 2), self.embed_w.to(dtype),
                         stride=self.patch).permute(0, 2, 3, 1)
            B, ph, pw, D = h.shape
            h = h.reshape(B, ph * pw, D) + self.embed_b.to(dtype)
            h = h + self.pos.to(dtype)
        for block in self.blocks:
            h = block(h, self.heads, dtype)
        h = self.ln_f(h)
        with span("vit", "head"):
            h = h.mean(dim=1)                               # global pool
            return self.head(h, torch.float32).to(torch.float32)


def _dense_tree(rng: np.random.Generator, din: int, dout: int) -> Params:
    w = rng.standard_normal((din, dout), dtype=np.float32)
    return {"w": w * np.sqrt(2.0 / din, dtype=np.float32),
            "b": np.zeros((dout,), np.float32)}


def _ln_tree(dim: int) -> Params:
    return {"g": np.ones((dim,), np.float32),
            "b": np.zeros((dim,), np.float32)}


def vit_tree(seed: int, image_size: int = 224, patch: int = 16,
             dim: int = 256, depth: int = 6, mlp_dim: int = 512,
             num_classes: int = 1000) -> Params:
    """A ViT parameter tree in the JAX package's layout (numpy leaves),
    with its shapes and scales, drawn from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n_patches = (image_size // patch) ** 2
    embed = rng.standard_normal((patch, patch, 3, dim), dtype=np.float32)
    pos = rng.standard_normal((n_patches, dim), dtype=np.float32)
    tree: Params = {
        "embed": {"w": embed * np.sqrt(2.0 / (patch ** 2 * 3),
                                       dtype=np.float32),
                  "b": np.zeros((dim,), np.float32)},
        "pos": pos * np.float32(0.02),
        "blocks": [],
        "head": _dense_tree(rng, dim, num_classes),
        "ln_f": _ln_tree(dim),
    }
    for _ in range(depth):
        tree["blocks"].append({
            "ln1": _ln_tree(dim),
            "qkv": _dense_tree(rng, dim, dim * 3),
            "proj": _dense_tree(rng, dim, dim),
            "ln2": _ln_tree(dim),
            "mlp1": _dense_tree(rng, dim, mlp_dim),
            "mlp2": _dense_tree(rng, mlp_dim, dim),
        })
    return tree


def vit_init(seed: int = 0, image_size: int = 224, patch: int = 16,
             dim: int = 256, depth: int = 6, heads: int = 2,
             mlp_dim: int = 512, num_classes: int = 1000) -> ViT:
    """A :class:`ViT` (on the CPU, eval mode) with weights from
    :func:`vit_tree`."""
    from .convert import vit_from_jax

    return vit_from_jax(vit_tree(seed, image_size, patch, dim, depth,
                                 mlp_dim, num_classes), heads)


def vit_apply(model: ViT, x: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, H, W, 3) image → (B, num_classes) f32 logits; compute in
    ``dtype`` (bf16 by default)."""
    return model(x, torch.bfloat16 if dtype is None else dtype)


def _vit_of_tree(tree: Params, heads: int) -> ViT:
    """The :class:`ViT` of a JAX-layout tree, built on the tree's own
    tensors and kept per (tree, heads) (``convert._module_of_tree``), so
    a model file's tree builds its module once."""
    from .convert import _module_of_tree, vit_from_jax

    return _module_of_tree(tree, vit_from_jax, int(heads))


def vit_tree_apply(tree: Params, x: torch.Tensor, heads: int = 2,
                   dtype: Any = None) -> torch.Tensor:
    """``apply`` of a ViT weights file: ``tree`` is the JAX package's ViT
    tree (numpy or tensor leaves), which does not hold ``heads``; the
    file binds it (and ``dtype``, a torch dtype or its name) through its
    ``apply_kwargs``.  ``heads=2`` is the JAX package's default."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return vit_apply(_vit_of_tree(tree, heads), x, dtype)


def register_vit(name: str = "vit_s16", batch: int = 1,
                 image_size: int = 224, num_classes: int = 1000,
                 heads: int = 2, seed: int = 0, **kw) -> str:
    """Register a ViT for ``tensor_filter framework=torch-cuda
    model=<name>``: f32 NHWC input of ``(batch, image_size, image_size,
    3)``, bf16 compute with the f32 weights cast per call."""
    from ..filters import register_model

    model = vit_init(seed, image_size=image_size, num_classes=num_classes,
                     heads=heads, **kw)
    return register_model(
        name, vit_apply, params=model,
        in_shapes=[(batch, image_size, image_size, 3)],
        in_dtypes=np.float32)
