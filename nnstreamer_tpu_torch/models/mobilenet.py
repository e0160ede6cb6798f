"""MobileNetV2 in PyTorch: the backbone of the SSD detector.

Counterpart of the JAX package's ``models/mobilenet.py``:

- the numpy init (:func:`mobilenet_v2_init` and its helpers) draws the
  same numbers in the same order as the JAX package, so one seed gives a
  bit-identical parameter tree in the JAX layout (HWIO conv weights);
  ``models/convert.py`` turns such a tree into a module ``state_dict``;
- :class:`ConvBN` (``_conv_bn``), :class:`InvertedResidual`
  (``_inverted_residual``) and :class:`MobileNetV2Backbone`
  (``mobilenet_v2_backbone``) are ``nn.Module``s whose forward takes and
  returns NHWC tensors, as the JAX functions do.  Inside, a convolution
  runs on the NCHW view of the same memory (channels-last strides), so the
  permutes at the boundary move no data on the card.

Inference applies *folded* batch-norm: the scale and offset are computed
in f32 and cast to the compute dtype before the epilogue, in the JAX
package's order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]

_BN_EPS = 1e-3


def _rng_of(key) -> np.random.Generator:
    """Host-side init RNG from an int seed (the JAX package's
    ``_rng_of(jax.random.PRNGKey(s))`` seeds numpy with ``s``)."""
    if isinstance(key, np.random.Generator):
        return key
    return np.random.default_rng(int(key))


# -- numpy init (JAX layout) -------------------------------------------------


def _conv_init(rng: np.random.Generator, kh, kw, cin, cout,
               groups: int = 1) -> Params:
    fan_in = kh * kw * cin // groups
    w = np.clip(rng.standard_normal(
        (kh, kw, cin // groups, cout), dtype=np.float32), -2, 2)
    w = w * np.sqrt(2.0 / max(fan_in, 1), dtype=np.float32)
    return {
        "w": w,
        # batch-norm params (folded at inference)
        "scale": np.ones((cout,), np.float32),
        "bias": np.zeros((cout,), np.float32),
        "mean": np.zeros((cout,), np.float32),
        "var": np.ones((cout,), np.float32),
    }


def _dense_init(rng: np.random.Generator, cin, cout) -> Params:
    w = np.clip(rng.standard_normal((cin, cout), dtype=np.float32), -2, 2)
    return {"w": w * np.sqrt(1.0 / cin, dtype=np.float32),
            "b": np.zeros((cout,), np.float32)}


# (expansion, out_channels, num_repeats, first_stride)
_V2_BLOCKS: List[Tuple[int, int, int, int]] = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def _inverted_residual_init(rng: np.random.Generator, cin, cout,
                            expansion) -> Params:
    mid = cin * expansion
    p: Params = {}
    if expansion != 1:
        p["expand"] = _conv_init(rng, 1, 1, cin, mid)
    p["dw"] = _conv_init(rng, 3, 3, mid, mid, groups=mid)
    p["project"] = _conv_init(rng, 1, 1, mid, cout)
    return p


def mobilenet_v2_init(key, num_classes: int = 1001,
                      width: float = 1.0) -> Params:
    """MobileNetV2 parameter tree in the JAX package's layout, drawn from
    numpy exactly as the JAX package draws it."""
    def ch(c):
        return max(8, int(c * width))

    rng = _rng_of(key)
    params: Params = {"stem": _conv_init(rng, 3, 3, 3, ch(32))}
    cin = ch(32)
    blocks = []
    for t, c, n, s in _V2_BLOCKS:
        for _ in range(n):
            blocks.append(_inverted_residual_init(rng, cin, ch(c), t))
            cin = ch(c)
    params["blocks"] = blocks
    last = max(1280, int(1280 * width))
    params["last"] = _conv_init(rng, 1, 1, cin, last)
    params["head"] = _dense_init(rng, last, num_classes)
    return params


def _v2_strides() -> List[int]:
    out = []
    for _t, _c, n, s in _V2_BLOCKS:
        out.extend([s] + [1] * (n - 1))
    return out


# -- modules -----------------------------------------------------------------


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` for one spatial dim: (before, after).  It
    is asymmetric when the total is odd — at 300, k=3, stride 2 it pads 0
    before and 1 after, which ``nn.Conv2d(padding=1)`` cannot express."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class ConvBN(nn.Module):
    """Convolution + folded batch-norm (+ ReLU6): ``_conv_bn``.

    Parameters: ``weight`` (OIHW; depthwise (C,1,kh,kw)), and the
    batch-norm buffers ``scale``, ``bias``, ``mean``, ``var``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, relu6: bool = True):
        super().__init__()
        self.stride, self.groups, self.relu6, self.k = stride, groups, relu6, k
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("bias", torch.zeros(cout))
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        """``x`` (N,H,W,C) in ``dtype`` → (N,H',W',Cout) in ``dtype``."""
        h = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        ph = same_padding(h.shape[2], self.k, self.stride)
        pw = same_padding(h.shape[3], self.k, self.stride)
        if any(ph + pw):
            h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(h, self.weight.to(dtype), stride=self.stride,
                     groups=self.groups).permute(0, 2, 3, 1)
        r = torch.rsqrt(self.var + _BN_EPS)
        inv = (self.scale * r).to(dtype)
        off = (self.bias - self.mean * self.scale * r).to(dtype)
        y = y * inv + off
        if self.relu6:
            y = torch.clamp(y, 0.0, 6.0)
        return y


class InvertedResidual(nn.Module):
    """MobileNetV2 block: ``_inverted_residual``."""

    def __init__(self, cin: int, cout: int, expansion: int, stride: int):
        super().__init__()
        mid = cin * expansion
        self.stride = stride
        self.expand = ConvBN(cin, mid, 1) if expansion != 1 else None
        self.dw = ConvBN(mid, mid, 3, stride=stride, groups=mid)
        self.project = ConvBN(mid, cout, 1, relu6=False)

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        h = x
        if self.expand is not None:
            h = self.expand(h, dtype)
        h = self.dw(h, dtype)
        h = self.project(h, dtype)
        if self.stride == 1 and x.shape[-1] == h.shape[-1]:
            h = h + x  # residual
        return h


class MobileNetV2Backbone(nn.Module):
    """Stem + inverted-residual blocks: ``mobilenet_v2_backbone``."""

    def __init__(self, width: float = 1.0):
        super().__init__()

        def ch(c):
            return max(8, int(c * width))

        self.stem = ConvBN(3, ch(32), 3, stride=2)
        blocks, cin = [], ch(32)
        for (t, c, n, _s), stride in zip(
                [b for b in _V2_BLOCKS for _ in range(b[2])], _v2_strides()):
            blocks.append(InvertedResidual(cin, ch(c), t, stride))
            cin = ch(c)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16,
                taps: Sequence[int] = ()) -> Tuple[torch.Tensor,
                                                   List[torch.Tensor]]:
        """``x`` (N,H,W,3) → (final feature map, [outputs of the blocks
        listed in ``taps``]), NHWC."""
        x = self.stem(x.to(dtype), dtype)
        tapped = []
        for i, block in enumerate(self.blocks):
            x = block(x, dtype)
            if i in taps:
                tapped.append(x)
        return x, tapped
