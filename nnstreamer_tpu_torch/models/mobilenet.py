"""MobileNetV1 and MobileNetV2 in PyTorch: the classifiers, and the V2
backbone of the SSD detector.

Counterpart of the JAX package's ``models/mobilenet.py``:

- the numpy init (:func:`mobilenet_v1_init`, :func:`mobilenet_v2_init`
  and their helpers) draws the
  same numbers in the same order as the JAX package, so one seed gives a
  bit-identical parameter tree in the JAX layout (HWIO conv weights);
  ``models/convert.py`` turns such a tree into a module ``state_dict``;
- :class:`ConvBN` (``_conv_bn``), :class:`InvertedResidual`
  (``_inverted_residual``) and :class:`MobileNetV2Backbone`
  (``mobilenet_v2_backbone``) are ``nn.Module``s whose forward takes and
  returns NHWC tensors, as the JAX functions do; :class:`MobileNetV1`
  (``mobilenet_v1_apply``) and :class:`MobileNetV2` (``mobilenet_v2_apply``)
  end in the global mean and the dense head, f32 logits out.  Inside, a
  convolution
  runs on the NCHW view of the same memory (channels-last strides), so the
  permutes at the boundary move no data on the card.

Inference applies *folded* batch-norm: the scale and offset are computed
in f32 and cast to the compute dtype before the epilogue, in the JAX
package's order.  With ``train=True`` (the trainer's forward) the
statistics are the batch's instead of the ``mean``/``var`` leaves: the
mean and population variance of the convolution's output over (N, H, W),
taken in f32, as the JAX ``_conv_bn`` takes them; the stored leaves are
left alone.  Weights may sit in bf16 (``params_io.weights_to_bf16``):
the per-call ``.to(dtype)`` is then a no-op at bf16 compute, while the
batch-norm buffers stay f32.  ``jnp.mean`` over bf16 sums in f32 and
rounds once, and so does :func:`_mean_hw`.  The head is ``_dense``'s two
bf16 roundings (``vit.Dense``).

:func:`register_mobilenet` registers a seeded classifier with the
``torch-cuda`` filter, as the JAX package's does with ``jax-xla``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .vit import Dense

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


# -- MobileNetV1 ---------------------------------------------------------------

# (stride, out_channels) per depthwise-separable block.
_V1_BLOCKS: List[Tuple[int, int]] = [
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
    (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
    (2, 1024), (1, 1024),
]


def _ch_fn(width: float):
    def ch(c):
        return max(8, int(c * width))

    return ch


def mobilenet_v1_init(key, num_classes: int = 1001,
                      width: float = 1.0) -> Params:
    """MobileNetV1 parameter tree in the JAX package's layout, drawn from
    numpy exactly as the JAX package draws it."""
    ch = _ch_fn(width)
    rng = _rng_of(key)
    params: Params = {"stem": _conv_init(rng, 3, 3, 3, ch(32))}
    cin = ch(32)
    blocks = []
    for _stride, cout in _V1_BLOCKS:
        cout = ch(cout)
        blocks.append({
            "dw": _conv_init(rng, 3, 3, cin, cin, groups=cin),
            "pw": _conv_init(rng, 1, 1, cin, cout),
        })
        cin = cout
    params["blocks"] = blocks
    params["head"] = _dense_init(rng, cin, num_classes)
    return params


# -- MobileNetV2 ---------------------------------------------------------------

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
    ch = _ch_fn(width)
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
    before and 1 after, which ``nn.Conv2d(padding=1)`` cannot express.
    ``size`` is taken as a plain int: a traced module
    (``trace_classifier``) then holds the pad amounts as constants; traced
    shape arithmetic made the TorchScript executor read each amount back
    from the card, a device→host copy and a wait each."""
    size = int(size)
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

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16,
                train: bool = False) -> torch.Tensor:
        """``x`` (N,H,W,C) in ``dtype`` → (N,H',W',Cout) in ``dtype``;
        ``train`` normalizes by the batch's statistics."""
        h = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        ph = same_padding(h.shape[2], self.k, self.stride)
        pw = same_padding(h.shape[3], self.k, self.stride)
        if any(ph + pw):
            h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(h, self.weight.to(dtype), stride=self.stride,
                     groups=self.groups).permute(0, 2, 3, 1)
        if train:
            y32 = y.to(torch.float32)
            mean = y32.mean(dim=(0, 1, 2))
            var = y32.var(dim=(0, 1, 2), unbiased=False)
        else:
            mean, var = self.mean, self.var
        r = torch.rsqrt(var + _BN_EPS)
        inv = (self.scale * r).to(dtype)
        off = (self.bias - mean * self.scale * r).to(dtype)
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

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16,
                train: bool = False) -> torch.Tensor:
        h = x
        if self.expand is not None:
            h = self.expand(h, dtype, train)
        h = self.dw(h, dtype, train)
        h = self.project(h, dtype, train)
        if self.stride == 1 and x.shape[-1] == h.shape[-1]:
            h = h + x  # residual
        return h


class MobileNetV2Backbone(nn.Module):
    """Stem + inverted-residual blocks: ``mobilenet_v2_backbone``."""

    def __init__(self, width: float = 1.0):
        super().__init__()
        ch = _ch_fn(width)
        self.stem = ConvBN(3, ch(32), 3, stride=2)
        blocks, cin = [], ch(32)
        for (t, c, n, _s), stride in zip(
                [b for b in _V2_BLOCKS for _ in range(b[2])], _v2_strides()):
            blocks.append(InvertedResidual(cin, ch(c), t, stride))
            cin = ch(c)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16,
                taps: Sequence[int] = (), train: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``x`` (N,H,W,3) → (final feature map, [outputs of the blocks
        listed in ``taps``]), NHWC."""
        x = self.stem(x.to(dtype), dtype, train)
        tapped = []
        for i, block in enumerate(self.blocks):
            x = block(x, dtype, train)
            if i in taps:
                tapped.append(x)
        return x, tapped


def _mean_hw(x: torch.Tensor) -> torch.Tensor:
    """Global average pool over H and W of an NHWC tensor: ``jnp.mean``
    over bf16 sums in f32 and rounds once, and so does this."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


class DepthwiseSeparable(nn.Module):
    """MobileNetV1 block: depthwise 3x3 (``dw``), then pointwise 1x1
    (``pw``), each a ConvBN with ReLU6."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.dw = ConvBN(cin, cin, 3, stride=stride, groups=cin)
        self.pw = ConvBN(cin, cout, 1)

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16,
                train: bool = False) -> torch.Tensor:
        return self.pw(self.dw(x, dtype, train), dtype, train)


class MobileNetV1(nn.Module):
    """``mobilenet_v1_apply``: stem, 13 depthwise-separable blocks, global
    mean, dense head; NHWC in, (N, num_classes) f32 logits out."""

    def __init__(self, num_classes: int = 1001, width: float = 1.0):
        super().__init__()
        ch = _ch_fn(width)
        self.stem = ConvBN(3, ch(32), 3, stride=2)
        blocks, cin = [], ch(32)
        for stride, cout in _V1_BLOCKS:
            blocks.append(DepthwiseSeparable(cin, ch(cout), stride))
            cin = ch(cout)
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16,
                train: bool = False) -> torch.Tensor:
        x = self.stem(x.to(dtype), dtype, train)
        for block in self.blocks:
            x = block(x, dtype, train)
        return self.head(_mean_hw(x), dtype).to(torch.float32)


class MobileNetV2(MobileNetV2Backbone):
    """``mobilenet_v2_apply``: the backbone, the ``last`` 1x1 ConvBN,
    global mean, dense head; (N, num_classes) f32 logits out."""

    def __init__(self, num_classes: int = 1001, width: float = 1.0):
        super().__init__(width)
        last = max(1280, int(1280 * width))
        self.last = ConvBN(_ch_fn(width)(320), last, 1)
        self.head = Dense(last, num_classes)

    def forward(self, x: torch.Tensor,  # type: ignore[override]
                dtype=torch.bfloat16, train: bool = False) -> torch.Tensor:
        x, _ = super().forward(x, dtype, train=train)
        x = self.last(x, dtype, train)
        return self.head(_mean_hw(x), dtype).to(torch.float32)


def mobilenet_v1_apply(model: MobileNetV1, x: torch.Tensor,
                       dtype=None, train: bool = False) -> torch.Tensor:
    """(N, H, W, 3) → (N, num_classes) f32 logits; compute in ``dtype``
    (bf16 by default); ``train`` takes the batch's statistics."""
    return model(x, torch.bfloat16 if dtype is None else dtype, train)


def mobilenet_v2_apply(model: MobileNetV2, x: torch.Tensor,
                       dtype=None, train: bool = False) -> torch.Tensor:
    """(N, H, W, 3) → (N, num_classes) f32 logits; compute in ``dtype``
    (bf16 by default); ``train`` takes the batch's statistics."""
    return model(x, torch.bfloat16 if dtype is None else dtype, train)


class _ComputeIn(nn.Module):
    """A classifier's forward with its compute dtype bound, for tracing."""

    def __init__(self, model: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.model, self.dtype = model, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, self.dtype)


def trace_classifier(model: nn.Module, shape: Sequence[int],
                     dtype=None) -> torch.jit.ScriptModule:
    """A MobileNet classifier traced to TorchScript — the file the
    ``pytorch`` filter loads — at an NHWC float32 input of ``shape`` on
    the model's device, computing in ``dtype`` (bf16 by default).  The
    trace fixes the input shape (the convolutions' padding is computed
    from it)."""
    dtype = torch.bfloat16 if dtype is None else dtype
    dev = next(model.parameters()).device
    with torch.no_grad():
        return torch.jit.trace(_ComputeIn(model, dtype).eval(),
                               torch.zeros(tuple(shape), device=dev))


# -- registration --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cached_params(family: str, num_classes: int, width: float, seed: int):
    if family == "v1":
        return mobilenet_v1_init(seed, num_classes, width)
    return mobilenet_v2_init(seed, num_classes, width)


def register_mobilenet(name: str = "mobilenet_v1", family: str = "v1",
                       num_classes: int = 1001, width: float = 1.0,
                       batch: int = 1, size: int = 224, seed: int = 0) -> str:
    """Register a seeded MobileNet classifier (``family`` "v1" or "v2")
    for ``tensor_filter framework=torch-cuda model=<name>``: f32 NHWC
    input of ``(batch, size, size, 3)``, bf16 compute, f32 logits out."""
    from ..filters import register_model
    from .convert import mobilenet_v1_from_jax, mobilenet_v2_from_jax

    if family not in ("v1", "v2"):
        raise ValueError(f"mobilenet family {family!r}: 'v1' or 'v2'")
    tree = _cached_params(family, num_classes, width, seed)
    if family == "v1":
        model, apply = mobilenet_v1_from_jax(tree), mobilenet_v1_apply
    else:
        model, apply = mobilenet_v2_from_jax(tree), mobilenet_v2_apply
    return register_model(name, apply, params=model,
                          in_shapes=[(batch, size, size, 3)],
                          in_dtypes=np.float32)
