"""NHWC tensor ops the three model importers share (onnx, tflite, tf).

The JAX importers call ``lax.conv_general_dilated`` and
``lax.reduce_window`` with explicit, possibly asymmetric padding on NHWC
activations.  PyTorch's convolutions and pools are NCHW and pad only
symmetrically, so these helpers pad by hand and run on the NCHW view of
NHWC memory (a channels-last tensor, which cuDNN takes as it is).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Pads = Sequence[Tuple[int, int]]


def same_pad(in_size: int, stride: int, k: int,
             dilation: int = 1) -> Tuple[int, int]:
    """XLA's and TFLite's SAME padding of one spatial dim, (before,
    after): asymmetric, the odd cell after, when the total is odd."""
    k_eff = (k - 1) * dilation + 1
    out = -(-int(in_size) // stride)
    pad = max((out - 1) * stride + k_eff - int(in_size), 0)
    return pad // 2, pad - pad // 2


def _pad_hw(h: torch.Tensor, pads: Pads, value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor by ``((top, bottom), (left, right))``."""
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        h = F.pad(h, (int(pl), int(pr), int(pt), int(pb)), value=value)
    return h


def conv2d_nhwc(x: torch.Tensor, w_oihw: torch.Tensor,
                stride: Sequence[int], pads: Pads,
                dilation: Sequence[int] = (1, 1),
                groups: int = 1) -> torch.Tensor:
    """NHWC ``x`` convolved with an OIHW weight under explicit padding
    ``((top, bottom), (left, right))``; returns NHWC in ``x``'s dtype."""
    h = _pad_hw(x.permute(0, 3, 1, 2), pads)
    y = F.conv2d(h, w_oihw.to(x.dtype), stride=tuple(int(s) for s in stride),
                 dilation=tuple(int(d) for d in dilation), groups=int(groups))
    return y.permute(0, 2, 3, 1)


def pads_of(mode: str, x: torch.Tensor, k: Sequence[int],
            stride: Sequence[int]) -> Pads:
    """``"SAME"``/``"VALID"`` → explicit pads over (H, W) of NHWC ``x``
    (``lax.padtype_to_pads``)."""
    if mode == "VALID":
        return ((0, 0), (0, 0))
    return (same_pad(x.shape[1], stride[0], k[0]),
            same_pad(x.shape[2], stride[1], k[1]))


def max_pool_nhwc(x: torch.Tensor, k: Sequence[int], stride: Sequence[int],
                  pads: Pads) -> torch.Tensor:
    """``reduce_window(max)`` over NHWC ``x``: pads hold the dtype's
    lowest value (-inf for floats), so they never win.  Integer codes pool
    exactly in float32."""
    dt = x.dtype
    h = x.permute(0, 3, 1, 2)
    if dt.is_floating_point:
        low = float("-inf")
    else:
        low = float(torch.iinfo(dt).min)
        h = h.float()
    h = _pad_hw(h, pads, low)
    y = F.max_pool2d(h, tuple(int(v) for v in k),
                     tuple(int(s) for s in stride))
    return y.permute(0, 2, 3, 1).to(dt)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device.  PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which can
    land one ulp off the CPU's quotient, and the rounding of a requantize
    after it then flips a code at a tie; a divisor on the device is
    divided by."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _window_sum(h: torch.Tensor, k: Sequence[int],
                stride: Sequence[int]) -> torch.Tensor:
    """Window sums of NCHW ``h`` in a fixed order: the window's cells in
    row-major order, each added to a running sum (``reduce_window``'s
    order).  A reduction kernel's order differs between the card and the
    CPU, so its float sums may round apart, and a requantize after it
    then flips a code; elementwise adds in one fixed order give one
    result on both."""
    (kh, kw), (sh, sw) = k, stride
    oh = (h.shape[2] - kh) // sh + 1
    ow = (h.shape[3] - kw) // sw + 1
    total = None
    for dh in range(kh):
        for dw in range(kw):
            cell = h[:, :, dh:dh + sh * (oh - 1) + 1:sh,
                     dw:dw + sw * (ow - 1) + 1:sw]
            total = cell if total is None else total + cell
    return total


def avg_pool_nhwc(x: torch.Tensor, k: Sequence[int], stride: Sequence[int],
                  pads: Pads) -> torch.Tensor:
    """``reduce_window(add)`` of NHWC ``x`` divided by the same window
    over ones: padded cells add to neither the sum nor the count (TF's
    SAME and ONNX's ``count_include_pad=0``).  Sums in a fixed order
    (:func:`_window_sum`)."""
    kk = tuple(int(v) for v in k)
    ss = tuple(int(s) for s in stride)
    total = _window_sum(_pad_hw(x.permute(0, 3, 1, 2), pads), kk, ss)
    ones = _pad_hw(torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype,
                              device=x.device), pads)
    cnt = _window_sum(ones, kk, ss)
    return (total / cnt).permute(0, 2, 3, 1)


def mean_hw(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    """The mean over H and W of NHWC ``x``, summed in a fixed order
    (:func:`_window_sum` over the whole plane), then divided once."""
    total = _window_sum(x.permute(0, 3, 1, 2), tuple(x.shape[1:3]), (1, 1))
    y = true_div(total, float(x.shape[1] * x.shape[2])).permute(0, 2, 3, 1)
    return y if keepdim else y.reshape(y.shape[0], -1)


def pad_nd(x: torch.Tensor, pads: Sequence[Sequence[int]],
           value: float = 0) -> torch.Tensor:
    """``jnp.pad`` with a (before, after) pair per axis, first axis
    first."""
    flat = []
    for before, after in reversed([tuple(p) for p in pads]):
        flat += [int(before), int(after)]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


class DeviceConsts:
    """Host constants of an imported function (scales, zero points,
    folded requantize multipliers): each copied to a device on its first
    use there, then reused by every call."""

    def __init__(self):
        self._t: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def __call__(self, key: str, make: Callable[[], np.ndarray],
                 device: torch.device) -> torch.Tensor:
        t = self._t.get((key, device))
        if t is None:
            t = self._t[(key, device)] = torch.from_numpy(
                np.ascontiguousarray(make())).to(device)
        return t
