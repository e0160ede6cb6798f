"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

- ``scale_bias_cast`` is the tensor_transform arithmetic prologue
  (``typecast:float32,add:B,mul/div:S``) as one kernel
  (``csrc/scale_bias_cast.cu``): the port of the Pallas kernel of the same
  name in the JAX package.  The transform reaches it through
  ``backend=cuda``, and the fusion pass carries it into the filter.
- ``flash_attention`` is non-causal, unmasked ``softmax(q·kᵀ·scale)·v``
  with an online softmax (``csrc/flash_attention.cu``): the port of the
  Pallas kernel of the same name, under the ViT's attention
  (``models/vit.py``).  bf16 runs on the tensor cores (TMA loads,
  ``wgmma``, a producer warpgroup and two consumer warpgroups), f32 on
  the CUDA cores; head dims 64 and 128, any sequence lengths; q, k and v
  are read by stride (:func:`_fa_layout`), so the ViT hands it the
  head-split views of its qkv projection.

Every kernel has three faces here: the plain version
(``*_reference``: what the CPU tests run and what the card's result is
held against), the wrapper (plain version for a CPU tensor; for a CUDA
tensor it launches the kernel or raises — it never falls back; a meta
tensor only inside :func:`shape_only`), and a
launch count on the wrapper (``scale_bias_cast.launches``,
``flash_attention.launches``) that shows a run really went through the
kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core.types import DType
from ..obs import xlacost as _xlacost

_IN_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
             torch.int32: 4, torch.float16: 5, torch.bfloat16: 6,
             torch.float32: 7}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

_scope = threading.local()


@contextlib.contextmanager
def shape_only():
    """Within this block, on this thread, a wrapper given a ``meta``
    tensor (a shape without data: the analyzer's dry run on the meta
    device, ``utils/device.py``) runs the plain version, which on meta
    computes its result's shape and nothing else.  Anywhere else a meta
    tensor is refused like any device the kernel does not take."""
    prev = getattr(_scope, "shape_only", False)
    _scope.shape_only = True
    try:
        yield
    finally:
        _scope.shape_only = prev


def _plain(t: torch.Tensor) -> bool:
    """Whether a wrapper runs its plain version on ``t``: on the CPU, or
    on meta inside :func:`shape_only`."""
    kind = t.device.type
    return kind == "cpu" or (kind == "meta"
                             and getattr(_scope, "shape_only", False))


def _no_grad_through(kernel: str, *xs: torch.Tensor) -> None:
    """Raise when autograd would record a call of ``kernel``: its output
    is allocated outside autograd and it has no backward, so a gradient
    through it would be dropped without a word.  The plain versions keep
    autograd on the CPU; on the card, call under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the CUDA kernel has no "
            f"backward; call it under torch.no_grad() or detach the input")


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, DType):
        return dt.torch_dtype
    return DType.from_np(dt).torch_dtype


def _launcher(name: str, symbol: str, argtypes: list):
    """Kernel ``name``'s C launcher (building the library on first use),
    with every pointer and the stream declared ``c_void_p`` so ctypes
    passes them whole."""
    from .build import load

    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the C launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def scale_bias_cast_available(shape, in_dtype) -> bool:
    """Kernel eligibility: any input type but float64.  The kernel
    computes in f32, so a float64 input takes the plain ops at float64
    precision instead (the JAX package's rule).  Unlike the TPU kernel
    there is no tiling constraint on the shape: the kernel masks its
    ragged tail."""
    return _torch_dtype(in_dtype) in _IN_CODES


def scale_bias_cast_reference(x: torch.Tensor, scale: float, bias: float,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: ``((x + bias) * scale).to(out_dtype)``, computed in
    f32 with f32 scalars (in f64 for an f64 input), in that order."""
    ct = torch.promote_types(x.dtype, torch.float32)
    if ct == torch.float64:
        s, b = float(scale), float(bias)
    else:
        s, b = float(np.float32(scale)), float(np.float32(bias))
    return ((x.to(ct) + b) * s).to(_torch_dtype(out_dtype))


def scale_bias_cast(x: torch.Tensor, scale: float, bias: float,
                    out_dtype=torch.float32) -> torch.Tensor:
    """``((x + bias) * scale)`` cast to f32 or bf16, as one CUDA kernel.

    A CPU tensor gets the plain version (a meta one inside
    :func:`shape_only` too).  A CUDA tensor must be contiguous, of a type :func:`scale_bias_cast_available` accepts, with
    an f32 or bf16 ``out_dtype``; anything else raises.  The kernel has
    no backward: with grad mode on, a CUDA input that requires grad
    raises (:func:`_no_grad_through`) instead of dropping the gradient."""
    out_dtype = _torch_dtype(out_dtype)
    # cost capture (obs/xlacost.py): 2 FLOPs an element, on either path
    # (the counter sees neither the kernel nor elementwise plain ops)
    _xlacost.add_kernel_flops(2 * x.numel())
    if _plain(x):
        return scale_bias_cast_reference(x, scale, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_cast: unsupported device {x.device}")
    _no_grad_through("scale_bias_cast", x)
    if x.dtype not in _IN_CODES:
        raise ValueError(f"scale_bias_cast: no kernel for input {x.dtype}")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"scale_bias_cast: no kernel for output {out_dtype}")
    if not x.is_contiguous():
        raise ValueError("scale_bias_cast: input must be contiguous")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    fn = _launcher("scale_bias_cast", "nns_scale_bias_cast",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), _IN_CODES[x.dtype],
                _OUT_CODES[out_dtype], float(scale), float(bias), _stream(x))
    if rc != 0:
        raise RuntimeError(f"scale_bias_cast: kernel launch failed "
                           f"(cudaError {rc})")
    scale_bias_cast.launches += 1
    return y


scale_bias_cast.launches = 0


# -- flash attention ---------------------------------------------------------

_FA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FA_HEAD_DIMS = (64, 128)


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / float(np.sqrt(q.shape[-1])) if scale is None else scale


def _fa_unsupported(q_shape, k_shape, v_shape, dtypes) -> Optional[str]:
    """Why the kernel cannot take these shapes and types, or None: every
    shape and type rule of the kernel lives here."""
    q_shape, k_shape, v_shape = tuple(q_shape), tuple(k_shape), tuple(v_shape)
    dtypes = [_torch_dtype(dt) for dt in dtypes]
    if len(set(dtypes)) != 1:
        return f"mixed types {', '.join(map(str, dtypes))}"
    if dtypes[0] not in _FA_DTYPES:
        return f"no kernel for {dtypes[0]}"
    if k_shape != v_shape:
        return f"k {k_shape} and v {v_shape} differ"
    if len(q_shape) < 2 or len(q_shape) != len(k_shape) \
            or q_shape[:-2] != k_shape[:-2] or q_shape[-1] != k_shape[-1]:
        return (f"q {q_shape} and k {k_shape} must be (..., S, D) and "
                "(..., Sk, D) with the same leading dims")
    if q_shape[-1] not in _FA_HEAD_DIMS:
        return f"head dim must be one of {_FA_HEAD_DIMS}, got {q_shape[-1]}"
    if q_shape[-2] < 1 or k_shape[-2] < 1:
        return f"empty sequence: q {q_shape}, k {k_shape}"
    return None


def flash_attention_available(q_shape, k_shape, dtype) -> bool:
    """Kernel eligibility: bf16 or f32, head dim 64 or 128, q (..., S, D)
    and k/v (..., Sk, D) with the same leading dims and S, Sk >= 1.  Any
    S and Sk: the kernel masks its ragged tiles (the TPU kernel's rule
    that S tile by 128 does not carry over)."""
    return _fa_unsupported(q_shape, k_shape, k_shape, [dtype]) is None


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version, in the kernel's math: q and k to f32, scores
    ``(q·kᵀ) * scale`` in f32, a full softmax, ``p·v`` in f32, cast to
    q's type.  (The JAX package's reference takes the first product in
    the input type, which rounds bf16 scores; the kernel does not.)"""
    scale = _default_scale(q, scale)
    s = torch.einsum("...qd,...kd->...qk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("...qk,...kd->...qd", p,
                        v.to(torch.float32)).to(q.dtype)


class _FaLayout(NamedTuple):
    """A (B, H, S, D) view with element strides (sB, sH, sS, 1)."""
    B: int
    H: int
    S: int
    D: int
    sB: int
    sH: int
    sS: int


def _fa_layout(t: torch.Tensor) -> Union[_FaLayout, str]:
    """``t`` (..., S, D) as the kernel reads it: a rank-4 (B, H, S, D)
    layout with element strides, or why the kernel cannot read it.

    The last dim must have stride 1.  The dim before S is H; the ones
    before that must merge into one dim B (as a contiguous tensor's do);
    no leading dims means B = H = 1.  A dim of size 1 is never stepped
    over, so its stride is set to one TMA takes.  TMA's rules: a 16-byte
    aligned base and strides that are positive multiples of 16 bytes,
    below 2**40 bytes."""
    if t.dim() < 2:
        return f"needs (..., S, D), got shape {tuple(t.shape)}"
    S, D = t.shape[-2], t.shape[-1]
    if t.stride(-1) != 1:
        return f"the last dim must have stride 1, got {t.stride(-1)}"
    lead = [(n, st) for n, st in zip(t.shape[:-2], t.stride()[:-2]) if n != 1]
    H, sH = lead.pop() if lead else (1, 0)
    B, sB = lead.pop() if lead else (1, 0)
    for n, st in reversed(lead):
        if st != sB * B:
            return (f"leading dims {tuple(t.shape[:-2])} with strides "
                    f"{t.stride()[:-2]} do not merge into (B, H)")
        B *= n
    sS = t.stride(-2) if S > 1 else D
    sH = sH if H > 1 else S * sS
    sB = sB if B > 1 else H * sH
    esize = t.element_size()
    if t.data_ptr() % 16:
        return f"its base {t.data_ptr():#x} is not 16-byte aligned"
    for name, st in (("S", sS), ("H", sH), ("B", sB)):
        if st <= 0 or (st * esize) % 16 or st * esize >= 2 ** 40:
            return (f"the stride of its {name} dim, {st * esize} bytes, is "
                    "not a positive multiple of 16 below 2**40")
    return _FaLayout(B, H, S, D, sB, sH, sS)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q·kᵀ·scale)·v`` (scale defaults to 1/√D) as one CUDA
    kernel, never materializing the (S, Sk) scores.

    CPU tensors get the plain version (meta ones inside
    :func:`shape_only` too).  CUDA tensors must be on one
    device, of one type and shape that :func:`flash_attention_available`
    accepts, and each readable by the kernel as :func:`_fa_layout` says —
    any strides TMA takes, so the head-split views of a qkv projection go
    in without a copy; anything else raises ``ValueError``.  The output
    is allocated (B, S, H, D) and returned as its (..., S, D) view, so
    ``o.transpose(1, 2)`` of a 4-d result is contiguous.  No backward:
    an input that requires grad raises under grad mode."""
    scale = _default_scale(q, scale)
    if _plain(q):
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")
    _no_grad_through("flash_attention", q, k, v)
    why = _fa_unsupported(q.shape, k.shape, v.shape,
                          [q.dtype, k.dtype, v.dtype])
    if why is not None:
        raise ValueError(f"flash_attention: {why}")
    if q.numel() == 0:
        return torch.empty_like(q)
    layouts = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        lay = _fa_layout(t)
        if isinstance(lay, str):
            raise ValueError(f"flash_attention: {name}: {lay}")
        layouts.append(lay)
    B, H, S, D = layouts[0][:4]
    o4 = torch.empty((B, S, H, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    layouts.append(_fa_layout(o4))
    fn = _launcher("flash_attention", "nns_flash_attention",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(),
                (ctypes.c_int64 * 28)(*(x for lay in layouts for x in lay)),
                _FA_DTYPES[q.dtype], float(scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed "
                           f"(cudaError {rc})")
    flash_attention.launches += 1
    # cost capture (obs/xlacost.py): 4·B·H·S·Sk·D, which the counter
    # cannot see through ctypes (on the CPU it counts the plain
    # version's matmuls instead)
    _xlacost.add_kernel_flops(4 * q.numel() * k.shape[-2])
    return o4.view(q.shape)


flash_attention.launches = 0
