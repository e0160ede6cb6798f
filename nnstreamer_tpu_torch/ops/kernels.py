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
  head-split views of its qkv projection.  With ``rel_h``, ``rel_w`` and
  ``key_grid`` it adds SAM's decomposed relative-position bias to every
  score (``models/sam.py``), reading the two small tables a row and never
  an (S, Sk) bias.
- ``layer_norm`` is the ViT's ``_ln`` (f32 statistics, population
  variance, ``g`` and ``b`` applied in f32, one rounding back) as one
  kernel (``csrc/layer_norm.cu``).  It replaces no Pallas kernel: XLA fuses
  the JAX package's ``_ln``, and the port's eager version ran it as about
  twelve f32 passes.  One warp a row, held in registers: one read and one
  write of each row in its own type.

Every kernel has three faces here: the plain version
(``*_reference``: what the CPU tests run and what the card's result is
held against), the wrapper (plain version for a CPU tensor; for a CUDA
tensor it launches the kernel or raises — it never falls back; a meta
tensor only inside :func:`shape_only`), and a
launch count on the wrapper (``scale_bias_cast.launches``,
``flash_attention.launches``, ``layer_norm.launches``) that shows a run
really went through the kernel (``flash_attention.rel_pos_launches``
counts the biased launches among its ``launches``).
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
#: the bf16 kernel keeps two query tiles' bias tables in shared memory beside
#: its D = 64 tiles: at most this many columns (Kh + Kw) a row, unless Kw is
#: 64 (the tables of a 64-wide grid are read into registers instead)
_FA_REL_MAX_COLS = 112
_FA_REL_GRID_W = 64


def _default_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / float(np.sqrt(q.shape[-1])) if scale is None else scale


def _fa_unsupported(q_shape, k_shape, v_shape, dtypes,
                    rel=None) -> Optional[str]:
    """Why the kernel cannot take these shapes and types, or None: every
    shape and type rule of the kernel lives here.  ``rel`` is None, or the
    bias's ``(rel_h shape, rel_w shape, [rel_h dtype, rel_w dtype],
    key_grid)`` (:func:`_fa_rel_unsupported`)."""
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
    if rel is not None:
        return _fa_rel_unsupported(q_shape, k_shape, dtypes[0], *rel)
    return None


def _key_grid(key_grid, sk: int):
    """``key_grid`` as (Kh, Kw), or why it is not a grid of ``sk`` keys."""
    try:
        kh, kw = (int(n) for n in key_grid)
    except (TypeError, ValueError):
        return f"key_grid must be (Kh, Kw), got {key_grid!r}"
    if kh < 1 or kw < 1 or kh * kw != sk:
        return f"key_grid {(kh, kw)} is not a grid of the {sk} keys"
    return kh, kw


def _fa_rel_unsupported(q_shape, k_shape, dtype, rel_h_shape, rel_w_shape,
                        rel_dtypes, key_grid) -> Optional[str]:
    """The bias's rules: keys on a ``key_grid`` (Kh, Kw) with Kh·Kw = Sk;
    rel_h (..., S, Kh) and rel_w (..., S, Kw) float32 with q's leading
    dims; bf16 takes head dim 64 and either Kw = 64 or Kh + Kw up to 112
    (the tables share shared memory with the tiles), f32 any head dim the
    kernel takes."""
    grid = _key_grid(key_grid, k_shape[-2])
    if isinstance(grid, str):
        return grid
    kh, kw = grid
    want_h, want_w = q_shape[:-1] + (kh,), q_shape[:-1] + (kw,)
    if tuple(rel_h_shape) != want_h or tuple(rel_w_shape) != want_w:
        return (f"rel_h {tuple(rel_h_shape)} and rel_w {tuple(rel_w_shape)} "
                f"must be {want_h} and {want_w}")
    rel_dtypes = [_torch_dtype(dt) for dt in rel_dtypes]
    if any(dt != torch.float32 for dt in rel_dtypes):
        return f"rel_h and rel_w must be float32, got {rel_dtypes}"
    if dtype == torch.bfloat16:
        if q_shape[-1] != 64:
            return (f"the bf16 kernel takes a relative-position bias at head "
                    f"dim 64, got {q_shape[-1]}")
        if kw != _FA_REL_GRID_W and kh + kw > _FA_REL_MAX_COLS:
            return (f"the bf16 kernel takes a key grid with Kw = "
                    f"{_FA_REL_GRID_W} or Kh + Kw up to {_FA_REL_MAX_COLS}, "
                    f"got {kh} + {kw}")
    return None


def flash_attention_available(q_shape, k_shape, dtype) -> bool:
    """Kernel eligibility: bf16 or f32, head dim 64 or 128, q (..., S, D)
    and k/v (..., Sk, D) with the same leading dims and S, Sk >= 1.  Any
    S and Sk: the kernel masks its ragged tiles (the TPU kernel's rule
    that S tile by 128 does not carry over)."""
    return _fa_unsupported(q_shape, k_shape, k_shape, [dtype]) is None


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: Optional[float] = None,
                              rel_h: Optional[torch.Tensor] = None,
                              rel_w: Optional[torch.Tensor] = None,
                              key_grid=None) -> torch.Tensor:
    """Plain version, in the kernel's math: q and k to f32, scores
    ``(q·kᵀ) * scale`` in f32, a full softmax, ``p·v`` in f32, cast to
    q's type.  (The JAX package's reference takes the first product in
    the input type, which rounds bf16 scores; the kernel does not.)
    With the bias, key j of the (Kh, Kw) grid adds ``rel_h[..., i, j //
    Kw] + rel_w[..., i, j % Kw]`` to score (i, j), here materialized."""
    scale = _default_scale(q, scale)
    s = torch.einsum("...qd,...kd->...qk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if rel_h is not None:
        kh, kw = (int(n) for n in key_grid)
        s = (s.unflatten(-1, (kh, kw)) + rel_h.to(torch.float32)[..., None]
             + rel_w.to(torch.float32)[..., None, :]).flatten(-2)
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
                    scale: Optional[float] = None,
                    rel_h: Optional[torch.Tensor] = None,
                    rel_w: Optional[torch.Tensor] = None,
                    key_grid=None) -> torch.Tensor:
    """``softmax(q·kᵀ·scale)·v`` (scale defaults to 1/√D) as one CUDA
    kernel, never materializing the (S, Sk) scores.

    With ``rel_h`` (..., S, Kh), ``rel_w`` (..., S, Kw) and ``key_grid``
    (Kh, Kw), Sk = Kh·Kw, score (i, j) is ``q_i·k_j·scale + rel_h[..., i,
    j // Kw] + rel_w[..., i, j % Kw]``: SAM's decomposed relative
    position.  The kernel reads the contiguous float32 tables a query row
    at a time; no (S, Sk) bias is made (the plain version makes one).

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
    biased = (rel_h is not None, rel_w is not None, key_grid is not None)
    if any(biased) and not all(biased):
        raise ValueError("flash_attention: rel_h, rel_w and key_grid go "
                         "together")
    biased = all(biased)
    if _plain(q):
        return flash_attention_reference(q, k, v, scale, rel_h, rel_w,
                                         key_grid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    tensors = (q, k, v) + ((rel_h, rel_w) if biased else ())
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention: q, k, v and the tables must "
                         "share a device")
    _no_grad_through("flash_attention", *tensors)
    rel = ((rel_h.shape, rel_w.shape, [rel_h.dtype, rel_w.dtype], key_grid)
           if biased else None)
    why = _fa_unsupported(q.shape, k.shape, v.shape,
                          [q.dtype, k.dtype, v.dtype], rel)
    if why is not None:
        raise ValueError(f"flash_attention: {why}")
    if biased and not (rel_h.is_contiguous() and rel_w.is_contiguous()):
        raise ValueError("flash_attention: rel_h and rel_w must be "
                         "contiguous")
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
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.c_float]
    lay = (ctypes.c_int64 * 28)(*(x for lay in layouts for x in lay))
    with torch.cuda.device(q.device):
        if biased:
            fn = _launcher("flash_attention", "nns_flash_attention_rel",
                           args + [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p])
            kh, kw = _key_grid(key_grid, k.shape[-2])
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(),
                    lay, _FA_DTYPES[q.dtype], float(scale), rel_h.data_ptr(),
                    rel_w.data_ptr(), kh, kw, _stream(q))
        else:
            fn = _launcher("flash_attention", "nns_flash_attention",
                           args + [ctypes.c_void_p])
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(),
                    lay, _FA_DTYPES[q.dtype], float(scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed "
                           f"(cudaError {rc})")
    flash_attention.launches += 1
    flash_attention.rel_pos_launches += biased
    # cost capture (obs/xlacost.py): 4·B·H·S·Sk·D, which the counter
    # cannot see through ctypes (on the CPU it counts the plain
    # version's matmuls instead)
    _xlacost.add_kernel_flops(4 * q.numel() * k.shape[-2])
    return o4.view(q.shape)


flash_attention.launches = 0
flash_attention.rel_pos_launches = 0


# -- layer norm ---------------------------------------------------------------

_LN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: a warp holds a row in registers, eight 16-byte vectors a lane at most
_LN_MAX_ROW_BYTES = 4096


def _ln_unsupported(width: int, dtype) -> Optional[str]:
    """Why the kernel cannot take rows of ``width`` elements of ``dtype``,
    or None: every width and type rule of the kernel lives here."""
    dtype = _torch_dtype(dtype)
    if dtype not in _LN_DTYPES:
        return f"no kernel for {dtype}"
    vec, most = 16 // dtype.itemsize, _LN_MAX_ROW_BYTES // dtype.itemsize
    if width < vec or width % vec or width > most:
        return (f"width {width}: the kernel takes {dtype} rows of a "
                f"multiple of {vec} elements, up to {most}")
    return None


def layer_norm_available(shape, dtype) -> bool:
    """Kernel eligibility: bf16 or f32 rows (the last dim) of a multiple of
    one 16-byte vector, at most 4 KiB: bf16 widths 8 to 2048, f32 4 to
    1024.  Any number of rows."""
    return len(shape) >= 1 and _ln_unsupported(shape[-1], dtype) is None


def layer_norm_reference(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain version, the JAX package's ``_ln``: statistics in f32 over
    the last dim with the population variance, ``g`` and ``b`` applied in
    f32, then one cast back to ``x``'s type."""
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * g + b).to(x.dtype)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """:func:`layer_norm_reference` as one CUDA kernel: each row read once
    and written once in ``x``'s type.

    A CPU tensor gets the plain version (a meta one inside
    :func:`shape_only` too).  A CUDA ``x`` must have a type and width
    :func:`layer_norm_available` accepts, a last dim of stride 1, leading
    dims that merge into rows, and a 16-byte aligned base and row stride;
    ``g`` and ``b`` are ``(width,)`` f32 or bf16 (widened exactly) on its
    device.  Anything else raises ``ValueError``.  The output is
    contiguous.  No backward: an input that requires grad raises under
    grad mode."""
    if _plain(x):
        return layer_norm_reference(x, g, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if g.device != x.device or b.device != x.device:
        raise ValueError("layer_norm: x, g and b must share a device")
    _no_grad_through("layer_norm", x, g, b)
    if x.dim() < 1:
        raise ValueError("layer_norm: needs (..., width), got a scalar")
    width = x.shape[-1]
    why = _ln_unsupported(width, x.dtype)
    if why is not None:
        raise ValueError(f"layer_norm: {why}")
    params = []
    for name, p in (("g", g), ("b", b)):
        if tuple(p.shape) != (width,) or p.dtype not in _LN_DTYPES:
            raise ValueError(f"layer_norm: {name} must be ({width},) float32 "
                             f"or bfloat16, got {tuple(p.shape)} {p.dtype}")
        params.append(p.to(torch.float32).contiguous())
    if x.stride(-1) != 1:
        raise ValueError(f"layer_norm: the last dim must have stride 1, got "
                         f"{x.stride(-1)}")
    try:
        rows = x.view(-1, width)
    except RuntimeError:
        raise ValueError(f"layer_norm: leading dims {tuple(x.shape[:-1])} "
                         f"with strides {x.stride()[:-1]} do not merge into "
                         "rows") from None
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows.shape[0] == 0:
        return y
    stride = rows.stride(0) if rows.shape[0] > 1 else width
    if x.data_ptr() % 16 or (stride * x.element_size()) % 16:
        raise ValueError(f"layer_norm: its base {x.data_ptr():#x} or its row "
                         f"stride of {stride * x.element_size()} bytes is "
                         "not 16-byte aligned")
    fn = _launcher("layer_norm", "nns_layer_norm",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), params[0].data_ptr(), params[1].data_ptr(),
                y.data_ptr(), rows.shape[0], stride, width,
                _LN_DTYPES[x.dtype], float(eps), _stream(x))
    if rc != 0:
        raise RuntimeError(f"layer_norm: kernel launch failed "
                           f"(cudaError {rc})")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
