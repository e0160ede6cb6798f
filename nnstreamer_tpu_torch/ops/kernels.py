"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

- ``scale_bias_cast`` is the tensor_transform arithmetic prologue
  (``typecast:float32,add:B,mul/div:S``) as one kernel
  (``csrc/scale_bias_cast.cu``): the port of the Pallas kernel of the same
  name in the JAX package.  The transform reaches it through
  ``backend=cuda``, and the fusion pass carries it into the filter.

Every kernel has three faces here: the plain version
(``*_reference``: what the CPU tests run and what the card's result is
held against), the wrapper (plain version for a CPU tensor; for a CUDA
tensor it launches the kernel or raises — it never falls back), and a
launch count on the wrapper (``scale_bias_cast.launches``) that shows a
run really went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.types import DType

_IN_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
             torch.int32: 4, torch.float16: 5, torch.bfloat16: 6,
             torch.float32: 7}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, DType):
        return dt.torch_dtype
    return DType.from_np(dt).torch_dtype


def _launcher():
    """The kernel's C launcher (building the library on first use), with
    every pointer and the stream declared ``c_void_p`` so ctypes passes
    them whole."""
    from .build import load

    fn = load("scale_bias_cast").nns_scale_bias_cast
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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

    A CPU tensor gets the plain version.  A CUDA tensor must be
    contiguous, of a type :func:`scale_bias_cast_available` accepts, with
    an f32 or bf16 ``out_dtype``; anything else raises."""
    out_dtype = _torch_dtype(out_dtype)
    if x.device.type == "cpu":
        return scale_bias_cast_reference(x, scale, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"scale_bias_cast: unsupported device {x.device}")
    if x.dtype not in _IN_CODES:
        raise ValueError(f"scale_bias_cast: no kernel for input {x.dtype}")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"scale_bias_cast: no kernel for output {out_dtype}")
    if not x.is_contiguous():
        raise ValueError("scale_bias_cast: input must be contiguous")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return y
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), _IN_CODES[x.dtype],
                _OUT_CODES[out_dtype], float(scale), float(bias), stream)
    if rc != 0:
        raise RuntimeError(f"scale_bias_cast: kernel launch failed "
                           f"(cudaError {rc})")
    scale_bias_cast.launches += 1
    return y


scale_bias_cast.launches = 0
