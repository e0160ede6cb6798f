"""The port's ``scale_bias_cast`` against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version (the CUDA kernel is
held against that same plain version on the card by chip_smoke.py); the
JAX side runs the Pallas kernel in interpret mode, as its own tests do.
Same inputs from a numpy seed on both sides.  Tolerance: rtol 1e-6 for an
f32 output, 1 bf16 ulp for a bf16 output.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops import kernels as jk
from nnstreamer_tpu_torch.core.buffer import from_numpy, to_numpy
from nnstreamer_tpu_torch.ops import kernels as tk

SCALE, BIAS = 1.0 / 127.5, -127.5

_IN = {
    "uint8": np.uint8, "int8": np.int8, "int16": np.int16,
    "int32": np.int32, "float32": np.float32,
    "bfloat16": ml_dtypes.bfloat16,
}
_OUT = {"float32": (np.float32, torch.float32),
        "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _input(dtype, shape, seed=7):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        info = np.iinfo(dtype)
        lo, hi = max(info.min, -(2 ** 20)), min(info.max, 2 ** 20)
        return rng.integers(lo, hi, shape, endpoint=True).astype(dtype)
    return (rng.standard_normal(shape) * 200).astype(dtype)


def _assert_close(got: np.ndarray, want: np.ndarray, out: str):
    if out == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        # 1 bf16 ulp: compare the bit patterns (same signs)
        gi = got.view(np.int16).astype(np.int32)
        wi = want.view(np.int16).astype(np.int32)
        assert int(np.abs(gi - wi).max()) <= 1


@pytest.mark.parametrize("shape", [(2, 224, 224, 3), (3, 5)],
                         ids=["tiling", "ragged"])
@pytest.mark.parametrize("out", sorted(_OUT))
@pytest.mark.parametrize("inp", sorted(_IN))
def test_scale_bias_cast_matches_pallas(inp, out, shape):
    x = _input(_IN[inp], shape)
    if shape == (2, 224, 224, 3):
        # the JAX side takes its Pallas kernel (not the jnp fallback)
        assert jk.scale_bias_cast_available(shape, x.dtype)
    want = np.asarray(jk.scale_bias_cast(jnp.asarray(x), SCALE, BIAS,
                                         _OUT[out][0]))
    before = tk.scale_bias_cast.launches
    got = to_numpy(tk.scale_bias_cast(from_numpy(x), SCALE, BIAS,
                                      _OUT[out][1]))
    assert tk.scale_bias_cast.launches == before  # CPU: plain version
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_close(got, want, out)


def test_plain_version_order_and_f64():
    x = torch.arange(256, dtype=torch.uint8)
    y = tk.scale_bias_cast_reference(x, SCALE, BIAS)
    want = (x.to(torch.float32) + np.float32(BIAS)) * np.float32(SCALE)
    assert torch.equal(y, want)
    # float64 computes at f64 precision and has no kernel
    x64 = torch.linspace(-3, 3, 7, dtype=torch.float64)
    y64 = tk.scale_bias_cast_reference(x64, 1 / 3, 0.1, torch.float32)
    assert torch.equal(y64, ((x64 + 0.1) * (1 / 3)).to(torch.float32))
    assert not tk.scale_bias_cast_available((7,), torch.float64)
    assert tk.scale_bias_cast_available((3, 5), np.uint8)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    meta = torch.empty(4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        tk.scale_bias_cast(meta, SCALE, BIAS)
