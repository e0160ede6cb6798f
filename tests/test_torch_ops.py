"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions (each CUDA kernel
is held against that same plain version on the card by chip_smoke.py and
tests/test_torch_cuda.py); the JAX side runs the Pallas kernel in
interpret mode, as its own tests do.  Same inputs from a numpy seed on
both sides.

Tolerances:
- ``scale_bias_cast``: rtol 1e-6 for an f32 output, 1 bf16 ulp for a
  bf16 output;
- ``flash_attention`` where the JAX kernel engages (D = 128, S a multiple
  of its block): f32 atol 1e-5 + rtol 1e-4 (only the order of summation
  differs); bf16 atol 1e-2 + rtol 1e-2, and at most 1 bf16 ulp for
  outputs of magnitude 1/64 or more;
- ``flash_attention`` where the JAX package takes its jnp reference (D =
  64, S = 100): f32 rtol 1e-5 + atol 1e-6 (the atol covers outputs near
  zero, where a 2e-7 difference is a large relative one); bf16 atol 3e-2
  + rtol 3e-2, because the JAX reference takes q·kᵀ in bf16 and so rounds
  the scores, which the port's plain version (like its kernel) keeps in
  f32.
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


# -- flash attention ----------------------------------------------------------

_FA_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _cpu_exp_warmed():
    """One multi-threaded ``torch.exp`` before any comparison.  In a fresh
    process under load, the first ``torch.exp`` spread over the CPU's
    threads came back with a relative error of 1.49e-4 in 12 of 96
    processes, every later call within 1e-7, and none of 96 drifted with
    one such call first (a probe counting drifted first calls over fresh
    processes; torch 2.13's CPU build with MKL, 8 threads on an AVX-512
    CPU).  A drifted first call
    in ``[self]`` put the plain attention's softmax outside the f32
    tolerance against the Pallas kernel."""
    torch.exp(torch.zeros(1 << 20))


def _qkv(q_shape, kv_shape, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(_FA_DT[dtype])
            for s in (q_shape, kv_shape, kv_shape)]


def _both(q, k, v):
    want = np.asarray(jk.flash_attention(*map(jnp.asarray, (q, k, v))))
    before = tk.flash_attention.launches
    got = to_numpy(tk.flash_attention(*map(from_numpy, (q, k, v))))
    assert tk.flash_attention.launches == before  # CPU: plain version
    assert got.dtype == want.dtype and got.shape == want.shape
    return got, want


def _no_jax_reference(monkeypatch):
    """Make the JAX side's fallback to its jnp reference an error, so a
    test that means to hold the port against the Pallas kernel does."""
    def refuse(*a, **kw):
        raise AssertionError("the JAX kernel's tiling check failed")

    monkeypatch.setattr(jk, "flash_attention_reference", refuse)


@pytest.mark.parametrize("q_shape,kv_shape", [
    ((2, 2, 256, 128), (2, 2, 256, 128)),
    ((1, 128, 128), (1, 512, 128)),
], ids=["self", "cross"])
def test_flash_attention_f32_matches_pallas(q_shape, kv_shape, monkeypatch):
    _no_jax_reference(monkeypatch)
    got, want = _both(*_qkv(q_shape, kv_shape, "float32"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_flash_attention_bf16_matches_pallas(monkeypatch):
    _no_jax_reference(monkeypatch)
    got, want = _both(*_qkv((2, 2, 128, 128), (2, 2, 128, 128), "bfloat16"))
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=1e-2, atol=1e-2)
    # at most 1 ulp where |o| >= 1/64 (nearer zero an ulp is below the
    # f32 summation noise, and the atol above holds)
    big = np.abs(want.astype(np.float32)) >= 2 ** -6
    assert big.mean() > 0.5
    _assert_close(got[big], want[big], "bfloat16")


@pytest.mark.parametrize("dtype", sorted(_FA_DT))
def test_flash_attention_where_jax_takes_its_reference(dtype):
    """D = 64, S = 100: the JAX package computes its jnp reference; the
    port's plain version (and kernel) take any S and D in (64, 128)."""
    q, k, v = _qkv((1, 100, 64), (1, 100, 64), dtype, seed=3)
    assert tk.flash_attention_available(q.shape, k.shape, q.dtype)
    got, want = _both(q, k, v)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32),
                                   rtol=3e-2, atol=3e-2)


def test_flash_attention_plain_version_follows_the_kernels_math():
    """Scores in f32 even for bf16 inputs (the JAX reference rounds them
    to bf16), a full softmax, p·v in f32, one cast at the end; scale
    defaults to 1/sqrt(D) and is applied after the dot."""
    q, k, v = (from_numpy(a) for a in
               _qkv((2, 3, 17, 64), (2, 3, 9, 64), "bfloat16", seed=4))
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) / 8.0
    want = (torch.softmax(s, dim=-1) @ v.float()).to(torch.bfloat16)
    got = tk.flash_attention_reference(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 17, 64)
    assert (got.float() - want.float()).abs().max() <= 2 ** -8
    scaled = tk.flash_attention_reference(q, k, v, scale=0.5)
    assert not torch.equal(scaled, got)
    # the ragged S = 17 against the JAX reference at f32
    qf, kf, vf = _qkv((2, 3, 17, 128), (2, 3, 17, 128), "float32", seed=5)
    np.testing.assert_allclose(
        tk.flash_attention_reference(*map(torch.from_numpy, (qf, kf, vf))
                                     ).numpy(),
        np.asarray(jk.flash_attention_reference(qf, kf, vf)),
        rtol=1e-4, atol=1e-6)


def _qkv_views(B, S, H, dh, dtype=torch.bfloat16, seed=6):
    """q, k, v as the ViT splits its qkv projection: thirds of one
    (B, S, 3·H·dh) tensor, each viewed (B, S, H, dh) → (B, H, S, dh)."""
    D = H * dh
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, S, 3 * D, generator=g).to(dtype)
    return [t.reshape(B, S, H, dh).transpose(1, 2)
            for t in qkv.split(D, dim=-1)]


_L = tk._FaLayout


@pytest.mark.parametrize("shape,want", [
    ((64, 4, 256, 128), _L(64, 4, 256, 128, 4 * 256 * 128, 256 * 128, 128)),
    ((2, 3, 17, 64), _L(2, 3, 17, 64, 3 * 17 * 64, 17 * 64, 64)),
    ((5, 100, 64), _L(1, 5, 100, 64, 5 * 100 * 64, 100 * 64, 64)),
    ((128, 128), _L(1, 1, 128, 128, 128 * 128, 128 * 128, 128)),
    ((2, 3, 4, 9, 64), _L(6, 4, 9, 64, 4 * 9 * 64, 9 * 64, 64)),
    ((1, 4, 1, 64), _L(1, 4, 1, 64, 4 * 64, 64, 64)),
], ids=["vit", "bhsd", "hsd", "sd", "merged-lead", "size-1"])
def test_fa_layout_of_contiguous_tensors(shape, want):
    """Leading dims merge into (B, H); none means B = H = 1; a size-1 dim
    gets a stride TMA takes (it is never stepped over)."""
    assert tk._fa_layout(torch.zeros(shape, dtype=torch.bfloat16)) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,dh", [(64, 256, 4, 128), (2, 100, 4, 64),
                                      (1, 17, 2, 128)])
def test_fa_layout_of_the_qkv_head_views(B, S, H, dh, dtype):
    """The ViT's head-split thirds of the qkv projection: strides
    (S·3D, dh, 3D, 1) with k and v at offsets D and 2D, read as they are."""
    D = H * dh
    q, k, v = _qkv_views(B, S, H, dh, dtype)
    for t in (q, k, v):
        assert tk._fa_layout(t) == _L(B, H, S, dh, S * 3 * D if B > 1 else
                                      H * dh, dh, 3 * D)
    assert (k.data_ptr() - q.data_ptr()) // q.element_size() == D
    assert (v.data_ptr() - q.data_ptr()) // q.element_size() == 2 * D


@pytest.mark.parametrize("make,why", [
    (lambda: torch.zeros(1, 2, 128, 64).transpose(-1, -2),
     "last dim must have stride 1"),
    (lambda: torch.zeros(1, 2, 16, 65)[..., 1:], "16-byte aligned"),
    (lambda: torch.zeros(1, 2, 16, 3 * 64 + 4, dtype=torch.bfloat16)[..., :64],
     "stride of its S dim, 392 bytes"),
    (lambda: torch.zeros(3, 16, 64).expand(2, 3, 16, 64),
     "stride of its B dim, 0 bytes"),
    (lambda: torch.zeros(4, 3, 2, 16, 64).transpose(0, 1),
     "do not merge into (B, H)"),
    (lambda: torch.zeros(64), "needs (..., S, D)"),
], ids=["transposed", "misaligned-base", "misaligned-stride", "broadcast",
        "unmergeable", "rank-1"])
def test_fa_layout_refuses_with_the_reason(make, why):
    got = tk._fa_layout(make())
    assert isinstance(got, str) and why in got, got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_plain_version_on_qkv_views(dtype, dh):
    """On the CPU the wrapper's plain version reads the strided views: the
    same values as on contiguous copies."""
    q, k, v = _qkv_views(2, 33, 4, dh, dtype)
    assert not q.is_contiguous()
    got = tk.flash_attention(q, k, v)
    want = tk.flash_attention_reference(q.contiguous(), k.contiguous(),
                                        v.contiguous())
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.equal(got, want)


def test_flash_attention_eligibility():
    ok = tk.flash_attention_available
    assert ok((64, 4, 256, 128), (64, 4, 256, 128), torch.bfloat16)
    assert ok((1, 2, 17, 64), (1, 2, 5, 64), np.float32)
    assert not ok((1, 2, 16, 96), (1, 2, 16, 96), torch.bfloat16)  # D
    assert not ok((1, 2, 16, 64), (1, 2, 16, 64), torch.float64)
    assert not ok((1, 2, 16, 64), (1, 3, 16, 64), torch.float32)   # lead
    assert not ok((1, 2, 16, 64), (1, 2, 16, 128), torch.float32)
    assert not ok((16, 64), (0, 64), torch.float32)                # Sk = 0
    meta = torch.empty(1, 4, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="device"):
        tk.flash_attention(meta, meta, meta)
