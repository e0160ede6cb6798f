"""Tests of the port that need an NVIDIA card (marker ``cuda``).

They skip on a machine without one; on the card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

They import torch and the port only (no JAX), so they run where JAX is
not installed.  Each CUDA kernel is held against its plain PyTorch version
on the card: bit-exact expected, 1 ulp accepted.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inp", [torch.uint8, torch.int8, torch.uint16,
                                 torch.int16, torch.int32, torch.float16,
                                 torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 5), (1, 299, 299, 3)])
def test_scale_bias_cast_kernel_matches_plain(card, inp, out, shape):
    g = torch.Generator().manual_seed(0)
    if inp.is_floating_point:
        x = (torch.randn(shape, generator=g) * 200).to(inp)
    else:
        x = torch.randint(0, 200, shape, generator=g).to(inp)
    x = x.to(card)
    before = kernels.scale_bias_cast.launches
    y = kernels.scale_bias_cast(x, 1 / 127.5, -127.5, out)
    r = kernels.scale_bias_cast_reference(x, 1 / 127.5, -127.5, out)
    torch.cuda.synchronize()
    assert kernels.scale_bias_cast.launches == before + 1
    iv = torch.int32 if out == torch.float32 else torch.int16
    ulps = (y.view(iv).long() - r.view(iv).long()).abs().max()
    assert int(ulps) <= 1


def test_scale_bias_cast_kernel_unaligned_view(card):
    x = torch.arange(1003, dtype=torch.int32, device=card).to(torch.uint8)
    y = kernels.scale_bias_cast(x[3:], 0.5, 1.0)
    assert torch.equal(y, kernels.scale_bias_cast_reference(x[3:], 0.5, 1.0))


def test_scale_bias_cast_kernel_refuses_without_fallback(card):
    with pytest.raises(ValueError, match="float64"):
        kernels.scale_bias_cast(torch.zeros(4, dtype=torch.float64,
                                            device=card), 1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.scale_bias_cast(torch.zeros(4, 4, dtype=torch.uint8,
                                            device=card).t(), 1.0, 0.0)


def test_transform_runs_kernel_on_card(card):
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.runtime import parse_launch

    p = parse_launch("appsrc name=src ! tensor_transform mode=arithmetic "
                     "option=typecast:float32,add:-127.5,div:127.5 "
                     "backend=cuda ! appsink name=out")
    p["src"].spec = TensorsSpec.parse("3:8:8:2", "uint8")
    x = np.arange(384, dtype=np.int64).astype(np.uint8).reshape(2, 8, 8, 3)
    before = kernels.scale_bias_cast.launches
    with p:
        p["src"].push_buffer(Buffer.of(x))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    got = p["out"].pull(timeout=1).tensors[0].torch()
    assert got.is_cuda and kernels.scale_bias_cast.launches == before + 1
    want = (torch.from_numpy(x).float() + np.float32(-127.5)) \
        * np.float32(1 / 127.5)
    assert torch.equal(got.cpu(), want)
