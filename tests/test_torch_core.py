"""The port's tensor core against the JAX package's: wire bytes, donation,
host seeding, and the device source's staged noise.

Exact equality throughout: these are byte formats and seeded data.
"""

import itertools

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu.core as jcore
from nnstreamer_tpu.elements import devicesrc as jsrc
from nnstreamer_tpu_torch import core
from nnstreamer_tpu_torch.elements import devicesrc
from nnstreamer_tpu_torch.runtime import Pipeline


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32", "int32",
                                   "bfloat16", "float64"])
def test_flexible_wire_bytes_match_jax(dtype):
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    a = (np.arange(24).reshape(2, 3, 4) - 7).astype(np_dt)
    want = jcore.Buffer.of(a).pack_flexible()
    got_host = core.Buffer.of(a).pack_flexible()
    t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(a.copy())
    got_dev = core.Buffer.of(t).pack_flexible()
    assert got_host == want and got_dev == want
    back = core.Buffer.unpack_flexible(want)
    assert back.tensors[0].spec == core.TensorSpec.from_shape(
        (2, 3, 4), core.DType.from_string(dtype))
    assert back.tensors[0].tobytes() == a.tobytes()


def test_bfloat16_needs_no_ml_dtypes_on_the_device_path():
    t = core.Tensor(torch.ones(2, 3, dtype=torch.bfloat16))
    assert t.spec.dtype is core.DType.BFLOAT16 and t.nbytes == 12
    assert core.DType.BFLOAT16.torch_dtype is torch.bfloat16
    assert core.DType.BFLOAT16.size == 2
    assert t.tobytes() == np.ones((2, 3), ml_dtypes.bfloat16).tobytes()


def test_donated_tensor_read_raises():
    t = core.Tensor(torch.arange(4))
    t.mark_donated()
    assert t.is_donated and not t.is_device
    with pytest.raises(core.DonatedTensorError):
        t.np()
    with pytest.raises(core.DonatedTensorError):
        t.torch()
    kept = core.Tensor(torch.arange(4))
    kept.np()  # an independent host copy survives donation
    kept.mark_donated()
    np.testing.assert_array_equal(kept.np(), [0, 1, 2, 3])


def test_seed_host_checks_size():
    t = core.Tensor(torch.zeros(2, 2, dtype=torch.float32))
    t.seed_host(np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(t.np(), [[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="size"):
        t.seed_host(np.arange(3, dtype=np.float32))


def test_device_src_noise_matches_jax(monkeypatch):
    """Both packages stage the same noise bytes for the same seed."""
    spec_args = ("3:8:8:2", "uint8")
    monkeypatch.setattr(jsrc, "_stage_seed", itertools.count(1))
    monkeypatch.setattr(devicesrc, "_stage_seed", itertools.count(1))
    j = jsrc.DeviceSrc(name="src", spec=jcore.TensorsSpec.parse(*spec_args),
                       pool_size=2)
    j._stage_pool()
    t = devicesrc.DeviceSrc(name="src",
                            spec=core.TensorsSpec.parse(*spec_args),
                            pool_size=2)
    Pipeline(device="cpu").add(t)
    t._stage_pool()
    for js, ts in zip(j._pool, t._pool):
        assert np.array_equal(np.asarray(js[0]), ts[0].numpy())
