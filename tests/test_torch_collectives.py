"""The port's stream collectives (``nnstreamer_tpu_torch/parallel/
collectives.py``) against the JAX package's ``shard_map`` programs, on 8
virtual devices each (``parallel.mesh.set_virtual_devices`` / the JAX tests'
virtual CPU devices), the same numpy-seeded inputs.

Tolerances: data movement (merge, ring shift, regroup) bit-equal; the
reduction atol 1e-5 + rtol 1e-6 (the two sum the blocks in another
order); ``ring_attention`` at f32 atol 1e-5 + rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from nnstreamer_tpu.parallel import collectives as jc
from nnstreamer_tpu.parallel import make_mesh as jmake_mesh
from nnstreamer_tpu_torch.parallel import collectives as tc
from nnstreamer_tpu_torch.parallel import mesh as tmesh

MESHES = ("data:8", "data:4,model:2", "model:2,data:4")


@pytest.fixture(scope="module", autouse=True)
def _virtual_devices():
    tmesh.set_virtual_devices(8, "cpu")
    yield
    tmesh.clear_virtual_devices()


def _meshes(spec):
    return (tmesh.make_mesh(spec),
            jmake_mesh(spec, devices=jax.devices("cpu")[:8]))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("spec,axis", [
    (spec, axis) for spec in MESHES for axis in ("data", "model")
    if axis in spec])
def test_all_gather_merge(spec, axis):
    tm, jm = _meshes(spec)
    for dim in (0, 1):
        x = _x((8, 8, 3), dim)
        got = tc.all_gather_merge(tm, axis, concat_dim=dim)(
            torch.from_numpy(x))
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jc.all_gather_merge(jm, axis, concat_dim=dim)(x)))


@pytest.mark.parametrize("spec", MESHES)
def test_psum_reduce(spec):
    tm, jm = _meshes(spec)
    x = _x((16, 5), 1)
    for axis in ("data", ("data", "model") if "model" in spec else "data"):
        got = tc.psum_reduce(tm, axis)(torch.from_numpy(x))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jc.psum_reduce(jm, axis)(x)),
            rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("shift", [1, 3, -1])
def test_ring_shift(shift):
    tm, jm = _meshes("data:8")
    x = _x((16, 4), 2)
    got = tc.ring_shift(tm, "data", shift)(torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc.ring_shift(jm, "data", shift)(x)))
    # the single-device meaning: blocks move `shift` places on
    np.testing.assert_array_equal(got.numpy(), np.roll(x, 2 * shift, 0))


@pytest.mark.parametrize("split_dim,concat_dim", [(1, 0), (0, 1)])
def test_all_to_all_regroup(split_dim, concat_dim):
    tm, jm = _meshes("data:8")
    x = _x((16, 16, 2), 3)
    got = tc.all_to_all_regroup(tm, "data", split_dim=split_dim,
                                concat_dim=concat_dim)(torch.from_numpy(x))
    want = np.asarray(jc.all_to_all_regroup(
        jm, "data", split_dim=split_dim, concat_dim=concat_dim)(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec,axis", [("data:8", "data"),
                                       ("data:4,model:2", "data"),
                                       ("data:4,model:2", "model")])
def test_ring_attention_f32(spec, axis):
    tm, jm = _meshes(spec)
    q, k, v = (_x((2, 32, 16), s) for s in (4, 5, 6))
    got = tc.ring_attention(tm, axis)(*(torch.from_numpy(t)
                                        for t in (q, k, v)))
    want = np.asarray(jc.ring_attention(jm, axis)(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and the whole-sequence attention it stands for
    s = np.einsum("bqh,bkh->bqk", q, k) / np.sqrt(16.0)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bqk,bkh->bqh", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_blocks_live_on_their_devices():
    """Every block is copied to its own device record's torch.device
    (one real device here) and the result lands on the axis's first."""
    tm, _ = _meshes("data:8")
    out = tc.all_gather_merge(tm, "data")(torch.arange(16.0))
    assert out.device == tm.devices.flat[0].torch_device


def test_indivisible_axis_raises():
    tm, _ = _meshes("data:8")
    with pytest.raises(ValueError):
        tc.psum_reduce(tm, "data")(torch.zeros(6, 2))
    with pytest.raises(ValueError):
        tc.psum_reduce(tm, "nope")(torch.zeros(8, 2))
