"""The port's MobileNetV1 and MobileNetV2 classifiers against the JAX
package's, on the same weights and inputs (numpy seeds), on the CPU, at
width 0.25 with 10 classes and 32-64 px inputs.

Tolerances: bit-exact for the parameter init; atol 1e-4 + rtol 1e-4 for
the f32 forwards (the two frameworks sum convolutions in another order);
atol 5e-2 + rtol 5e-2 for the bf16 forwards (bf16 rounds every stage to 8
bits, so one summation-order ulp early in the net carries through); the
global mean over bf16 bit-equal to ``jnp.mean``; a bf16-resident module's
bf16 forward bit-equal to the f32-weight module's (the per-call cast makes
the same bf16 numbers).  ``register_mobilenet`` (v1 and v2) through both
packages' ``parse_launch``: logits within the bf16 tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import TensorsSpec as JTensorsSpec
from nnstreamer_tpu.filters import jax_xla
from nnstreamer_tpu.models import mobilenet as jmob
from nnstreamer_tpu.runtime import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.filters import unregister_model
from nnstreamer_tpu_torch.models import (
    convert,
    mobilenet,
    params_io,
    register_mobilenet,
)
from nnstreamer_tpu_torch.runtime import parse_launch

WIDTH, CLASSES = 0.25, 10
FAMILIES = {
    "v1": (jmob.mobilenet_v1_init, jmob.mobilenet_v1_apply,
           mobilenet.mobilenet_v1_init, convert.mobilenet_v1_from_jax,
           mobilenet.mobilenet_v1_apply),
    "v2": (jmob.mobilenet_v2_init, jmob.mobilenet_v2_apply,
           mobilenet.mobilenet_v2_init, convert.mobilenet_v2_from_jax,
           mobilenet.mobilenet_v2_apply),
}


@functools.lru_cache(maxsize=None)
def _jax_tree(family, seed=0, width=WIDTH):
    return jax.tree_util.tree_map(np.asarray, FAMILIES[family][0](
        jax.random.PRNGKey(seed), CLASSES, width))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _x(seed, size, batch=2):
    return np.random.default_rng(seed).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("seed,width", [(0, WIDTH), (3, 1.0)])
def test_numpy_init_equals_jax_init(family, seed, width):
    want = list(_leaves(_jax_tree(family, seed, width)))
    got = list(_leaves(FAMILIES[family][2](seed, CLASSES, width)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("width", [WIDTH, 0.35, 1.0])
def test_width_read_off_the_tree(family, width):
    """The converter recovers the width multiplier from the channels, so
    a tree of any width loads (``load_state_dict`` is strict)."""
    tree = FAMILIES[family][2](0, CLASSES, width)
    model = FAMILIES[family][3](tree)
    assert model.head.w.shape == (tree["head"]["w"].shape[0], CLASSES)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("size", [32, 64])
def test_f32_forward_matches_jax(family, size):
    _, japply, _, from_jax, apply = FAMILIES[family]
    tree = _jax_tree(family)
    x = _x(size, size)
    want = np.asarray(japply(tree, x, dtype=jnp.float32))
    with torch.inference_mode():
        got = apply(from_jax(tree), torch.from_numpy(x), torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_forward_matches_jax(family):
    _, japply, _, from_jax, apply = FAMILIES[family]
    tree = _jax_tree(family)
    x = _x(7, 64)
    want = np.asarray(japply(tree, x), np.float32)
    with torch.inference_mode():
        got = apply(from_jax(tree), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)


def test_bf16_mean_pinned_to_jnp_mean():
    """``jnp.mean`` over bf16 sums in f32 and rounds once; the port's
    global pool does the same, bit for bit here."""
    x = np.random.default_rng(2).standard_normal((4, 7, 7, 64)) \
        .astype(ml_dtypes.bfloat16)
    want = np.asarray(jnp.mean(jnp.asarray(x), axis=(1, 2)))
    got = mobilenet._mean_hw(
        torch.from_numpy(x.view(np.int16)).view(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_resident_weights_same_bits(family):
    """With ``weights_to_bf16`` the weights stay bf16 in the module (the
    per-call cast is a no-op, not a copy), the batch-norm buffers stay
    f32, and the bf16 forward equals the f32-weight module's bit for bit."""
    _, _, _, from_jax, apply = FAMILIES[family]
    tree = _jax_tree(family)
    m32, m16 = from_jax(tree), from_jax(params_io.weights_to_bf16(tree))
    assert m16.stem.weight.dtype == torch.bfloat16
    assert m16.head.w.dtype == torch.bfloat16
    assert m16.stem.scale.dtype == m16.head.b.dtype == torch.float32
    w = m16.stem.weight
    assert w.to(torch.bfloat16).data_ptr() == w.data_ptr()
    x = torch.from_numpy(_x(5, 32))
    with torch.inference_mode():
        assert torch.equal(apply(m32, x), apply(m16, x))


def _jax_pipeline_logits(name, x):
    p = jax_parse_launch(f"appsrc name=src ! tensor_filter framework=jax-xla "
                         f"model={name} ! appsink name=out")
    p["src"].spec = JTensorsSpec.from_shapes([x.shape], np.float32)
    with p:
        p["src"].push_buffer(JBuffer.of(x))
        out = p["out"].pull(timeout=120)
        p["src"].end_of_stream()
    return np.asarray(out.tensors[0].np(), np.float32)


def _port_pipeline_logits(name, x):
    p = parse_launch(f"appsrc name=src ! tensor_filter framework=torch-cuda "
                     f"model={name} ! appsink name=out", device="cpu")
    p["src"].spec = TensorsSpec.from_shapes([x.shape], np.float32)
    with p:
        p["src"].push_buffer(Buffer.of(x))
        out = p["out"].pull(timeout=120)
        p["src"].end_of_stream()
    return out.tensors[0].np()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_register_mobilenet_through_both_pipelines(family):
    name = f"torch_parity_mobilenet_{family}"
    kw = dict(family=family, num_classes=CLASSES, width=WIDTH, batch=2,
              size=64, seed=4)
    jmob.register_mobilenet(name, **kw)
    register_mobilenet(name, **kw)
    try:
        x = _x(9, 64)
        want = _jax_pipeline_logits(name, x)
        got = _port_pipeline_logits(name, x)
    finally:
        jax_xla.unregister_model(name)
        unregister_model(name)
    assert got.shape == want.shape == (2, CLASSES)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_register_mobilenet_rejects_unknown_family():
    with pytest.raises(ValueError, match="family"):
        register_mobilenet("torch_bad_family", family="v3")
