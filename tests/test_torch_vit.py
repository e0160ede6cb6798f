"""The port's ViT classification path against the JAX package's, on the CPU.

Same weights (the JAX tree, carried across by ``vit_from_jax``) and the
same numpy-seeded inputs through both packages.  The JAX side runs its
Pallas flash-attention kernel in interpret mode where its tiling check
passes (dh = 128, S = 16) and its jnp reference otherwise (dh = 64); the
port runs its kernel's plain version (CPU tensors).

Tolerances:
- f32 compute: atol 1e-4 + rtol 1e-4 on the logits (the two frameworks
  sum the products in a different order);
- bf16 compute: atol 5e-2 + rtol 5e-2, the JAX package's own tolerance
  between its kernel and its reference (``tests/test_vit.py``): bf16
  rounds at other places in the two frameworks' matmuls and gelu;
- the traps (gelu, layer norm, dense rounding, head layout): bit-exact or
  1e-6, as each test states.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import golden_cases
import nnstreamer_tpu.ops as jops
from nnstreamer_tpu.filters import jax_xla
from nnstreamer_tpu.models import vit as jvit
from nnstreamer_tpu.runtime import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.filters import register_model
from nnstreamer_tpu_torch.models import convert
from nnstreamer_tpu_torch.models import vit as tvit
from nnstreamer_tpu_torch.runtime import parse_launch

# tests/test_vit.py's tiny config (S = 16 patches, dh = 256 / 2 = 128)
TINY = dict(image_size=32, patch=8, dim=256, depth=2, mlp_dim=128,
            num_classes=5)
CONFIGS = {"dh128": 2, "dh64": 4}   # heads


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_tree(seed=0):
    return _np_tree(jvit.vit_init(jax.random.PRNGKey(seed), **TINY))


def _image(seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 32, 32, 3)).astype(np.float32)


def _jax_logits(tree, x, heads, dtype):
    return np.asarray(jax.jit(lambda p, xx: jvit.vit_apply(
        p, xx, heads=heads, dtype=dtype))(tree, x))


def _port_logits(model, x, dtype):
    with torch.inference_mode():
        y = tvit.vit_apply(model, torch.from_numpy(x), dtype)
    assert y.dtype == torch.float32
    return y.numpy()


def test_vit_params_from_jax_round_trips():
    tree = _jax_tree()
    model = convert.vit_from_jax(tree, heads=2)
    sd = model.state_dict()
    assert set(sd) == set(convert.vit_params_from_jax(tree))
    np.testing.assert_array_equal(
        sd["embed_w"].numpy().transpose(2, 3, 1, 0), tree["embed"]["w"])
    np.testing.assert_array_equal(sd["pos"].numpy(), tree["pos"])
    for i, blk in enumerate(tree["blocks"]):
        for part, p in blk.items():
            for k, v in p.items():
                np.testing.assert_array_equal(
                    sd[f"blocks.{i}.{part}.{k}"].numpy(), v)
    np.testing.assert_array_equal(sd["head.w"].numpy(), tree["head"]["w"])
    assert model.heads == 2 and model.patch == 8


def test_vit_tree_has_the_jax_layout_and_scales():
    """The port's own init draws the JAX tree's shapes and scales (not its
    bits: numpy and jax.random differ)."""
    want = jax.tree_util.tree_flatten_with_path(_jax_tree())[0]
    got = jax.tree_util.tree_flatten_with_path(tvit.vit_tree(0, **TINY))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32, path
        if w.std() > 0:
            assert 0.8 < g.std() / w.std() < 1.25, path
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_forward_matches_jax(config, dtype):
    heads = CONFIGS[config]
    tree = _jax_tree()
    x = _image(1)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = _jax_logits(tree, x, heads, jdt)
    got = _port_logits(convert.vit_from_jax(tree, heads), x, tdt)
    assert got.shape == want.shape == (2, 5)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_gelu_is_the_tanh_approximation():
    """Trap: jax.nn.gelu defaults to the tanh form; torch's default is
    the exact erf form, off by up to ~5e-4."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(x))
    got = tvit.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_layernorm_population_variance_and_eps():
    """Trap: ``_ln`` uses the population variance and eps 1e-6; torch's
    ``var`` defaults to unbiased and ``nn.LayerNorm`` to eps 1e-5.  Four
    features with a variance near eps make both differences large."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 4)) * 2e-3).astype(np.float32)
    g = rng.uniform(0.5, 2, 4).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jvit._ln({"g": g, "b": b}, x))
    ln = tvit.LayerNorm(4)
    ln.load_state_dict({"g": torch.from_numpy(g), "b": torch.from_numpy(b)})
    with torch.inference_mode():
        got = ln(torch.from_numpy(x)).numpy()
        torch_ln = F.layer_norm(torch.from_numpy(x), (4,),
                                torch.from_numpy(g), torch.from_numpy(b)
                                ).numpy()
        xt = torch.from_numpy(x)
        unbiased = ((xt - xt.mean(-1, keepdim=True))
                    * torch.rsqrt(xt.var(-1, keepdim=True) + 1e-6)
                    * torch.from_numpy(g) + torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(torch_ln - want).max() > 1e-2       # eps 1e-5
    assert np.abs(unbiased - want).max() > 1e-2       # unbiased variance
    # bf16 in, bf16 out: statistics and affine in f32, one cast at the end
    xb = x.astype(ml_dtypes.bfloat16)
    want_b = np.asarray(jvit._ln({"g": g, "b": b}, xb))
    with torch.inference_mode():
        got_b = ln(torch.from_numpy(xb.astype(np.float32)).bfloat16())
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_b.float().numpy(),
                                  want_b.astype(np.float32))


def test_dense_rounds_twice_in_bf16():
    """Trap: ``_dense`` is ``x @ w`` rounded to bf16, then ``+ b`` rounded
    again.  The port's two steps are bit-equal to JAX; one fused rounding
    (``F.linear`` with a bias) differs in a quarter of the elements."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.0625).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    want = np.asarray(jax.jit(lambda x: jvit._dense(
        {"w": w, "b": b}, x, jnp.bfloat16))(xb)).astype(np.float32)
    d = tvit.Dense(256, 128)
    d.load_state_dict({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    xt = torch.from_numpy(x).bfloat16()
    with torch.inference_mode():
        got = d(xt, torch.bfloat16)
        once = F.linear(xt, d.w.bfloat16().t(), d.b.bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (once.float().numpy() != want).mean() > 0.1
    # the head: bf16 features into an f32 product, as JAX promotes
    with torch.inference_mode():
        head = d(xt, torch.float32)
    want_f32 = np.asarray(jvit._dense({"w": w, "b": b}, xb, jnp.float32))
    assert head.dtype == torch.float32 and want_f32.dtype == np.float32
    np.testing.assert_allclose(head.numpy(), want_f32, rtol=1e-5, atol=1e-5)


def test_heads_layout_matches_jax(monkeypatch):
    """Trap: q, k, v are contiguous thirds of the qkv projection, split
    into heads as (B,S,H,dh) → (B,H,S,dh).  The tensors each package
    hands its attention kernel, captured in the first block, agree."""
    heads, tree, x = 2, _jax_tree(), _image(2)
    seen = {}

    def capture(key, inner):
        def fn(q, k, v, *a, **kw):
            seen.setdefault(key, [np.asarray(t, np.float32) if key == "jax"
                                  else t.float().numpy() for t in (q, k, v)])
            return inner(q, k, v, *a, **kw)
        return fn

    monkeypatch.setattr(jops, "flash_attention",
                        capture("jax", jops.flash_attention))
    monkeypatch.setattr(tvit, "flash_attention",
                        capture("port", tvit.flash_attention))
    jvit.vit_apply(tree, x, heads=heads, dtype=jnp.float32)   # eager
    _port_logits(convert.vit_from_jax(tree, heads), x, torch.float32)
    for name, j, t in zip("qkv", seen["jax"], seen["port"]):
        assert t.shape == j.shape == (2, heads, 16, 128), name
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5, err_msg=name)
    assert not np.allclose(seen["port"][0], seen["port"][1])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_attention_hands_the_kernel_qkv_views(config, monkeypatch):
    """No copies around the kernel: q, k and v are the head-split thirds
    of one qkv projection, strides (S·3D, dh, 3D, 1) with k and v D and
    2D elements past q in the same storage; the forward is unchanged."""
    heads, tree, x = CONFIGS[config], _jax_tree(), _image(2)
    dim, S = TINY["dim"], 16
    dh, inner, seen = dim // heads, tvit.flash_attention, []

    def capture(q, k, v, *a, **kw):
        seen.append((q, k, v))
        return inner(q, k, v, *a, **kw)

    model = convert.vit_from_jax(tree, heads)
    want = _port_logits(model, x, torch.float32)
    monkeypatch.setattr(tvit, "flash_attention", capture)
    got = _port_logits(model, x, torch.float32)
    assert len(seen) == TINY["depth"]
    np.testing.assert_array_equal(got, want)
    for q, k, v in seen:
        for t in (q, k, v):
            assert t.shape == (2, heads, S, dh)
            assert t.stride() == (S * 3 * dim, dh, 3 * dim, 1)
            assert t.untyped_storage().data_ptr() == \
                q.untyped_storage().data_ptr()
        assert k.storage_offset() - q.storage_offset() == dim
        assert v.storage_offset() - q.storage_offset() == 2 * dim


def test_register_vit_through_the_filter():
    """``register_vit``: the model a ``tensor_filter`` names, bf16
    compute, logits equal to ``vit_apply`` on the same weights."""
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec

    name = tvit.register_vit("torch_vit_registered", batch=1, image_size=32,
                             patch=8, dim=256, depth=1, heads=2, mlp_dim=128,
                             num_classes=5, seed=3)
    p = parse_launch("appsrc name=src ! tensor_transform mode=arithmetic "
                     "option=typecast:float32,div:255.0 ! tensor_filter "
                     f"framework=torch-cuda model={name} ! appsink name=out",
                     device="cpu")
    p["src"].spec = TensorsSpec.from_shapes([(1, 32, 32, 3)], np.uint8)
    x = np.random.default_rng(1).integers(0, 255, (1, 32, 32, 3), np.uint8)
    with p:
        p["src"].push_buffer(Buffer.of(x))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    got = p["out"].pull(timeout=1).tensors[0].np()
    model = tvit.vit_init(3, image_size=32, patch=8, dim=256, depth=1,
                          heads=2, mlp_dim=128, num_classes=5)
    with torch.inference_mode():
        want = tvit.vit_apply(model, torch.from_numpy(x).float() / 255.0)
    assert got.shape == (1, 5) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want.numpy())


# -- the whole slice: transform → ViT → image_labeling ------------------------

SLICE = (
    "device_src name=src num-buffers=2 ! "
    "tensor_transform name=norm mode=arithmetic "
    "option=typecast:float32,add:-127.5,div:127.5 backend=pallas ! "
    "tensor_filter name=net framework={fw} model=torch_parity_vit ! "
    "{dec}appsink name=out max-buffers=4")
LABELS = f"{golden_cases.GOLDEN_DIR}/labels.txt"
DECODER = f"tensor_decoder name=label mode=image_labeling option1={LABELS} ! "


def _register_both(heads=2, batch=2):
    tree = _jax_tree()
    shapes = [(batch, 32, 32, 3)]
    jax_xla.register_model(
        "torch_parity_vit",
        lambda p, x: jvit.vit_apply(p, x, heads=heads, dtype=jnp.float32),
        params=tree, in_shapes=shapes, in_dtypes=np.float32)
    register_model("torch_parity_vit",
                   lambda m, x: tvit.vit_apply(m, x, torch.float32),
                   params=convert.vit_from_jax(tree, heads),
                   in_shapes=shapes, in_dtypes=np.float32)


def _run(p, frames):
    p["src"].frames = frames
    with p:
        assert p.wait_eos(timeout=300)
    bufs = []
    while (b := p["out"].pull(timeout=0)) is not None:
        bufs.append(b)
    assert len(bufs) == len(frames)
    return bufs


def test_whole_slice_matches_jax():
    _register_both()
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
              for _ in range(2)]
    out = {}
    for pkg, launch, fw in (("jax", jax_parse_launch, "jax-xla"),
                            ("port", functools.partial(parse_launch,
                                                       device="cpu"),
                             "torch-cuda")):
        logits_p = launch(SLICE.format(fw=fw, dec=""))
        labels_p = launch(SLICE.format(fw=fw, dec=DECODER))
        out[pkg] = (_run(logits_p, frames), _run(labels_p, frames))
        if pkg == "port":
            for p in (logits_p, labels_p):
                assert [(s.transforms, s.filter, s.decoder)
                        for s in p.fused_segments] == [(("norm",), "net",
                                                        None)]
    labels = open(LABELS).read().split()
    for i in range(len(frames)):
        jl = np.asarray(out["jax"][0][i].tensors[0].jax())
        tl = out["port"][0][i].tensors[0].np()
        assert tl.shape == jl.shape == (2, 5) and tl.dtype == np.float32
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        jb, tb = out["jax"][1][i], out["port"][1][i]
        assert tb.meta["label"] == jb.meta["label"]
        assert tb.meta["label_index"] == jb.meta["label_index"] \
            == int(np.argmax(tl))
        assert tb.meta["score"] == pytest.approx(jb.meta["score"], abs=1e-4)
        assert tb.meta["score"] == float(tl.reshape(-1).max())
        idx = tb.meta["label_index"]
        want = labels[idx] if idx < len(labels) else str(idx)
        assert bytes(tb.tensors[0].np()) == want.encode() \
            == jb.tensors[0].tobytes()
