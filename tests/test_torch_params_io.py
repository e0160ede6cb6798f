"""The port's weights files, model URIs and canary grammar against the JAX
package's, on the CPU.

- ``models/params_io.py``: a file written by either package reads back in
  the other as the JAX package reads its own file, leaf for leaf (exact:
  the bytes are the same), for npz and safetensors, with separator-escaped keys, ``#i``
  lists, digit-string dict keys, scalar leaves and (safetensors) bf16
  leaves; the two
  writers produce the same bytes for safetensors.
- ``filters/modeluri.py`` and ``lifecycle.parse_canary``: the same inputs
  give the same outputs through both packages, and raise on the same
  inputs.  The one deliberate difference: a tagged checkpoint ROOT (a
  directory) raises in the port, which has no trainer yet.
- The ViT from a weights file: the JAX filter and the port's filter, each
  given its own file written from one numpy tree (depth 2, dim 64, 2 heads,
  32x32), agree within ``test_torch_vit.py``'s tolerance — 1e-4 in f32,
  5e-2 in bf16.
- The port's model-file formats: ``.npz``, ``.safetensors``, ``.pkl`` load
  (also as ``file://…@tag``); ``.jaxexp``/``.stablehlo``/``.mlir`` and
  ``.msgpack`` raise ``FilterError`` naming the format.
- bf16: ``weights_to_bf16`` bit-equal to the JAX package's (compared as
  uint16, halfway cases included); a bf16 safetensors file the JAX package
  wrote reads with ``ml_dtypes`` unimportable, leaves bit-equal, and runs
  through the port's filter (bf16 compute, 5e-2).
- Each family's weights file (MobileNetV1, the MobileNetV2 classifier,
  SSD raw and end to end, YOLO raw and end to end), written by the JAX
  package's ``params_io`` (safetensors) or the port's (npz, which keeps
  ``apply_kwargs``), loads through the port's ``model=file://…`` and
  matches the JAX function at f32 within 1e-4, integer outputs equal.
"""

import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.filters import jax_xla
from nnstreamer_tpu.filters import modeluri as jmodeluri
from nnstreamer_tpu.filters.api import FilterProps as JFilterProps
from nnstreamer_tpu.models import params_io as jio
from nnstreamer_tpu.models import vit as jvit
from nnstreamer_tpu.runtime import lifecycle as jlifecycle
from nnstreamer_tpu_torch.filters import TorchCudaFilter
from nnstreamer_tpu_torch.filters import modeluri as tmodeluri
from nnstreamer_tpu_torch.filters.api import FilterError, FilterProps
from nnstreamer_tpu_torch.models import convert
from nnstreamer_tpu_torch.models import params_io as tio
from nnstreamer_tpu_torch.models import vit as tvit
from nnstreamer_tpu_torch.runtime import lifecycle as tlifecycle

IO = {"jax": jio, "port": tio}


def _tree():
    rng = np.random.default_rng(11)
    import ml_dtypes

    return {
        "stem": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                 "b": np.zeros((4,), np.float32)},
        "blocks": [{"dw": np.ones((2, 2), np.int32)},
                   {"dw": np.full((2, 2), 3, np.uint8)}],
        "layers": {"0": {"w": np.arange(3, dtype=np.int64)}},
        "Mobilenet/Conv2d_0/weights": rng.standard_normal(5).astype(
            np.float16),
        "back\\slash": np.array([True, False]),
        "half": rng.standard_normal(4).astype(ml_dtypes.bfloat16),
        "num_classes": 7,
        "scale": 0.5,
    }


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, np.ndarray):
        if a.dtype.name == "bfloat16" and isinstance(b, torch.Tensor):
            # the port reads a bf16 leaf as a torch.bfloat16 tensor
            assert b.dtype == torch.bfloat16
            b = b.view(torch.int16).numpy().view(a.dtype)
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_files_read_back_identically_across_packages(tmp_path, fmt, writer,
                                                     reader):
    tree = _tree()
    path = str(tmp_path / f"w.{fmt}")
    w, r = IO[writer], IO[reader]
    ref_path = str(tmp_path / f"ref.{fmt}")
    if fmt == "npz":
        # numpy archives keep bf16 as raw 2-byte voids in both packages
        del tree["half"]
        w.save_npz(path, tree, apply="m:f", in_shapes=[[1, 4]],
                   in_dtypes=np.float32)
        back, meta = r.load_npz(path)
        assert (meta["apply"], meta["in_shapes"], meta["in_dtypes"]) == \
            ("m:f", [[1, 4]], "float32")
        jio.save_npz(ref_path, tree)
        ref, _ = jio.load_npz(ref_path)
        _assert_same_tree(tree, back)
        assert back["num_classes"] == 7 and back["scale"] == 0.5  # scalars
    else:
        w.save_safetensors(path, tree, metadata={"apply": "m:f"})
        back, meta = r.load_safetensors(path)
        assert meta["apply"] == "m:f"
        jio.save_safetensors(ref_path, tree)
        ref, _ = jio.load_safetensors(ref_path)
        # both writers store a scalar as a 1-element array
        assert back["num_classes"].tolist() == [7]
    assert meta["format"] == "nns-params-v3"
    _assert_same_tree(ref, back)
    assert isinstance(back["blocks"], list)            # '#i' segments
    assert isinstance(back["layers"], dict)            # digit keys stay keys
    assert "Mobilenet/Conv2d_0/weights" in back        # escaped separator


def test_flatten_and_safetensors_bytes_equal_across_packages(tmp_path):
    tree = _tree()
    fj, ft = jio.flatten_params(tree), tio.flatten_params(tree)
    assert list(fj) == list(ft)
    for k in fj:
        assert fj[k].tobytes() == ft[k].tobytes()
    _assert_same_tree(jio.unflatten_params(fj), tio.unflatten_params(ft))
    _assert_same_tree(jio.unflatten_params(fj, escaped=False),
                      tio.unflatten_params(ft, escaped=False))
    a, b = tmp_path / "j.safetensors", tmp_path / "t.safetensors"
    jio.save_safetensors(str(a), tree, metadata={"apply": "m:f"})
    tio.save_safetensors(str(b), tree, metadata={"apply": "m:f"})
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("pkg", sorted(IO))
def test_safetensors_reader_rejects_bad_offsets(tmp_path, pkg):
    path = tmp_path / "bad.safetensors"
    tio.save_safetensors(str(path), {"w": np.zeros((4, 4), np.float32)})
    path.write_bytes(path.read_bytes()[:-8])  # truncated payload
    with pytest.raises(ValueError, match="bad offsets"):
        IO[pkg].load_safetensors(str(path))


def test_port_npz_apply_kwargs_ride_along_unread_by_jax(tmp_path):
    path = str(tmp_path / "k.npz")
    tio.save_npz(path, {"w": np.ones(2, np.float32)}, apply="m:f",
                 apply_kwargs={"heads": 4})
    _, meta = jio.load_npz(path)
    assert meta["apply_kwargs"] == {"heads": 4}
    # without apply_kwargs the port writes the JAX package's metadata
    tio.save_npz(path, {"w": np.ones(2, np.float32)}, apply="m:f")
    _, meta = jio.load_npz(path)
    assert "apply_kwargs" not in meta


# -- model URIs and the canary grammar -----------------------------------------


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raise", type(e).__name__)


def test_modeluri_same_outputs_and_errors_in_both_packages(tmp_path):
    f = tmp_path / "net.pkl"
    f.write_bytes(b"stub")
    lit = tmp_path / "x@y.pkl"
    lit.write_bytes(b"")
    missing = tmp_path / "nope.pkl"
    cases = [
        f"file://{f}@v2", f"file://{f}", str(f), f"{f}@v3", str(lit),
        f"file://{missing}@v9", str(missing) + "@v9", "plain_name",
        "name@weird", f"mlagent://model/{f.name}", 123, None,
        [f"file://{f}", "x"],
    ]
    for ref in cases:
        for fn in ("split_model_version", "resolve_model_uri",
                   "resolve_model_uri_versioned"):
            assert _outcome(getattr(tmodeluri, fn), ref) == \
                _outcome(getattr(jmodeluri, fn), ref), (fn, ref)


def test_modeluri_registered_resolver_and_checkpoint_root(tmp_path):
    root = tmp_path / "ckpts"
    (root / "100").mkdir(parents=True)
    for ref in (f"{root}@100", f"{root}@latest"):
        assert tmodeluri.resolve_model_uri_versioned(ref) == \
            jmodeluri.resolve_model_uri_versioned(ref) == \
            (str(root / "100"), "100")
    for ref in (f"{root}@7", f"{root}@v1"):
        assert _outcome(tmodeluri.resolve_model_uri_versioned, ref) == \
            _outcome(jmodeluri.resolve_model_uri_versioned, ref)
    target = tmp_path / "m.npz"
    target.write_bytes(b"")
    for mod in (tmodeluri, jmodeluri):
        mod.register_model_resolver("reg", lambda uri: str(target))
    try:
        for ref in ("reg://anything", "reg://anything@v5"):
            assert tmodeluri.resolve_model_uri_versioned(ref) == \
                jmodeluri.resolve_model_uri_versioned(ref)
    finally:
        for mod in (tmodeluri, jmodeluri):
            mod.unregister_model_resolver("reg")


@pytest.mark.parametrize("spec", ["", "next:1/4", "v7:1/2", "1/8", " 1/3 ",
                                  "2/3", "next:2/4", "1/1", "x", "1/0",
                                  "next:", "a:b:1/2", "1/x"])
def test_parse_canary_same_in_both_packages(spec):
    got = _outcome(tlifecycle.parse_canary, spec)
    want = _outcome(jlifecycle.parse_canary, spec)
    if want[0] == "raise":
        assert got == ("raise", "LifecycleError"), spec
    else:
        assert got == want, spec


# -- the ViT from a weights file -----------------------------------------------

SMALL = dict(image_size=32, patch=8, dim=64, depth=2, mlp_dim=128,
             num_classes=5)
HEADS = 2
SHAPES = [[1, 32, 32, 3]]


def jax_vit_f32(params, x):
    """The JAX file's ``apply`` in f32 (the JAX package's own
    ``vit_apply`` computes in bf16)."""
    return jvit.vit_apply(params, x, heads=HEADS, dtype=jnp.float32)


def _jax_logits(path, x):
    sp = jax_xla.JaxXlaFilter()
    sp.configure(JFilterProps(framework="jax-xla", model=path))
    try:
        return np.asarray(sp.invoke([x])[0], np.float32)
    finally:
        sp.close()


def _port_logits(model, x):
    sp = TorchCudaFilter()
    sp.configure(FilterProps(framework="torch-cuda", model=model,
                             device=torch.device("cpu")))
    try:
        return sp.invoke([torch.from_numpy(x)])[0].float().numpy()
    finally:
        sp.close()


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_from_weights_file_matches_jax_filter(tmp_path, fmt, dtype):
    tree = tvit.vit_tree(3, **SMALL)
    x = np.random.default_rng(4).standard_normal(SHAPES[0]).astype(np.float32)
    jpath, tpath = str(tmp_path / f"jax.{fmt}"), str(tmp_path / f"port.{fmt}")
    japply = "test_torch_params_io:jax_vit_f32" if dtype == "float32" \
        else "nnstreamer_tpu.models.vit:vit_apply"
    kwargs = {"heads": HEADS, "dtype": dtype}
    if fmt == "npz":
        jio.save_npz(jpath, tree, apply=japply, in_shapes=SHAPES,
                     in_dtypes=np.float32)
        tio.save_npz(tpath, tree, apply="nnstreamer_tpu_torch.models.vit:"
                     "vit_tree_apply", in_shapes=SHAPES, in_dtypes=np.float32,
                     apply_kwargs=kwargs)
    else:
        meta = {"in_shapes": json.dumps(SHAPES), "in_dtypes": "float32"}
        jio.save_safetensors(jpath, tree, metadata=dict(meta, apply=japply))
        tio.save_safetensors(tpath, tree, metadata=dict(
            meta, apply="nnstreamer_tpu_torch.models.vit:vit_tree_apply",
            apply_kwargs=json.dumps(kwargs)))
    want = _jax_logits(jpath, x)
    got = _port_logits(f"file://{tpath}@v1", x)
    assert got.shape == want.shape == (1, 5)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_vit_tree_apply_builds_one_module_per_tree():
    tree = tvit.vit_tree(3, **SMALL)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        a = tvit.vit_tree_apply(tree, x, heads=HEADS, dtype="float32")
        b = tvit.vit_tree_apply(tree, x, heads=HEADS, dtype=torch.float32)
        ref = tvit.vit_apply(convert.vit_from_jax(tree, HEADS), x,
                             torch.float32)
    assert tvit._vit_of_tree(tree, HEADS) is tvit._vit_of_tree(tree, HEADS)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


# -- the port's model-file formats ---------------------------------------------


def add_b(params, x):
    return x + params["b"]


@pytest.mark.parametrize("fmt", ["npz", "safetensors", "pkl"])
def test_port_loads_each_model_file_format(tmp_path, fmt):
    params = {"b": np.arange(4, dtype=np.float32)}
    path = str(tmp_path / f"m.{fmt}")
    apply = "test_torch_params_io:add_b"
    if fmt == "npz":
        tio.save_npz(path, params, apply=apply, in_shapes=[[4]],
                     in_dtypes=np.float32)
    elif fmt == "safetensors":
        tio.save_safetensors(path, params, metadata={
            "apply": apply, "in_shapes": "[[4]]", "in_dtypes": "float32"})
    else:
        with open(path, "wb") as f:
            pickle.dump({"apply": apply, "params": params,
                         "in_shapes": [[4]], "in_dtypes": "float32"}, f)
    for ref in (path, f"file://{path}", f"file://{path}@v3"):
        got = _port_logits(ref, np.ones(4, np.float32))
        np.testing.assert_array_equal(got, [1, 2, 3, 4])


@pytest.mark.parametrize("ext,match", [(".jaxexp", "serialized XLA"),
                                       (".stablehlo", "serialized XLA"),
                                       (".mlir", "serialized XLA"),
                                       (".msgpack", "flax"),
                                       (".onnx", "unsupported model file")])
def test_port_refuses_formats_it_cannot_run(tmp_path, ext, match):
    path = tmp_path / f"m{ext}"
    path.write_bytes(b"\0")
    with pytest.raises(FilterError, match=match):
        _port_logits(str(path), np.ones(4, np.float32))


def test_port_weights_file_without_apply_raises(tmp_path):
    path = str(tmp_path / "w.safetensors")
    tio.save_safetensors(path, {"w": np.zeros(2, np.float32)})
    with pytest.raises(FilterError, match="apply"):
        _port_logits(path, np.ones(2, np.float32))
    with pytest.raises(FilterError, match="neither a registered name"):
        _port_logits(str(tmp_path / "missing.npz"), np.ones(2, np.float32))


def test_auto_framework_detects_model_files(tmp_path):
    from nnstreamer_tpu_torch.filters import detect_framework

    path = str(tmp_path / "w.npz")
    tio.save_npz(path, {"w": np.zeros(2, np.float32)}, apply="m:f")
    assert detect_framework(path) == "torch-cuda"
    assert detect_framework(f"file://{path}@v1") == "torch-cuda"
    with pytest.raises(ValueError):
        detect_framework(str(tmp_path / "w.txt"))


def test_jax_tree_from_jax_init_loads_in_port(tmp_path):
    """A tree drawn by the JAX package's own ``vit_init`` (jax arrays made
    numpy), written by the JAX package, runs in the port."""
    tree = jax.tree_util.tree_map(np.asarray, jvit.vit_init(
        jax.random.PRNGKey(0), **SMALL))
    path = str(tmp_path / "j.safetensors")
    jio.save_safetensors(path, tree, metadata={
        "apply": "nnstreamer_tpu_torch.models.vit:vit_tree_apply",
        "apply_kwargs": json.dumps({"heads": HEADS, "dtype": "float32"}),
        "in_shapes": json.dumps(SHAPES), "in_dtypes": "float32"})
    x = np.random.default_rng(6).standard_normal(SHAPES[0]).astype(np.float32)
    want = np.asarray(jax_vit_f32(tree, x), np.float32)
    np.testing.assert_allclose(_port_logits(path, x), want, rtol=1e-4,
                               atol=1e-4)


# -- bf16 weights: weights_to_bf16, and bf16 files without ml_dtypes -----------

from nnstreamer_tpu.models import mobilenet as jmob  # noqa: E402
from nnstreamer_tpu.models import ssd as jssd  # noqa: E402
from nnstreamer_tpu.models import yolo as jyolo  # noqa: E402


def _as_np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) if hasattr(a, "shape") else a, tree)


def _words(leaf) -> np.ndarray:
    """The raw bits of a bf16 leaf (numpy or torch), as uint16."""
    if isinstance(leaf, torch.Tensor):
        return leaf.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(leaf).view(np.uint16)


def test_weights_to_bf16_bit_equal_to_jax():
    """Round to nearest even in both: the bits of every cast leaf match,
    1-D leaves stay f32, non-array leaves pass through."""
    tree = _as_np(jmob.mobilenet_v1_init(jax.random.PRNGKey(1), 10, 0.25))
    rng = np.random.default_rng(0)
    # halfway cases and big/small magnitudes on top of the real weights
    tree["extra"] = {"w": np.concatenate([
        rng.standard_normal((4, 64)).astype(np.float32),
        np.array([[1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3e38,
                   1e-40, 0.0, -0.0, 65504.5] * 8], np.float32)]),
        "n": 3}
    want = jio.weights_to_bf16(tree)
    got = tio.weights_to_bf16(tree)
    for (path, g), (_, w) in zip(sorted(tio.flatten_params(got).items()),
                                 sorted(jio.flatten_params(want).items())):
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            assert np.array_equal(_words(g), _words(w)), path
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), path
    assert got["extra"]["n"] == 3
    assert isinstance(got["stem"]["scale"], torch.Tensor)
    assert got["stem"]["scale"].dtype == torch.float32
    # torch leaves are taken as well
    again = tio.weights_to_bf16({"w": torch.from_numpy(tree["head"]["w"])})
    assert np.array_equal(_words(again["w"]), _words(want["head"]["w"]))


def test_bf16_safetensors_from_jax_loads_without_ml_dtypes(tmp_path,
                                                           monkeypatch):
    """A bf16 weights file the JAX package wrote reads in the port with
    ``ml_dtypes`` unimportable: bf16 leaves come back as bf16 tensors,
    bit for bit, and the file runs through the port's filter."""
    tree = jio.weights_to_bf16(_as_np(jmob.mobilenet_v1_init(
        jax.random.PRNGKey(2), 10, 0.25)))
    path = str(tmp_path / "v1_bf16.safetensors")
    jio.save_safetensors(path, tree, metadata={
        "apply": "nnstreamer_tpu_torch.models.convert:"
                 "mobilenet_v1_tree_apply",
        "in_shapes": json.dumps([[2, 32, 32, 3]]), "in_dtypes": "float32"})
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jmob.mobilenet_v1_apply(tree, x), np.float32)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    back, _ = tio.load_safetensors(path)
    flat_back, flat_want = tio.flatten_params(back), jio.flatten_params(tree)
    assert set(flat_back) == set(flat_want)
    for k, w in flat_want.items():
        g = flat_back[k]
        if w.dtype.name == "bfloat16":
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16
            assert np.array_equal(_words(g), _words(w)), k
        else:
            assert np.array_equal(g, w), k
    # the port writes the same file back, byte for byte
    again = str(tmp_path / "again.safetensors")
    tio.save_safetensors(again, back, metadata={"x": "y"})
    jio.save_safetensors(str(tmp_path / "ref.safetensors"), tree,
                         metadata={"x": "y"})
    assert open(again, "rb").read() == \
        open(tmp_path / "ref.safetensors", "rb").read()
    got = _port_logits(f"file://{path}@v2", x)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


# -- each family's weights file, written by the JAX package -----------------------

FAMILY_SIZE = 64


def _family_case(family):
    """(JAX tree, port apply, apply_kwargs, JAX reference fn of x)."""
    key = jax.random.PRNGKey(5)
    f32 = jnp.float32
    if family in ("v1", "v2"):
        init = jmob.mobilenet_v1_init if family == "v1" else \
            jmob.mobilenet_v2_init
        apply = jmob.mobilenet_v1_apply if family == "v1" else \
            jmob.mobilenet_v2_apply
        tree = _as_np(init(key, 10, 0.25))
        return (tree, f"mobilenet_{family}_tree_apply", {"dtype": "float32"},
                lambda x: (apply(tree, x, dtype=f32),))
    if family.startswith("ssd"):
        tree = _as_np(jssd.ssd_mobilenet_v2_init(key, 5))
        if family == "ssd_raw":
            return (tree, "ssd_tree_apply",
                    {"end_to_end": False, "dtype": "float32"},
                    lambda x: jssd.ssd_mobilenet_v2_apply(tree, x, dtype=f32))
        anchors = jssd.ssd_anchors(FAMILY_SIZE, tuple(
            int(np.ceil(FAMILY_SIZE / s)) for s in (16, 32, 64, 128, 256,
                                                    512)))
        return (tree, "ssd_tree_apply", {"max_out": 10, "dtype": "float32"},
                lambda x: jssd.ssd_detect_apply(tree, x, anchors, max_out=10,
                                                dtype=f32))
    tree = _as_np(jyolo.yolo_init(key, num_classes=5, width=8, depth=2))
    if family == "yolo_raw":
        return (tree, "yolo_tree_apply", {"raw": True, "dtype": "float32"},
                lambda x: (jyolo.yolo_raw_apply(tree, x, dtype=f32),))
    return (tree, "yolo_tree_apply", {"max_out": 10, "dtype": "float32"},
            lambda x: jyolo.yolo_detect_apply(tree, x, max_out=10,
                                              dtype=f32))


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
@pytest.mark.parametrize("family", ["v1", "v2", "ssd_raw", "ssd", "yolo_raw",
                                    "yolo"])
def test_family_weights_file_from_jax_runs_in_port(tmp_path, family, fmt):
    """A weights file of each family, written by the JAX package's
    ``params_io`` and naming the port's ``*_tree_apply``, loads through the
    port's ``model=file://…`` and matches the JAX function at f32 (1e-4;
    integer outputs equal)."""
    tree, apply, kwargs, ref = _family_case(family)
    shapes = [[1, FAMILY_SIZE, FAMILY_SIZE, 3]]
    apply = f"nnstreamer_tpu_torch.models.convert:{apply}"
    path = str(tmp_path / f"{family}.{fmt}")
    if fmt == "npz":
        # the JAX writer drops apply_kwargs; the port's keeps them
        tio.save_npz(path, tree, apply=apply, in_shapes=shapes,
                     in_dtypes=np.float32, apply_kwargs=kwargs)
    else:
        jio.save_safetensors(path, tree, metadata={
            "apply": apply, "apply_kwargs": json.dumps(kwargs),
            "in_shapes": json.dumps(shapes), "in_dtypes": "float32"})
    x = np.random.default_rng(6).uniform(0, 1, shapes[0]).astype(np.float32)
    want = [np.asarray(t) for t in ref(x)]
    sp = TorchCudaFilter()
    sp.configure(FilterProps(framework="torch-cuda",
                             model=f"file://{path}@v1",
                             device=torch.device("cpu")))
    try:
        got = [t.numpy() for t in sp.invoke([torch.from_numpy(x)])]
    finally:
        sp.close()
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
