"""The ``onnx`` importer of the port against the JAX package's.

The reference's mobilenet_v2_quant.onnx is not in the repository, so the
files come from ``tests/torch_model_files.py``: a QLinear MobileNetV2 and
its float twin at width 0.25, 32x32, from seeded weights.  Both packages'
importers and filters (``FilterSingle`` and ``parse_launch``) take the same
files and the same inputs from a numpy seed, in every qmode, at batch 1
and 2.  Tolerances: ``int8`` codes equal (the port sums in float64,
exactly, as the JAX package's int32 accumulator does); ``bf16`` and
``dequant`` within one output quantum (float32 sums of integer codes,
exact below 2**24 in any order); ``float`` within 8 output quanta (real
sums rounded to each activation's grid: a tie that rounds apart moves
later codes; the two packages part by up to 5 quanta at 96x96); the
float file within 1e-4.  A 96x96 case runs the final 3x3 pool (the
pools sum in one fixed order, as ``reduce_window`` does).  ``tests/test_onnx.py``'s cases that need no model
file run on the port by ``torch_replay``; the port's own cases cover
detection, the fused prologue, hot reload, ``mesh=``, ``share-model``
pooling and the refusal of a graph whose second input is read.
"""

import numpy as np
import pytest
import torch
import torch_model_files as mf
from torch_replay import replay

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import TensorsSpec as JSpec
from nnstreamer_tpu.elements.filter import FilterSingle as JSingle
from nnstreamer_tpu.runtime import parse_launch as jparse
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.elements.filter import FilterSingle
from nnstreamer_tpu_torch.filters import FilterError, FilterProps
from nnstreamer_tpu_torch.filters.onnx import OnnxFilter
from nnstreamer_tpu_torch.runtime import parse_launch
from nnstreamer_tpu_torch.runtime.events import Event, EventKind

replay("test_onnx.py", globals(), only=["TestOnnxParse"])

SIZE, WIDTH, CLASSES = 32, 0.25, 1000
QMODES = ["bf16", "dequant", "int8", "float"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module: under the suite's parallel
    workers, the float64 (int8-mode) convolutions otherwise spin every
    core's threads against the other workers; the results do not depend
    on the thread count beyond the stated tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("onnx")
    return {"q": mf.write_onnx_qlinear(str(d / "q.onnx"), 0, WIDTH, SIZE,
                                       CLASSES),
            "q2": mf.write_onnx_qlinear(str(d / "q2.onnx"), 1, WIDTH, SIZE,
                                        CLASSES),
            "f": mf.write_onnx_float(str(d / "f.onnx"), 0, WIDTH, SIZE,
                                     CLASSES),
            "dir": d}


def _frames(batch: int, seed: int = 7):
    """uint8 NHWC camera frames and the model's NCHW input in [-1, 1)."""
    q = np.random.default_rng(seed).integers(
        0, 256, (batch, SIZE, SIZE, 3), dtype=np.uint8)
    x = np.ascontiguousarray(np.transpose(
        q.astype(np.float32) / 127.5 - 1.0, (0, 3, 1, 2)))
    return q, x


def _out_scale(path: str) -> float:
    from nnstreamer_tpu_torch.filters.onnx_import import OnnxModel

    return float(OnnxModel(path).inits["logits_scale"].ravel()[0])


def _port(path, x, fw="onnx", **kw):
    out = FilterSingle(framework=fw, model=path, device="cpu", **kw).invoke(
        [x])[0]
    return out.numpy()


def _jax(path, x, fw="onnx", **kw):
    return np.asarray(JSingle(framework=fw, model=path, **kw).invoke([x])[0])


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("qmode", QMODES)
def test_qlinear_matches_jax_filter(files, qmode, batch):
    _, x = _frames(batch)
    got = _port(files["q"], x, custom=f"qmode:{qmode}")
    want = _jax(files["q"], x, custom=f"qmode:{qmode}")
    assert got.shape == want.shape == (batch, CLASSES)
    assert got.dtype == np.float32
    q = _out_scale(files["q"])
    if qmode == "int8":
        np.testing.assert_array_equal(got, want)
    elif qmode == "float":
        assert np.abs(got - want).max() <= 8 * q * 1.001
    else:
        assert np.abs(got - want).max() <= q * 1.001
    # the output depends on the frame: two frames' logits differ
    if batch == 2:
        assert np.abs(got[0] - got[1]).max() > 10 * _out_scale(files["q"])


@pytest.mark.parametrize("qmode", ["int8", "dequant"])
def test_qlinear_at_96_matches_jax_filter(tmp_path, qmode):
    """At 96x96 the global pool averages 3x3 cells: the integer modes
    stay exact against the JAX package."""
    path = mf.write_onnx_qlinear(str(tmp_path / "q96.onnx"), 0, WIDTH, 96,
                                 CLASSES)
    q = np.random.default_rng(3).integers(0, 256, (2, 96, 96, 3),
                                          dtype=np.uint8)
    x = np.ascontiguousarray(np.transpose(
        q.astype(np.float32) / 127.5 - 1.0, (0, 3, 1, 2)))
    np.testing.assert_array_equal(_port(path, x, custom=f"qmode:{qmode}"),
                                  _jax(path, x, custom=f"qmode:{qmode}"))


@pytest.mark.parametrize("batch", [1, 2])
def test_float_file_matches_jax_filter(files, batch):
    _, x = _frames(batch)
    got, want = _port(files["f"], x), _jax(files["f"], x)
    assert got.shape == want.shape == (batch, CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_qlinear_approximates_float_twin(files):
    """The writer is checked against itself: the quantized graph tracks
    the float one (the same folded weights), its logits correlating with
    the float logits (random weights leave top classes close, so their
    order may differ)."""
    _, x = _frames(2)
    q = _port(files["q"], x, custom="qmode:int8")
    f = _port(files["f"], x)
    for a, b in zip(q, f):
        assert np.corrcoef(a, b)[0, 1] > 0.9


def test_default_qmode_is_bf16(files):
    _, x = _frames(1)
    np.testing.assert_array_equal(_port(files["q"], x),
                                  _port(files["q"], x, custom="qmode:bf16"))


def _pipe_desc(path: str, fw: str, batch: int) -> str:
    return (f"appsrc name=src ! tensor_transform name=norm mode=arithmetic "
            f"option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_transform name=tr mode=transpose option=1:2:0:3 ! "
            f"tensor_filter name=net framework={fw} model={path} "
            f"custom=qmode:int8 ! appsink name=out")


@pytest.mark.parametrize("fw", ["onnx", "onnxruntime"])
def test_parse_launch_matches_jax_pipeline(files, fw):
    """Camera frames → normalize → NHWC→NCHW transpose → the imported
    model, in both packages: equal int8 logits, and the port folds both
    transforms into the filter's program."""
    q, _ = _frames(2)
    outs = {}
    for pkg, parse, buf, spec in (("jax", jparse, JBuffer, JSpec),
                                  ("port", parse_launch, Buffer,
                                   TensorsSpec)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        p = parse(_pipe_desc(files["q"], fw, 2), **kw)
        p["src"].spec = spec.parse(f"3:{SIZE}:{SIZE}:2", "uint8")
        with p:
            p["src"].push_buffer(buf.of(q))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=120)
            b = p["out"].pull(timeout=5)
        outs[pkg] = np.asarray(b.tensors[0].np())
        if pkg == "port":
            segs = [(s.transforms, s.filter) for s in p.fused_segments]
            assert segs == [(("norm", "tr"), "net")]
    np.testing.assert_array_equal(outs["port"], outs["jax"])


def test_framework_autodetect_and_alias(files):
    """``tests/test_onnx.py``'s detection case, on the writer's file."""
    from nnstreamer_tpu_torch.filters.registry import (
        detect_framework,
        find_filter,
    )

    assert detect_framework(files["q"]) == "onnx"
    assert find_filter("onnxruntime").NAME == "onnxruntime"
    assert issubclass(find_filter("onnxruntime"), OnnxFilter)


def test_bad_file_raises_filter_error(tmp_path):
    bad = tmp_path / "junk.onnx"
    bad.write_bytes(b"\x07" * 32)
    with pytest.raises(FilterError, match="onnx"):
        FilterSingle(framework="onnx", model=str(bad), device="cpu")


def test_onnx_filter_hands_other_files_to_torch_cuda(tmp_path):
    """The importer's load seam passes any other extension to the
    torch-cuda loader, which names what it refuses."""
    path = tmp_path / "m.mlir"
    path.write_bytes(b"\0")
    with pytest.raises(FilterError, match="serialized XLA"):
        FilterSingle(framework="onnx", model=str(path), device="cpu")


def _two_input_model(path: str, second_read: bool) -> str:
    """y = x + c (x the last graph input); ``second_read`` also adds the
    first input ``a``."""
    nodes = [mf._onnx_node("Add", ["x", "c"], ["t"], "add0")]
    if second_read:
        nodes.append(mf._onnx_node("Add", ["t", "a"], ["y"], "add1"))
    else:
        nodes.append(mf._onnx_node("Relu", ["t"], ["y"], "relu"))
    blob = mf._onnx_model(
        nodes, {"c": np.arange(4, dtype=np.float32)},
        [mf._onnx_value_info("a", 1, [1, 4]),
         mf._onnx_value_info("x", 1, [1, 4])],
        [mf._onnx_value_info("y", 1, [1, 4])])
    with open(path, "wb") as f:
        f.write(blob)
    return path


def test_second_graph_input_read_is_refused_at_load(tmp_path):
    """The JAX importer binds only the last graph input; a graph whose
    nodes read another one is refused at load here, naming the inputs.
    An unread extra input is bound as the JAX package binds it."""
    bad = _two_input_model(str(tmp_path / "two.onnx"), True)
    with pytest.raises(FilterError, match=r"\['a', 'x'\].*\['a'\]"):
        FilterSingle(framework="onnx", model=bad, device="cpu")
    ok = _two_input_model(str(tmp_path / "one.onnx"), False)
    x = np.array([[-5, 1, -1, 2]], np.float32)
    np.testing.assert_array_equal(_port(ok, x), _jax(ok, x))
    np.testing.assert_array_equal(_port(ok, x), [[0, 2, 1, 5]])


def test_hot_reload_of_an_imported_model(files):
    """``is-updatable``: a RELOAD to another .onnx file builds the shadow
    as an OnnxFilter (the importer's load seam), and the flipped filter
    serves the new file's logits."""
    _, x = _frames(2)
    sp = OnnxFilter()
    sp.configure(FilterProps(framework="onnx", model=files["q"],
                             custom="qmode:int8", is_updatable=True,
                             device=torch.device("cpu")))
    xt = torch.from_numpy(x)
    before = sp.invoke([xt])[0].numpy()
    sp.handle_event(Event(EventKind.RELOAD_MODEL,
                          data={"model": files["q2"]}))
    after = sp.invoke([xt])[0].numpy()
    np.testing.assert_array_equal(
        before, _port(files["q"], x, custom="qmode:int8"))
    np.testing.assert_array_equal(
        after, _port(files["q2"], x, custom="qmode:int8"))
    assert not np.array_equal(before, after)
    assert sp.model_name() == files["q2"]


def test_imported_model_on_a_mesh(files):
    """``mesh=data:2`` over virtual host devices: the batch splits over
    the data shards, and every row equals the unsharded run."""
    from nnstreamer_tpu_torch.parallel import mesh as _mesh

    _, x = _frames(4)
    _mesh.set_virtual_devices(8, "cpu")
    try:
        fs = FilterSingle(framework="onnx", model=files["q"], device="cpu",
                          custom="qmode:int8", mesh="data:2",
                          input_spec=TensorsSpec.from_shapes(
                              [(4, 3, SIZE, SIZE)], np.float32))
        assert fs.subplugin._placement is not None
        got = fs.invoke([x])[0].numpy()
    finally:
        _mesh.clear_virtual_devices()
    np.testing.assert_array_equal(got, _port(files["q"], x,
                                             custom="qmode:int8"))


@pytest.mark.parametrize("tgt,shape,batch,src", [
    ((1, -1), (4, 10), 4, None),       # wildcard tail: the batch pinned
    ((1, -1), (3, 10), 4, None),       # not divisible: left as it is
    ((1, 10), (4, 10), 4, None),       # per-sample count matches
    ((1, 10), (2, 20), 4, None),       # it does not: concrete
    ((1, 1001), (8, 1, 1, 1001), 8, (1, 1, 1, 1001)),  # recorded source
    ((1, 1001), (8, 1001), 8, (2, 1001)),              # source not batch
    ((2, -1), (4, 10), 4, None),       # no leading 1
    ((), (4,), 4, None),
])
def test_batch_flex_target_matches_jax(tgt, shape, batch, src):
    """``importer_util.batch_flex_target``, the ADVICE quirk included (the
    batch guessed beside a wildcard), is the JAX function's copy."""
    from nnstreamer_tpu.filters.importer_util import batch_flex_target as j
    from nnstreamer_tpu_torch.filters.importer_util import (
        batch_flex_target as t,
    )

    assert t(tgt, shape, batch, src) == j(tgt, shape, batch, src)


def test_imported_model_pooled_with_share_model(files):
    """``share-model=true``: two streams on one .onnx file share one pool
    (one OnnxFilter instance), windows of 2 frames fold into the model's
    batch, and every frame's int8 logits equal the JAX filter's on that
    frame alone."""
    import threading

    from nnstreamer_tpu_torch.runtime import serving

    desc = (f"appsrc name=src ! tensor_filter name=net framework=onnx "
            f"model={files['q']} custom=qmode:int8 share-model=true "
            f"batch=2 batch-timeout-ms=50 batch-buckets=2 ! "
            f"appsink name=out max-buffers=16")
    _, x = _frames(4, seed=11)
    frames = [x[i:i + 1] for i in range(4)]
    pipes = [parse_launch(desc, device="cpu") for _ in range(2)]
    try:
        for p in pipes:
            p["src"].spec = TensorsSpec.from_shapes([(1, 3, SIZE, SIZE)],
                                                    np.float32)
            p.start()
        assert pipes[0]["net"].pool_streams == 2
        assert pipes[0]["net"].subplugin is pipes[1]["net"].subplugin
        assert isinstance(pipes[0]["net"].subplugin, OnnxFilter)

        def produce(p, mine):
            for i, f in enumerate(mine):
                p["src"].push_buffer(Buffer.of(f, pts=i))
            p["src"].end_of_stream()

        threads = [threading.Thread(target=produce,
                                    args=(p, frames[2 * k:2 * k + 2]))
                   for k, p in enumerate(pipes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for k, p in enumerate(pipes):
            assert p.wait_eos(timeout=120)
            for i in range(2):
                got = p["out"].pull(timeout=5).tensors[0].np()
                want = _jax(files["q"], frames[2 * k + i],
                            custom="qmode:int8")
                np.testing.assert_array_equal(got, want)
    finally:
        for p in pipes:
            p.stop()
        serving.MODEL_POOL.clear()
