"""The ``tensorflow-lite`` importer of the port against the JAX package's.

The reference's mobilenet_v2_1.0_224_quant.tflite is not in the
repository, so ``tests/torch_model_files.py`` writes a uint8 MobileNetV2 in
its layout from seeded weights: width 0.25 at 32x32 for the parity cases,
and once at full width, where the JAX parser's own structure checks apply
(65 operators over its five op kinds, a quantized (1,224,224,3) input).
Both packages' filters (``FilterSingle`` and ``parse_launch``) take the
same files and frames from a numpy seed in every qmode, at batch 1 and 2:
equal outputs for ``dequant`` and within 1e-5 for ``float``/``bf16``/
``auto`` (the two packages' float sums may round in another order; bf16
results agree because each op rounds once to bf16 in both).  Where
``tensorflow`` imports, TFLite's own interpreter runs the same file: it
requantizes in fixed point where the importers use float, so the codes
part by a few quanta over 65 ops — its logits must correlate above 0.98
with the port's, sit within 6 quanta of them on average, and agree on the
top class.  ``tests/test_tflite.py``'s cases that need no asset run on the
port by ``torch_replay``.
"""

import numpy as np
import pytest
import torch
import torch_model_files as mf
from torch_replay import replay

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import TensorsSpec as JSpec
from nnstreamer_tpu.elements.filter import FilterSingle as JSingle
from nnstreamer_tpu.filters.tflite_import import TFLiteModel as JModel
from nnstreamer_tpu.runtime import parse_launch as jparse
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.elements.filter import FilterSingle
from nnstreamer_tpu_torch.filters import FilterProps
from nnstreamer_tpu_torch.filters.tflite import TFLiteFilter
from nnstreamer_tpu_torch.filters.tflite_import import TFLiteModel
from nnstreamer_tpu_torch.runtime import parse_launch
from nnstreamer_tpu_torch.runtime.events import Event, EventKind

replay("test_tflite.py", globals(), only=["TestImporter"], subs=(
    ('FilterSingle(framework="tensorflow-lite", model=str(bad))',
     'FilterSingle(framework="tensorflow-lite", model=str(bad), '
     'device="cpu")'),))

SIZE, WIDTH, CLASSES = 32, 0.25, 1001
QMODES = ["auto", "bf16", "dequant", "float"]


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
    d = tmp_path_factory.mktemp("tflite")
    return {"q": mf.write_tflite_quant(str(d / "q.tflite"), 0, WIDTH, SIZE,
                                       CLASSES),
            "q2": mf.write_tflite_quant(str(d / "q2.tflite"), 1, WIDTH,
                                        SIZE, CLASSES),
            "dir": d}


def _frames(batch: int, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (batch, SIZE, SIZE, 3), dtype=np.uint8)


def _port(path, x, **kw):
    return FilterSingle(framework="tensorflow-lite", model=path, device="cpu",
                        **kw).invoke([x])[0].numpy()


def _jax(path, x, **kw):
    return np.asarray(JSingle(framework="tensorflow-lite", model=path,
                              **kw).invoke([x])[0])


def test_full_width_file_passes_the_jax_structure_checks(tmp_path):
    """``tests/test_tflite.py::test_parse_structure``'s assertions, on the
    writer's full-width file, through both packages' parsers."""
    path = mf.write_tflite_quant(str(tmp_path / "mnv2.tflite"))
    for model in (JModel(path), TFLiteModel(path)):
        assert len(model.operators) == 65
        assert {o["op"] for o in model.operators} == {
            "ADD", "AVERAGE_POOL_2D", "CONV_2D", "DEPTHWISE_CONV_2D",
            "RESHAPE"}
        t = model.tensors[model.inputs[0]]
        assert list(t.shape) == [1, 224, 224, 3]
        assert t.scale is not None  # quantized input
        out = model.tensors[model.outputs[0]]
        assert list(out.shape) == [1, 1001] and out.ttype == 3  # uint8
    fused = [JModel(path)._fb.scalar(o["options"], 3, "u8")
             for o in JModel(path).operators if o["op"] == "CONV_2D"]
    assert 3 in fused  # RELU6 fused into the convolutions


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("qmode", QMODES)
def test_quant_file_matches_jax_filter(files, qmode, batch):
    x = _frames(batch)
    got = _port(files["q"], x, custom=f"qmode:{qmode}")
    want = _jax(files["q"], x, custom=f"qmode:{qmode}")
    assert got.shape == want.shape == (batch, CLASSES)
    assert got.dtype == np.float32
    if qmode == "dequant":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if batch == 2:
        assert np.abs(got[0] - got[1]).max() > 0.1


def test_dequant_at_96_matches_jax_filter(tmp_path):
    """At 96x96 AVERAGE_POOL_2D averages 3x3 cells: ``dequant`` stays
    exact against the JAX package (the pool sums in one fixed order, as
    ``reduce_window`` does)."""
    path = mf.write_tflite_quant(str(tmp_path / "q96.tflite"), 0, WIDTH,
                                 96, CLASSES)
    x = np.random.default_rng(3).integers(0, 256, (2, 96, 96, 3),
                                          dtype=np.uint8)
    np.testing.assert_array_equal(_port(path, x, custom="qmode:dequant"),
                                  _jax(path, x, custom="qmode:dequant"))


def test_auto_is_bf16_on_a_quantized_graph(files):
    """``auto`` copies the JAX package's choice: bf16 real values on a
    quantized graph (approximate; ``dequant`` is the exact mode)."""
    x = _frames(2)
    np.testing.assert_array_equal(_port(files["q"], x),
                                  _port(files["q"], x, custom="qmode:bf16"))
    assert not np.array_equal(_port(files["q"], x),
                              _port(files["q"], x, custom="qmode:dequant"))


def test_dequant_takes_a_float_input(files):
    """A float frame (an upstream transform's) is requantized at the
    graph's input in ``dequant`` mode, in both packages alike."""
    x = _frames(1).astype(np.float32) / 128.0 - 1.0
    got = _port(files["q"], x, custom="qmode:dequant",
                input_spec=TensorsSpec.from_shapes([x.shape], np.float32))
    want = _jax(files["q"], x, custom="qmode:dequant",
                input_spec=JSpec.from_shapes([x.shape], np.float32))
    np.testing.assert_array_equal(got, want)


def test_parse_launch_matches_jax_pipeline(files):
    """Raw frames → the tflite filter auto-detected from the extension →
    appsink, in both packages."""
    x = _frames(2)
    outs = {}
    for pkg, parse, buf, spec in (("jax", jparse, JBuffer, JSpec),
                                  ("port", parse_launch, Buffer,
                                   TensorsSpec)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        p = parse(f"appsrc name=src ! tensor_filter name=net "
                  f"model={files['q']} custom=qmode:dequant ! "
                  f"appsink name=out", **kw)
        p["src"].spec = spec.parse(f"3:{SIZE}:{SIZE}:2", "uint8")
        with p:
            p["src"].push_buffer(buf.of(x))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=120)
            outs[pkg] = np.asarray(p["out"].pull(timeout=5).tensors[0].np())
    np.testing.assert_array_equal(outs["port"], outs["jax"])


@pytest.mark.parametrize("seed", [0, 1])
def test_tflite_interpreter_agrees(files, tmp_path, seed):
    """A third party reads the writer's file: TFLite's own interpreter."""
    tf = pytest.importorskip("tensorflow")
    path = files["q"] if seed == 0 else files["q2"]
    it = tf.lite.Interpreter(model_path=path)
    it.allocate_tensors()
    inp, out = it.get_input_details()[0], it.get_output_details()[0]
    assert list(inp["shape"]) == [1, SIZE, SIZE, 3]
    x = _frames(1, seed + 10)
    it.set_tensor(inp["index"], x)
    it.invoke()
    s, z = out["quantization"]
    want = (it.get_tensor(out["index"]).astype(np.float32) - z) * s
    got = _port(path, x, custom="qmode:dequant")
    assert np.corrcoef(got[0], want[0])[0, 1] > 0.98
    assert np.abs(got - want).mean() <= 6 * s
    assert got.argmax() == want.argmax()


def test_hot_reload_of_an_imported_model(files):
    x = torch.from_numpy(_frames(2))
    sp = TFLiteFilter()
    sp.configure(FilterProps(framework="tensorflow-lite", model=files["q"],
                             custom="qmode:dequant", is_updatable=True,
                             device=torch.device("cpu")))
    before = sp.invoke([x])[0].numpy()
    sp.handle_event(Event(EventKind.RELOAD_MODEL,
                          data={"model": files["q2"]}))
    after = sp.invoke([x])[0].numpy()
    np.testing.assert_array_equal(
        after, _port(files["q2"], x.numpy(), custom="qmode:dequant"))
    assert not np.array_equal(before, after)


def test_imported_model_on_a_mesh(files):
    """``tests/test_tflite.py::TestMeshPlacement`` on the writer's file:
    ``mesh=data:2`` over virtual host devices, every shard's rows equal
    to the unsharded run."""
    from nnstreamer_tpu_torch.parallel import mesh as _mesh

    x = _frames(4)
    _mesh.set_virtual_devices(8, "cpu")
    try:
        fs = FilterSingle(framework="tensorflow-lite", model=files["q"],
                          device="cpu", custom="qmode:dequant",
                          mesh="data:2", input_spec=TensorsSpec.from_shapes(
                              [(4, SIZE, SIZE, 3)], np.uint8))
        assert fs.subplugin._placement is not None
        got = fs.invoke([x])[0].numpy()
    finally:
        _mesh.clear_virtual_devices()
    assert got.shape[0] == 4
    np.testing.assert_array_equal(got, _port(files["q"], x,
                                             custom="qmode:dequant"))


def test_framework_autodetect_and_alias(files):
    from nnstreamer_tpu_torch.filters.registry import (
        detect_framework,
        find_filter,
    )

    assert detect_framework(files["q"]) == "tensorflow-lite"
    assert issubclass(find_filter("tensorflow2-lite"), TFLiteFilter)
