"""The port's ``pytorch`` (TorchScript), ``custom-easy`` and ``python3``
filters against the JAX package's, on the CPU.

1. The scenarios of ``tests/test_pytorch.py`` through both packages
   (``pkg``): a scripted MLP against its eager forward (rtol 1e-5 + atol
   1e-6), the output spec re-inferred on a reshape, a rejected reshape
   keeping the old specs, the missing input spec and a bad file refused,
   and ``framework=auto`` from the ``.pt`` extension in a pipeline.  The
   same TorchScript file gives equal outputs through both packages.
2. The port's device handling: the module runs on the filter's device
   (the pipeline's, or ``accelerator=``) and returns tensors there; a
   bf16 output maps to ``bfloat16`` through the port's dtype table and
   stays a torch tensor (no numpy bf16 type is needed).
3. A reduced-width MobileNetV1 (width 0.25, 10 classes, 32x32) from JAX
   weights, traced to TorchScript (``trace_classifier``) and run through
   the port's ``pytorch`` filter at f32, against the JAX package's
   ``mobilenet_v1_apply``: atol 1e-4 + rtol 1e-4, the tolerance of the
   eager f32 forwards (``tests/test_torch_classify.py``); the traced
   module equals the eager module exactly on the CPU, and its graph holds
   the padding as constants (no size arithmetic to read back).
4. The host filters take numpy arrays: a buffer of torch tensors reaches
   ``custom-easy`` and ``python3`` as numpy arrays through one
   ``drain_once`` a buffer, and their outputs equal the JAX package's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu.core as jcore
import nnstreamer_tpu.elements.filter as jfilter
import nnstreamer_tpu.filters.api as japi
import nnstreamer_tpu.runtime as jruntime
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.elements.filter as tfilter_el
import nnstreamer_tpu_torch.filters.api as tapi
from nnstreamer_tpu.filters.custom import register_custom_easy as jreg_easy
from nnstreamer_tpu.filters.custom import unregister_custom_easy as junreg
from nnstreamer_tpu.models import mobilenet as jmob
from nnstreamer_tpu_torch.filters import (
    find_filter,
    register_custom_easy,
    unregister_custom_easy,
)
from nnstreamer_tpu_torch.models import convert, trace_classifier
from nnstreamer_tpu_torch.models.mobilenet import mobilenet_v1_apply
from nnstreamer_tpu_torch.runtime import parse_launch as _tparse


def tparse(desc):
    return _tparse(desc, device="cpu")


class PortSingle:
    """The port's single-shot invoke of a framework (the JAX package's
    ``FilterSingle``), on the CPU."""

    def __init__(self, framework="auto", model=None, **kw):
        self.subplugin = find_filter(framework)()
        self.subplugin.configure(tapi.FilterProps(
            framework=framework, model=model,
            device=torch.device("cpu"), **kw))
        self.in_spec, self.out_spec = self.subplugin.get_model_info()

    def invoke(self, inputs):
        return [o.numpy() for o in self.subplugin.invoke(
            [torch.from_numpy(np.asarray(x)) for x in inputs])]

    def set_input_info(self, spec):
        self.in_spec, self.out_spec = self.subplugin.set_input_info(spec)


PKGS = {
    "jax": (jfilter.FilterSingle, jcore, japi.FilterError,
            jruntime.parse_launch),
    "port": (PortSingle, tcore, tapi.FilterError, tparse),
}


@pytest.fixture(scope="module")
def scripted_mlp(tmp_path_factory):
    torch.manual_seed(0)
    m = torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    path = tmp_path_factory.mktemp("pt") / "mlp.pt"
    torch.jit.script(m).save(str(path))
    return str(path), m


# -- 1. tests/test_pytorch.py in both packages --------------------------------

@pytest.mark.parametrize("pkg", list(PKGS))
class TestSingleShot:
    def test_invoke_matches_eager(self, pkg, scripted_mlp):
        Single, core, _, _ = PKGS[pkg]
        path, m = scripted_mlp
        fs = Single(framework="pytorch", model=path,
                    input_spec=core.TensorsSpec.parse("8:2", "float32"))
        assert fs.out_spec.tensors[0].dims == (4, 2)
        x = np.random.default_rng(1).standard_normal((2, 8)).astype(
            np.float32)
        out = fs.invoke([x])[0]
        with torch.no_grad():
            want = m(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5,
                                   atol=1e-6)

    def test_reshape_reinfers_output(self, pkg, scripted_mlp):
        Single, core, _, _ = PKGS[pkg]
        fs = Single(framework="pytorch", model=scripted_mlp[0],
                    input_spec=core.TensorsSpec.parse("8:2", "float32"))
        fs.set_input_info(core.TensorsSpec.parse("8:5", "float32"))
        out = fs.invoke([np.zeros((5, 8), np.float32)])[0]
        assert np.asarray(out).shape == (5, 4)

    def test_incompatible_reshape_raises_filter_error(self, pkg,
                                                      scripted_mlp):
        Single, core, FilterError, _ = PKGS[pkg]
        fs = Single(framework="pytorch", model=scripted_mlp[0],
                    input_spec=core.TensorsSpec.parse("8:2", "float32"))
        with pytest.raises(FilterError, match="rejects input"):
            fs.set_input_info(core.TensorsSpec.parse("7:2", "float32"))
        assert fs.subplugin._in_spec.tensors[0].dims == (8, 2)
        assert fs.subplugin._out_spec.tensors[0].dims == (4, 2)

    def test_missing_input_spec_rejected(self, pkg, scripted_mlp):
        Single, _, FilterError, _ = PKGS[pkg]
        with pytest.raises(FilterError, match="input spec"):
            Single(framework="pytorch", model=scripted_mlp[0])

    def test_bad_file_rejected(self, pkg, tmp_path):
        Single, core, FilterError, _ = PKGS[pkg]
        bad = tmp_path / "junk.pt"
        bad.write_bytes(b"\x00" * 32)
        with pytest.raises(FilterError):
            Single(framework="pytorch", model=str(bad),
                   input_spec=core.TensorsSpec.parse("8:2", "float32"))

    def test_auto_detected_from_extension(self, pkg, scripted_mlp):
        _, core, _, parse = PKGS[pkg]
        path, m = scripted_mlp
        p = parse(f"appsrc name=src ! tensor_filter model={path} "
                  "input=8:2 inputtype=float32 ! appsink name=out")
        p["src"].spec = core.TensorsSpec.parse("8:2", "float32", rate=0)
        x = np.random.default_rng(2).standard_normal((2, 8)).astype(
            np.float32)
        with p:
            p["src"].push_buffer(core.Buffer.of(x))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
            out = p["out"].pull(timeout=2)
        with torch.no_grad():
            want = m(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out[0].np(), want, rtol=1e-5, atol=1e-6)


def test_same_file_equal_through_both_packages(scripted_mlp):
    path, _ = scripted_mlp
    x = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
    outs = []
    for Single, core, _, _ in PKGS.values():
        fs = Single(framework="pytorch", model=path,
                    input_spec=core.TensorsSpec.parse("8:2", "float32"))
        outs.append(np.asarray(fs.invoke([x])[0]))
    np.testing.assert_array_equal(outs[0], outs[1])


# -- 2. the port's device handling -------------------------------------------------

def test_outputs_stay_tensors_on_filter_device(scripted_mlp):
    path, _ = scripted_mlp
    sp = find_filter("pytorch")()
    sp.configure(tapi.FilterProps(
        framework="pytorch", model=path, accelerator="true:cpu",
        device=None, input_spec=tcore.TensorsSpec.parse("8:2", "float32")))
    assert sp.device == torch.device("cpu")
    out = sp.invoke([torch.zeros(2, 8)])
    assert isinstance(out[0], torch.Tensor) and out[0].device == sp.device


def test_pipeline_keeps_filter_output_as_tensor(scripted_mlp):
    path, _ = scripted_mlp
    p = tparse(f"appsrc name=src ! tensor_filter framework=pytorch "
               f"model={path} input=8:2 inputtype=float32 ! "
               "appsink name=out")
    p["src"].spec = tcore.TensorsSpec.parse("8:2", "float32")
    with p:
        p["src"].push_buffer(tcore.Buffer.of(torch.ones(2, 8)))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
        out = p["out"].pull(timeout=2)
    assert out.tensors[0].is_device
    assert out.tensors[0].spec.dims == (4, 2)


class _Half(torch.nn.Module):
    def forward(self, x):
        return x.to(torch.bfloat16) * 2


def test_bf16_output_maps_through_port_dtypes(tmp_path):
    path = str(tmp_path / "half.pt")
    torch.jit.script(_Half()).save(path)
    fs = PortSingle(framework="pytorch", model=path,
                    input_spec=tcore.TensorsSpec.parse("3", "float32"))
    assert str(fs.out_spec.tensors[0].dtype) == "bfloat16"
    out = fs.subplugin.invoke([torch.tensor([1.0, 2.0, 3.0])])[0]
    assert out.dtype == torch.bfloat16 and out.tolist() == [2.0, 4.0, 6.0]


# -- 3. MobileNetV1 through TorchScript -----------------------------------------------

WIDTH, CLASSES, SIZE, BATCH = 0.25, 10, 32, 2


@functools.lru_cache(maxsize=None)
def _mobilenet_tree():
    return jax.tree_util.tree_map(np.asarray, jmob.mobilenet_v1_init(
        jax.random.PRNGKey(0), CLASSES, WIDTH))


def test_mobilenet_torchscript_against_jax(tmp_path):
    tree = _mobilenet_tree()
    model = convert.mobilenet_v1_from_jax(tree)
    path = str(tmp_path / "mobilenet_v1.pt")
    trace_classifier(model, (BATCH, SIZE, SIZE, 3), torch.float32).save(path)
    x = np.random.default_rng(4).uniform(
        -1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jmob.mobilenet_v1_apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        dtype=jnp.float32))
    p = tparse(f"appsrc name=src ! tensor_filter framework=pytorch "
               f"model={path} input=3:{SIZE}:{SIZE}:{BATCH} "
               "inputtype=float32 ! appsink name=out")
    p["src"].spec = tcore.TensorsSpec.parse(f"3:{SIZE}:{SIZE}:{BATCH}",
                                            "float32")
    with p:
        p["src"].push_buffer(tcore.Buffer.of(torch.from_numpy(x)))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=120)
        got = p["out"].pull(timeout=2).tensors[0].np()
    assert got.shape == (BATCH, CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        eager = mobilenet_v1_apply(model, torch.from_numpy(x),
                                   torch.float32).numpy()
    np.testing.assert_array_equal(got, eager)


def test_traced_classifier_holds_no_shape_arithmetic():
    """The trace fixes the input shape, so the SAME padding amounts are
    constants in the graph: traced size arithmetic would be read back
    from the card at every pad (a device→host copy and a wait each)."""
    model = convert.mobilenet_v1_from_jax(_mobilenet_tree())
    graph = trace_classifier(model, (BATCH, SIZE, SIZE, 3)).inlined_graph
    kinds = {n.kind() for n in graph.nodes()}
    assert "aten::pad" in kinds
    assert not kinds & {"aten::size", "aten::Int", "prim::NumToTensor"}


# -- 4. host filters ----------------------------------------------------------------

def test_custom_easy_gets_numpy_through_one_drain(monkeypatch):
    spec = tcore.TensorsSpec.parse("4,4", "float32,int32")
    seen = []

    def fn(xs):
        seen.append([type(x) for x in xs])
        return [xs[0] * 2 + xs[1]]

    drains = []
    real = tfilter_el.drain_once
    monkeypatch.setattr(tfilter_el, "drain_once",
                        lambda ts: drains.append(len(ts)) or real(ts))
    register_custom_easy("port_axpy", fn, spec,
                         tcore.TensorsSpec.parse("4", "float32"))
    jreg_easy("port_axpy", lambda xs: [xs[0] * 2 + xs[1]],
              jcore.TensorsSpec.parse("4,4", "float32,int32"),
              jcore.TensorsSpec.parse("4", "float32"))
    a = np.arange(4, dtype=np.float32)
    b = np.arange(4, dtype=np.int32) * 3
    try:
        outs = []
        for pkg, parse, core, arr in (
                ("jax", jruntime.parse_launch, jcore, lambda v: v),
                ("port", tparse, tcore, torch.from_numpy)):
            p = parse("appsrc name=src ! tensor_filter framework=custom-easy "
                      "model=port_axpy ! appsink name=out")
            p["src"].spec = core.TensorsSpec.parse("4,4", "float32,int32")
            with p:
                p["src"].push_buffer(core.Buffer.of(arr(a), arr(b)))
                p["src"].end_of_stream()
                assert p.wait_eos(timeout=60)
                outs.append(p["out"].pull(timeout=2).tensors[0].np())
    finally:
        unregister_custom_easy("port_axpy")
        junreg("port_axpy")
    assert seen == [[np.ndarray, np.ndarray]] and drains == [2]
    np.testing.assert_array_equal(outs[0], outs[1])


PY_FILTER = (
    "import numpy as np\n"
    "class CustomFilter:\n"
    "    def __init__(self, *args):\n"
    "        self.args = args\n"
    "    def getInputDim(self):\n"
    "        return ('4', 'float32')\n"
    "    def getOutputDim(self):\n"
    "        return [((4,), np.float32), ('1', 'int32')]\n"
    "    def setInputDim(self, spec):\n"
    "        n = spec.tensors[0].dims[0]\n"
    "        return [((n,), np.float32), ('1', 'int32')]\n"
    "    def invoke(self, xs):\n"
    "        assert isinstance(xs[0], np.ndarray)\n"
    "        return [xs[0][::-1].copy(), np.array([len(self.args)],\n"
    "                                              np.int32)]\n")


@pytest.mark.parametrize("n", [4, 6])
def test_python3_filter_both_packages(tmp_path, n):
    """A script with getInputDim/getOutputDim/setInputDim and a custom=
    argument; at n=6 the element takes the setInputDim reshape."""
    script = tmp_path / "rev.py"
    script.write_text(PY_FILTER)
    x = np.arange(n, dtype=np.float32)
    outs = []
    for parse, core, arr in ((jruntime.parse_launch, jcore, lambda v: v),
                             (tparse, tcore, torch.from_numpy)):
        p = parse(f"appsrc name=src ! tensor_filter framework=python3 "
                  f"model={script} custom=hello ! appsink name=out")
        p["src"].spec = core.TensorsSpec.parse(str(n), "float32")
        with p:
            p["src"].push_buffer(core.Buffer.of(arr(x)))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
            b = p["out"].pull(timeout=2)
        outs.append([t.np() for t in b.tensors])
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(outs[1][0], x[::-1])
    assert outs[1][1].tolist() == [1]
