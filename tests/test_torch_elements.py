"""The port's stream elements and custom filters against the JAX
package's, on the CPU.

1. Golden replay: the committed goldens of these elements
   (``custom_easy_scaler``, ``python3_filter``, ``mux_aggregate``,
   ``demux_tensorpick``, ``split_tensorseg``, ``if_passthrough_else_fill``,
   ``if_tensor_average``, ``sparse_roundtrip``, ``aggregator_window``,
   ``rate_downsample``, ``datarepo_roundtrip``, ``sensor_src``) run their
   own case code from ``tests/golden_cases.py`` with the port's
   ``parse_launch(device="cpu")``, ``TensorsSpec``, ``Buffer`` and
   ``register_custom_easy`` in place of the JAX package's, and reproduce
   the committed files byte for byte.  ``repo_loop`` resets the JAX
   package's slot table inside its case, so its pipeline is built here
   with the port's ``REPO``.
2. Registries: the port's element factories are the JAX package's except
   ``tensor_trainer`` and the edge elements (ROADMAP items 7 and 5); its
   filter frameworks are the JAX package's with ``torch-cuda`` in place
   of ``jax-xla`` and without the three importers.
3. ``utils/conf.py`` (environment over ini over defaults, each package
   under its own keys: the JAX package's leave the port unchanged) and
   ``config-file=`` precedence, in both packages: the file overrides
   constructor values, an explicit pipeline-string key overrides the
   file.
4. The sparse codec: for every dtype (bfloat16 included), with NaN and
   -0.0, the port's bytes equal the JAX codec's, from a host tensor and
   from a torch tensor (the path a device tensor takes), and the decode
   is byte-equal too.
5. Shared storage: a ``tensor_transform donate=true`` downstream of
   ``tensor_demux`` with a repeated pick, ``tensor_split``, ``tensor_if``
   repeating a frame, ``tensor_aggregator concat=false`` with overlapping
   windows, ``tensor_mux sync-mode=refresh`` and ``tensor_rate``
   duplicating a frame never writes into a tensor another consumer
   holds: each sibling reads its frame unchanged.
6. ``tensor_if``'s device path: one scalar copy a verdict, fills made on
   the frame's device with its dtype, an error in the device reduction
   raised (no retry on the host), ``offload=`` validated.
7. ``identity``, ``tensor_sink``, ``fakesink`` and ``tensor_debug``.
8. ``chip_smoke.py`` phase 13's measures: the busy share as the union
   of kernel intervals over the device's span, the bf16 ulp of the
   TorchScript gate.
"""

import os
from fractions import Fraction

import numpy as np
import pytest
import torch

import golden_cases
import nnstreamer_tpu.core as jcore
import nnstreamer_tpu.core.buffer as jbuffer
import nnstreamer_tpu.filters.registry as jfilters
import nnstreamer_tpu.runtime as jruntime
import nnstreamer_tpu.utils.conf as jconf
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.core.buffer as tbuffer
import nnstreamer_tpu_torch.elements.condition as tcondition
import nnstreamer_tpu_torch.filters.registry as tfilters
import nnstreamer_tpu_torch.runtime as truntime
import nnstreamer_tpu_torch.utils.conf as tconf
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.elements.repo import REPO
from nnstreamer_tpu_torch.filters import register_custom_easy
from nnstreamer_tpu_torch.runtime import MessageKind, make
from nnstreamer_tpu_torch.runtime import parse_launch as _tparse


def tparse(desc):
    return _tparse(desc, device="cpu")


def _golden(case):
    with open(os.path.join(golden_cases.GOLDEN_DIR, f"{case}.golden"),
              "rb") as f:
        return f.read()


def drain(sink, timeout=0.2):
    out = []
    while True:
        b = sink.pull(timeout=timeout)
        if b is None:
            return out
        out.append(b)


# -- 1. goldens ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["custom_easy_scaler", "python3_filter",
                                  "mux_aggregate", "demux_tensorpick",
                                  "split_tensorseg",
                                  "if_passthrough_else_fill",
                                  "if_tensor_average", "sparse_roundtrip",
                                  "aggregator_window", "rate_downsample",
                                  "datarepo_roundtrip", "sensor_src"])
def test_golden_replay_byte_exact(case, tmp_path, monkeypatch):
    monkeypatch.setattr(golden_cases, "parse_launch", tparse)
    monkeypatch.setattr(golden_cases, "TensorsSpec", TensorsSpec)
    monkeypatch.setattr(golden_cases, "Buffer", Buffer)
    monkeypatch.setattr(golden_cases, "register_custom_easy",
                        register_custom_easy)
    out = str(tmp_path / f"{case}.out")
    getattr(golden_cases, f"case_{case}")(out)
    got, want = open(out, "rb").read(), _golden(case)
    assert got == want, f"{case}: {len(got)}B differs from golden " \
        f"({len(want)}B)"


def test_golden_repo_loop(tmp_path):
    """``repo_loop`` with the port's slot table (the case resets the JAX
    package's)."""
    REPO.reset()
    out = str(tmp_path / "repo.out")
    p = tparse(
        "tensor_reposrc name=loop slot=0 num_buffers=5 "
        "caps=other/tensors,format=static,num_tensors=1,"
        "dimensions=1,types=float32,framerate=0/1 ! "
        "tensor_transform mode=arithmetic option=add:1 ! "
        f"tee name=t ! tensor_reposink slot=0 t. ! filesink location={out}")
    with p:
        assert p.wait_eos(timeout=120), "repo loop did not reach EOS"
    assert open(out, "rb").read() == _golden("repo_loop")


# -- 2. registries -------------------------------------------------------------

def _builtin(names, lookup, prefix, skip=()):
    """The names a package's own modules registered (tests register
    more), minus those from the modules in ``skip``."""
    out = set()
    for n in names:
        mod = lookup(n).__module__
        if mod.startswith(prefix) and not mod.startswith(tuple(skip)):
            out.add(n)
    return out


def test_element_registry_matches_jax_package():
    jax = _builtin(jruntime.list_elements(), jruntime.element_factory,
                   "nnstreamer_tpu.")
    port = _builtin(truntime.list_elements(), truntime.element_factory,
                    "nnstreamer_tpu_torch.")
    assert port == jax


def test_filter_registry_matches_jax_package():
    """The importers (onnx, tflite, tensorflow, with their alias names)
    wait for ROADMAP item 3b; torch-cuda stands where jax-xla does."""
    jax = _builtin(jfilters.list_filters(), jfilters.find_filter,
                   "nnstreamer_tpu.filters.",
                   skip=("nnstreamer_tpu.filters.onnx",
                         "nnstreamer_tpu.filters.tflite",
                         "nnstreamer_tpu.filters.tensorflow"))
    port = _builtin(tfilters.list_filters(), tfilters.find_filter,
                    "nnstreamer_tpu_torch.filters.")
    assert port == (jax - {"jax-xla"}) | {"torch-cuda"}


# -- 3. conf and config-file -----------------------------------------------------

CONF = {"jax": jconf, "port": tconf}
PARSE = {"jax": jruntime.parse_launch, "port": tparse}
MAKE = {"jax": jruntime.make, "port": make}


#: each package's environment keys: the port has its own
ENV = {"jax": "NNS_TPU_", "port": "NNS_TPU_TORCH_"}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_conf_layers_env_over_ini_over_default(pkg, tmp_path, monkeypatch):
    ini = tmp_path / "nns.ini"
    ini.write_text("[common]\nplugins = from_ini\n"
                   "[filter]\nframework_priority_tflite = a,b\n")
    env = ENV[pkg]
    monkeypatch.delenv(f"{env}COMMON_PLUGINS", raising=False)
    monkeypatch.delenv(f"{env}COMMON_ENABLE_ENVVAR", raising=False)
    c = CONF[pkg].Conf(str(ini))
    assert c.extra_plugin_modules == ["from_ini"]
    assert c.framework_priority(".tflite") == ["a", "b"]
    assert c.framework_priority(".py") == ["python3"]   # built-in default
    monkeypatch.setenv(f"{env}COMMON_PLUGINS", "x:y")
    assert c.extra_plugin_modules == ["x", "y"]
    monkeypatch.setenv(f"{env}COMMON_ENABLE_ENVVAR", "false")
    assert c.extra_plugin_modules == ["from_ini"]
    monkeypatch.delenv(f"{env}COMMON_ENABLE_ENVVAR")
    monkeypatch.setenv(f"{env}CONF_FILE", str(ini))
    assert CONF[pkg].Conf().path == str(ini)


def test_conf_jax_package_keys_leave_the_port_unchanged(tmp_path,
                                                         monkeypatch):
    """The JAX package's environment keys and ini file (plugins that
    import JAX modules, ``.pkl`` to ``jax-xla``) reach only the JAX
    package: the port's registry imports no such plugin and auto-detects
    ``.pkl`` as before; its own keys do reach it."""
    import sys

    import nnstreamer_tpu_torch.runtime.registry as tregistry

    plugin = "nns_conf_probe_plugin"
    (tmp_path / f"{plugin}.py").write_text("IMPORTED = True\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    ini = tmp_path / "jax.ini"
    ini.write_text(f"[common]\nplugins = {plugin}\n"
                   "[filter]\nframework_priority_pkl = jax-xla\n")
    for k in [k for k in os.environ if k.startswith(ENV["port"])]:
        monkeypatch.delenv(k)
    monkeypatch.setenv(f"{ENV['port']}CONF_FILE", str(tmp_path / "no.ini"))
    monkeypatch.setenv("NNS_TPU_CONF_FILE", str(ini))
    monkeypatch.setenv("NNS_TPU_COMMON_PLUGINS", plugin)
    monkeypatch.setenv("NNS_TPU_FILTER_FRAMEWORK_PRIORITY_PKL", "jax-xla")
    model = tmp_path / "m.pkl"
    model.write_bytes(b"")
    before = truntime.list_elements()
    monkeypatch.delitem(sys.modules, plugin, raising=False)
    monkeypatch.setattr(tregistry, "_scanned", False)
    try:
        tconf.get_conf(reload=True)
        assert jconf.Conf().extra_plugin_modules == [plugin]
        assert jconf.Conf().framework_priority("pkl") == ["jax-xla"]
        assert truntime.list_elements() == before
        assert plugin not in sys.modules
        assert tfilters.detect_framework(str(model)) == "torch-cuda"
        # the port's own key does reach it
        monkeypatch.setenv(f"{ENV['port']}COMMON_PLUGINS", plugin)
        monkeypatch.setattr(tregistry, "_scanned", False)
        tconf.get_conf(reload=True)
        truntime.list_elements()
        assert plugin in sys.modules
    finally:
        monkeypatch.undo()
        tconf.get_conf(reload=True)


def test_conf_port_defaults_name_port_frameworks(monkeypatch, tmp_path):
    monkeypatch.setenv("NNS_TPU_TORCH_CONF_FILE", str(tmp_path / "absent.ini"))
    c = tconf.Conf()
    assert c.framework_priority("safetensors") == ["torch-cuda"]
    assert c.framework_priority(".pt") == ["pytorch"]
    assert jconf.Conf().framework_priority("pkl") == ["jax-xla"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_config_file_precedence(pkg, tmp_path):
    cfg = tmp_path / "t.conf"
    cfg.write_text("# transform settings\n\nmode=arithmetic\n"
                   "option=mul:3.0\n")
    # constructor values: the file overrides them
    el = MAKE[pkg]("tensor_transform", el_name="t", config_file=str(cfg),
                   option="add:1")
    assert (el.mode, el.option) == ("arithmetic", "mul:3.0")
    # a pipeline string: the file fills in, an explicit key wins
    p = PARSE[pkg](f"appsrc name=src ! tensor_transform name=t "
                   f"config-file={cfg} option=add:1 ! appsink name=out")
    assert (p["t"].mode, p["t"].option) == ("arithmetic", "add:1")
    core = jcore if pkg == "jax" else tcore
    p["src"].spec = core.TensorsSpec.parse("2", "float32")
    with p:
        p["src"].push_buffer(core.Buffer.of(np.array([1, 2], np.float32)))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    np.testing.assert_array_equal(p["out"].pull(timeout=1).tensors[0].np(),
                                  [2, 3])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_config_file_bad_line_raises(pkg, tmp_path):
    cfg = tmp_path / "bad.conf"
    cfg.write_text("mode=arithmetic\njust words\n")
    with pytest.raises(ValueError, match="expected key=value"):
        MAKE[pkg]("tensor_transform", el_name="t", config_file=str(cfg))


def test_detect_framework_by_extension(tmp_path):
    for ext, fw in ((".pt", "pytorch"), (".py", "python3")):
        f = tmp_path / f"m{ext}"
        f.write_text("")
        assert tfilters.detect_framework(str(f)) == fw
        assert jfilters.detect_framework(str(f)) == fw
    assert tfilters.detect_framework(lambda xs: xs) == "custom-easy"


# -- 4. sparse codec -------------------------------------------------------------

DTYPES = ["int8", "uint8", "int16", "uint16", "int32", "uint32", "int64",
          "uint64", "float16", "float32", "float64", "bfloat16"]


def _sparse_data(name, seed=3):
    rng = np.random.default_rng(seed)
    dt = tcore.DType.from_string(name).np_dtype
    a = np.zeros((3, 5, 4), np.float64)
    mask = rng.random(a.shape) < 0.3
    a[mask] = rng.integers(1, 100, mask.sum())
    a = a.astype(dt)
    flat = a.reshape(-1)
    if np.issubdtype(dt, np.integer):
        flat[7] = np.iinfo(dt).max   # the top bit set for unsigned
        flat[8] = np.iinfo(dt).min
    else:
        flat[7], flat[8], flat[9] = np.nan, -0.0, -2.5
    return a


@pytest.mark.parametrize("name", DTYPES)
def test_sparse_codec_bytes_equal_jax(name):
    a = _sparse_data(name)
    want = jbuffer.sparse_from_dense(jcore.Tensor(a))
    assert tbuffer.sparse_from_dense(tcore.Tensor(a)) == want
    x = tbuffer.from_numpy(a)
    assert tbuffer.sparse_from_dense(tcore.Tensor(x)) == want
    dense = tbuffer.sparse_to_dense(want)
    assert dense.spec == tcore.Tensor(a).spec
    assert dense.tobytes() == jbuffer.sparse_to_dense(want).tobytes()
    if not np.issubdtype(a.dtype, np.integer):
        # NaN is stored, -0.0 is not (it decodes to +0.0): as numpy
        assert np.isnan(np.asarray(dense.np(), np.float64).reshape(-1)[7])
        assert dense.tobytes()[8 * a.itemsize:9 * a.itemsize] == \
            bytes(a.itemsize)


def test_sparse_all_zero_and_all_nonzero():
    for a in (np.zeros((6,), np.float32), np.arange(1, 7, dtype=np.int32)):
        want = jbuffer.sparse_from_dense(jcore.Tensor(a))
        assert tbuffer.sparse_from_dense(
            tcore.Tensor(torch.from_numpy(a))) == want


# -- 5. shared storage -------------------------------------------------------------

DONATE = "tensor_transform mode=arithmetic option=mul:2.0 donate=true"


def _run(desc, spec, bufs, sinks=("a", "b")):
    p = tparse(desc)
    p["src"].spec = spec
    with p:
        for b in bufs:
            p["src"].push_buffer(b)
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    return [drain(p[s]) for s in sinks]


def test_demux_repeated_pick_marks_shared():
    x = np.arange(1, 5, dtype=np.float32)
    data = torch.from_numpy(x.copy())
    a, b = _run("appsrc name=src ! tensor_demux name=d tensorpick=0,0 "
                f"d.src_0 ! {DONATE} ! appsink name=a "
                "d.src_1 ! appsink name=b",
                TensorsSpec.parse("4", "float32"), [Buffer.of(data)])
    np.testing.assert_array_equal(a[0].tensors[0].np(), x * 2)
    np.testing.assert_array_equal(b[0].tensors[0].np(), x)
    np.testing.assert_array_equal(data.numpy(), x)


def test_split_slices_marked_shared():
    x = np.arange(1, 7, dtype=np.float32)
    data = torch.from_numpy(x.copy())
    a, b = _run("appsrc name=src ! tensor_split name=s tensorseg=3:3 "
                f"dimension=0 s.src_0 ! {DONATE} ! appsink name=a "
                "s.src_1 ! appsink name=b",
                TensorsSpec.parse("6", "float32"), [Buffer.of(data)])
    assert a[0].tensors[0].is_device and b[0].tensors[0]._shared
    np.testing.assert_array_equal(a[0].tensors[0].np(), x[:3] * 2)
    np.testing.assert_array_equal(b[0].tensors[0].np(), x[3:])
    np.testing.assert_array_equal(data.numpy(), x)


def test_if_repeated_frame_marked_shared():
    """Frame 1 passes through the then-branch's donating transform; the
    branch then switches to REPEAT_PREVIOUS_FRAME, and frame 2 repeats
    frame 1, which must arrive as it was."""
    x1 = np.array([1, 2, 3, 4], np.float32)
    d1 = torch.from_numpy(x1.copy())
    p = tparse("appsrc name=src ! tensor_if name=i compared-value=A_VALUE "
               "compared-value-option=0:0 operator=gt supplied-value=0 "
               f"then=PASSTHROUGH else=SKIP i.src_then ! {DONATE} ! "
               "appsink name=a")
    p["src"].spec = TensorsSpec.parse("4", "float32")
    with p:
        p["src"].push_buffer(Buffer.of(d1))
        first = p["a"].pull(timeout=30)
        p["i"].set_property("then", "REPEAT_PREVIOUS_FRAME")
        p["src"].push_buffer(Buffer.of(torch.full((4,), 9.0)))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
        second = p["a"].pull(timeout=1)
    np.testing.assert_array_equal(first.tensors[0].np(), x1 * 2)
    np.testing.assert_array_equal(second.tensors[0].np(), x1 * 2)
    np.testing.assert_array_equal(d1.numpy(), x1)


def test_aggregator_overlapping_frames_marked_shared():
    frames = [torch.full((1, 2), float(i + 1)) for i in range(3)]
    p = tparse("appsrc name=src ! tensor_aggregator name=agg frames-in=1 "
               "frames-out=2 frames-flush=1 frames-dim=1 concat=false ! "
               f"{DONATE} ! appsink name=a")
    p["src"].spec = TensorsSpec.parse("2:1", "float32")
    windows, push = [], p["agg"].push
    p["agg"].push = lambda b, pad=None: (windows.append(b), push(b, pad))
    with p:
        for f in frames:
            p["src"].push_buffer(Buffer.of(f))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    got = [[t.np().tolist() for t in b.tensors] for b in drain(p["a"])]
    assert got == [[[[2.0, 2.0]], [[4.0, 4.0]]], [[[4.0, 4.0]], [[6.0, 6.0]]]]
    assert [f.tolist() for f in frames] == [[[1.0, 1.0]], [[2.0, 2.0]],
                                            [[3.0, 3.0]]]
    # the window's frames are views, which the transform never writes in
    # place anyway; the mark says so to every consumer
    assert all(t._shared for w in windows for t in w.tensors)


def test_mux_refresh_reused_buffer_marked_shared():
    x = np.array([5, 6], np.float32)
    data = torch.from_numpy(x.copy())
    p = tparse(f"tensor_mux name=m sync-mode=refresh ! {DONATE} ! "
               "appsink name=a appsrc name=s0 ! m.sink_0 "
               "appsrc name=s1 ! m.sink_1")
    for s in ("s0", "s1"):
        p[s].spec = TensorsSpec.parse("2", "float32")
    with p:
        p["s0"].push_buffer(Buffer.of(data))
        p["s1"].push_buffer(Buffer.of(torch.zeros(2)))
        assert p["a"].pull(timeout=30) is not None
        p["s1"].push_buffer(Buffer.of(torch.ones(2)))   # s0's frame again
        p["s0"].end_of_stream()
        p["s1"].end_of_stream()
        assert p.wait_eos(timeout=60)
        again = p["a"].pull(timeout=1)
    np.testing.assert_array_equal(again.tensors[0].np(), x * 2)
    np.testing.assert_array_equal(data.numpy(), x)


def test_rate_duplicate_marked_shared():
    x0 = np.array([1, 2], np.float32)
    d0 = torch.from_numpy(x0.copy())
    sec = 1_000_000_000
    (a,) = _run(f"appsrc name=src ! tensor_rate framerate=10/1 ! {DONATE} ! "
                "appsink name=a", TensorsSpec.parse("2", "float32",
                                                     rate=Fraction(5)),
                [Buffer.of(d0, pts=0), Buffer.of(torch.zeros(2),
                                                 pts=sec // 5)],
                sinks=("a",))
    assert [b.tensors[0].np().tolist() for b in a] == [[2, 4], [2, 4],
                                                       [0, 0]]
    np.testing.assert_array_equal(d0.numpy(), x0)


# -- 6. tensor_if on the device path ---------------------------------------------------

def _if_pipe(props):
    return tparse(f"appsrc name=src ! tensor_if name=i {props} "
                  "i.src_then ! appsink name=t i.src_else ! appsink name=e")


IF_VALUES = {
    # compared-value, its option, and the value numpy gives for a frame
    "A_VALUE": ("2:1", lambda a, b: float(b[2])),
    "TENSOR_TOTAL_VALUE": ("1", lambda a, b: float(b.sum())),
    "ALL_TENSORS_TOTAL": ("0", lambda a, b: float(a.sum() + b.sum())),
    "TENSOR_AVERAGE_VALUE": ("0", lambda a, b: float(a.mean())),
    "ALL_TENSORS_AVERAGE": ("0", lambda a, b: float(
        np.concatenate([a, b]).mean())),
}


@pytest.mark.parametrize("cv", list(IF_VALUES))
def test_if_one_scalar_copy_a_verdict(cv):
    """Device tensors reduce where they live: one scalar copy a frame, and
    the same routing as the JAX element on the same values (the threshold
    is the median value, so both branches are taken)."""
    rng = np.random.default_rng(5)
    frames = [(rng.integers(0, 9, 4).astype(np.int32),
               rng.standard_normal(6).astype(np.float32)) for _ in range(6)]
    opt, value = IF_VALUES[cv]
    k = float(np.median([value(a, b) for a, b in frames]))
    props = (f"compared-value={cv} compared-value-option={opt} "
             f"operator=ge supplied-value={k!r} then=PASSTHROUGH "
             "else=PASSTHROUGH")
    routes = {}
    for pkg, parse, core, arr in (
            ("jax", jruntime.parse_launch, jcore, lambda a: a),
            ("port", tparse, tcore, torch.from_numpy)):
        p = parse(f"appsrc name=src ! tensor_if name=i {props} "
                  "i.src_then ! appsink name=t i.src_else ! appsink name=e")
        p["src"].spec = core.TensorsSpec.parse("4,6", "int32,float32")
        with p:
            for i, (a, b) in enumerate(frames):
                p["src"].push_buffer(core.Buffer.of(arr(a), arr(b),
                                                    pts=i))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
        routes[pkg] = ([b.pts for b in drain(p["t"])],
                       [b.pts for b in drain(p["e"])])
        if pkg == "port":
            assert p["i"].verdict_copies == len(frames)
    assert routes["port"] == routes["jax"]
    assert len(routes["port"][0]) == 3 and len(routes["port"][1]) == 3


@pytest.mark.parametrize("beh,opt,val", [("FILL_ZERO", "", 0),
                                         ("FILL_VALUES", "7", 7)])
def test_if_fill_on_frame_device(beh, opt, val):
    p = _if_pipe("compared-value=A_VALUE compared-value-option=0:0 "
                 f"operator=gt supplied-value=100 else={beh} "
                 f"else-option={opt}")
    p["src"].spec = TensorsSpec.parse("3,2", "uint8,float32")
    with p:
        p["src"].push_buffer(Buffer.of(torch.tensor([1, 2, 3],
                                                    dtype=torch.uint8),
                                       torch.tensor([0.5, -1.0])))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    (b,) = drain(p["e"])
    assert all(t.is_device for t in b.tensors)
    assert b.tensors[0].torch().dtype == torch.uint8
    np.testing.assert_array_equal(b.tensors[0].np(), [val] * 3)
    np.testing.assert_array_equal(b.tensors[1].np(), [val] * 2)


def test_if_device_reduction_error_raises(monkeypatch):
    """The port does not retry a failed device reduction on the host."""
    def broken(*a, **k):
        raise RuntimeError("device reduction failed")

    monkeypatch.setattr(tcondition, "_reduce", broken)
    p = _if_pipe("compared-value=TENSOR_TOTAL_VALUE "
                 "compared-value-option=0 operator=gt supplied-value=0")
    p["src"].spec = TensorsSpec.parse("2", "float32")
    with p:
        p["src"].push_buffer(Buffer.of(torch.ones(2)))
        p["src"].end_of_stream()
        with pytest.raises(RuntimeError, match="device reduction failed"):
            p.wait_eos(timeout=60)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_if_offload_validated(pkg):
    el = MAKE[pkg]("tensor_if", el_name="i", offload="both")
    with pytest.raises(ValueError, match="offload"):
        el.start()


# -- 7. plumbing --------------------------------------------------------------------------

def test_identity_tensor_debug_tensor_sink():
    seen = []
    p = tparse("appsrc name=src ! identity ! tensor_debug name=dbg "
               "output-mode=silent ! tensor_sink name=ts")
    p["ts"].connect(seen.append)
    msgs = []
    p.bus.add_watch(lambda m: msgs.append(m)
                    if m.kind == MessageKind.ELEMENT else None)
    p["src"].spec = TensorsSpec.parse("2:1,3", "float32,int16")
    x = torch.ones(1, 2)
    with p:
        p["src"].push_buffer(Buffer.of(x, torch.zeros(3, dtype=torch.int16),
                                       pts=42))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    assert p["ts"].buffers_rendered == 1 and len(seen) == 1
    assert seen[0].tensors[0].torch() is x   # no copy on the way
    (m,) = msgs
    assert m.data == {"num_tensors": 2, "dims": ["2:1", "3"],
                      "types": ["float32", "int16"], "format": "static",
                      "pts": 42}


def test_fakesink_consumes():
    p = tparse("appsrc name=src ! fakesink name=f")
    p["src"].spec = TensorsSpec.parse("2", "float32")
    with p:
        p["src"].push_buffer(Buffer.of(np.zeros(2, np.float32)))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    assert p["f"].stats["buffers_in"] == 1


def test_tensor_debug_matches_jax_description():
    descs = {}
    for pkg, parse, core in (("jax", jruntime.parse_launch, jcore),
                             ("port", tparse, tcore)):
        p = parse("appsrc name=src ! tensor_debug output-mode=silent ! "
                  "fakesink")
        got = []
        p.bus.add_watch(lambda m, got=got: got.append(m.data)
                        if m.kind.value == "element" else None)
        p["src"].spec = core.TensorsSpec.parse("4:2", "uint8")
        with p:
            p["src"].push_buffer(core.Buffer.of(np.zeros((2, 4), np.uint8),
                                                pts=7))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=60)
        descs[pkg] = got
    assert descs["port"] == descs["jax"] and len(descs["port"]) == 1


# -- 8. phase 13's measures in chip_smoke.py -------------------------------------

def test_chip_smoke_device_busy_is_the_union_of_kernel_intervals():
    """Phase 13a's busy share: overlapping kernels count once, copy rows
    and host rows not at all, and the span runs from the first kernel's
    start to the last kernel's end, so the share cannot exceed 1."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    import chip_smoke as cs

    def ev(name, a, b, dev=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=a, end=b))

    events = [ev("k1", 100, 300), ev("k2", 250, 400),   # overlap: 100..400
              ev("k3", 400, 500),                       # touches: ..500
              ev("Memcpy HtoD (Pageable -> Device)", 0, 2000),
              ev("Memcpy DtoH (Device -> Pageable)", 600, 650),
              ev("Memset (Device)", 700, 800),
              ev("aten::conv2d", 0, 5000, DeviceType.CPU),
              ev("k4", 900, 1100)]
    busy, span, d2h = cs.device_busy(events)
    assert (busy, span, d2h) == (0.6, 1.0, 1)           # ms: 400 + 200 µs
    assert cs.device_busy([ev("k", 0, 10), ev("k", 0, 10)])[:2] == \
        (0.01, 0.01)
    assert cs.device_busy([ev("aten::mm", 0, 10, DeviceType.CPU)]) == \
        (0.0, 0.0, 0)


def test_chip_smoke_bf16_ulp():
    import chip_smoke as cs

    for x in (0.17, -0.2, 0.125, 0.2499):
        assert cs.bf16_ulp(x) == 2.0 ** -10
    assert cs.bf16_ulp(1.0) == 2.0 ** -7
    t = torch.tensor([0.17], dtype=torch.bfloat16)
    up = torch.nextafter(t, torch.tensor([1.0], dtype=torch.bfloat16))
    assert float(up - t) == cs.bf16_ulp(float(t))

