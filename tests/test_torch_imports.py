"""Import discipline of the PyTorch/CUDA port (``nnstreamer_tpu_torch``).

The port imports torch and never jax, and nothing of the JAX package — it
keeps its own copies of what it needs.  Asking for the card where there is
none raises instead of carrying on on the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "nnstreamer_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "flash_study.py")


def test_port_imports_with_jax_blocked():
    """Every module of the port imports with ``jax`` unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import nnstreamer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'nnstreamer_tpu' or k.startswith("
        "'nnstreamer_tpu.') for k in sys.modules), 'JAX package imported'\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 65
    for mod in ("runtime.batching", "runtime.serving", "runtime.admission",
                "utils.stats", "elements.transform", "elements.filter",
                "filters.api", "filters.torch_cuda", "filters.modeluri",
                "models.params_io", "runtime.lifecycle",
                "runtime.compilecache", "ops.build",
                "decoders.font", "decoders.imagesegment", "decoders.pose",
                "decoders.tensorregion", "decoders.directvideo",
                "decoders.octetstream", "decoders.wirefmt",
                "decoders.flexbuf", "decoders.python3", "decoders.refcompat",
                "elements.sync", "elements.crop", "elements.converter",
                "converters", "converters.codecs", "converters.wirefmt",
                "converters.python3", "elements.basic",
                "elements.combiners", "elements.condition",
                "elements.aggregator", "elements.rate", "elements.sparse",
                "elements.repo", "elements.datarepo", "elements.sensorsrc",
                "filters.custom", "filters.pytorch", "utils.conf",
                "utils.log", "obs", "obs.hooks", "obs.tracer",
                "obs.tracectx", "obs.hwspec", "obs.transfer",
                "obs.devicemem", "obs.xlacost", "obs.stagestat",
                "obs.tenantstat", "obs.metrics", "obs.flightrec",
                "chaos", "chaos.plan", "chaos.hooks", "utils.profile",
                "utils.hw", "obs.prof", "chaos.retrypolicy",
                "runtime.actuators", "utils.lockdep", "obs.forecast",
                "obs.watch", "obs.control", "obs.scrape", "obs.top",
                "obs.benchgate", "analyze", "analyze.__main__",
                "analyze.cli", "analyze.diagnostics", "analyze.graph",
                "analyze.capsflow", "analyze.codelint",
                "analyze.concurrency", "analyze.watchrules",
                "analyze.ctlplaybooks", "analyze.pipelines", "check",
                "tools", "tools.gen_element_docs",
                "tools.pipeline_convert", "tools.gen_custom_filter",
                "parallel", "parallel.mesh", "parallel.sharded",
                "parallel.placement", "parallel.multihost",
                "parallel.collectives", "obs.meshstat",
                "edge", "edge.wire", "edge.ntputil", "edge.devicechannel",
                "edge.transport", "edge.query", "edge.mqtt",
                "edge.grpc_bridge", "trainers", "trainers.torch_optim",
                "trainers.checkpoint", "elements.trainer",
                "filters.importer_util", "filters.importer_ops",
                "filters.onnx", "filters.onnx_import", "filters.tflite",
                "filters.tflite_import", "filters.tensorflow",
                "filters.tf_import", "nativelib"):
        assert f"nnstreamer_tpu_torch.{mod}" in names, mod


def test_edge_imports_without_grpcio():
    """Where ``import grpc`` fails (grpcio is an optional install) the
    edge package still imports, with the gRPC names ``None`` and the two
    gRPC elements unregistered; the MQTT elements and hybrid stay."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['grpc'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from nnstreamer_tpu_torch import edge\n"
        "from nnstreamer_tpu_torch.runtime import list_elements\n"
        "assert edge.GrpcSink is None and edge.GrpcSrc is None\n"
        "assert 'nnstreamer_tpu_torch.edge.grpc_bridge' not in sys.modules\n"
        "names = set(list_elements())\n"
        "assert not names & {'tensor_src_grpc', 'tensor_sink_grpc'}, names\n"
        "assert {'mqttsrc', 'mqttsink'} <= names, names\n"
        "from nnstreamer_tpu_torch.edge.transport import HybridServer\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]


def test_no_jax_or_jax_package_import_in_source():
    """AST scan: no ``import jax``/``from jax``, no import of the JAX
    package and none of the libraries orbax steps are read without
    (orbax, tensorstore, zstandard, numcodecs, zarr) anywhere in the
    port, chip_smoke.py or flash_study.py."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                if root in ("jax", "jaxlib", "nnstreamer_tpu", "orbax",
                            "tensorstore", "zstandard", "numcodecs",
                            "zarr"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} imports {m}")
    assert not bad, bad


def test_orbax_reader_without_a_compiler_names_gpp(monkeypatch, tmp_path):
    """Where the zstd decoder cannot be built, reading a JAX orbax step
    raises naming g++ (there is no Python decoder to fall back to); a
    pool staging it and a trainer resuming from it say so too."""
    from nnstreamer_tpu_torch import nativelib
    from nnstreamer_tpu_torch.trainers import torch_optim
    from nnstreamer_tpu_torch.trainers import TrainerError
    from nnstreamer_tpu_torch.trainers.checkpoint import load_dir

    step = os.path.join(REPO, "tests", "data", "orbax_step")
    monkeypatch.setattr(nativelib, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(nativelib, "_zstd", None)
    monkeypatch.setattr(nativelib, "_zstd_error", None)
    monkeypatch.setattr(nativelib.shutil, "which", lambda name: None)
    with pytest.raises(nativelib.NativeBuildError, match="g\\+\\+"):
        load_dir(step)
    with pytest.raises(nativelib.NativeBuildError, match="g\\+\\+"):
        load_dir(step)                  # the failure is kept, not retried
    with pytest.raises(TrainerError, match="g\\+\\+"):
        torch_optim._resolve_apply({"apply": "math:sqrt"}, step)
    assert not (tmp_path / "native").exists()


def test_cuda_without_card_raises(monkeypatch):
    from nnstreamer_tpu_torch.runtime import Pipeline, parse_launch
    from nnstreamer_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline()  # the default device is the card
    with pytest.raises(RuntimeError, match="cuda"):
        parse_launch("appsrc ! appsink")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("gpu")
    assert Pipeline(device="cpu").device == torch.device("cpu")


def test_filter_accelerator_grammar(monkeypatch):
    """``accelerator=`` keeps the reference grammar: cpu and gpu/cuda
    kinds; an explicit gpu without a card raises, tpu is refused."""
    from nnstreamer_tpu_torch.utils.device import parse_accel_kind

    assert parse_accel_kind("") is None
    assert parse_accel_kind("true:gpu") == "cuda"
    assert parse_accel_kind("cuda") == "cuda"
    assert parse_accel_kind("true:cpu") == "cpu"
    with pytest.raises(ValueError):
        parse_accel_kind("true:tpu")

    import numpy as np

    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.filters import register_model
    from nnstreamer_tpu_torch.runtime import parse_launch

    register_model("torch_imports_double", lambda x: x * 2,
                   in_shapes=[(4,)], in_dtypes=np.float32)
    p = parse_launch("appsrc name=src ! tensor_filter framework=torch-cuda "
                     "model=torch_imports_double accelerator=true:cpu ! "
                     "appsink name=out", device="cpu")
    p["src"].spec = TensorsSpec.parse("4", "float32")
    with p:
        p["src"].push_buffer(Buffer.of(np.arange(4, dtype=np.float32)))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    np.testing.assert_array_equal(p["out"].pull(timeout=1).tensors[0].np(),
                                  [0, 2, 4, 6])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = parse_launch("appsrc name=src ! tensor_filter framework=torch-cuda "
                     "model=torch_imports_double accelerator=true:gpu ! "
                     "appsink", device="cpu")
    p["src"].spec = TensorsSpec.parse("4", "float32")
    with pytest.raises(Exception, match="cuda"):
        p.start()


def test_obs_and_chaos_read_only_the_ports_keys():
    """The obs, chaos, utils, analyze and edge modules and the native
    codec's loader read environment keys of the port's prefix only, and
    the JAX package's keys leave the port as it is: no kill switch, no chaos plan, no flight recorder armed, no
    metrics endpoint, no price, text logs, no host profiler, watchdog,
    controller or lock witness."""
    import re

    keys = set()
    for sub in ("obs", "chaos", "utils", "analyze", "edge"):
        for root, _, files in os.walk(os.path.join(PKG, sub)):
            for f in files:
                if f.endswith(".py"):
                    keys |= set(re.findall(r"NNS_TPU_[A-Z_]+",
                                           open(os.path.join(root, f)).read()))
    for f in ("nativelib.py", os.path.join("converters", "codecs.py")):
        keys |= set(re.findall(r"NNS_TPU_[A-Z_]+",
                               open(os.path.join(PKG, f)).read()))
    assert "NNS_TPU_TORCH_NO_NATIVE" in keys
    assert keys and all(k.startswith("NNS_TPU_TORCH_") for k in keys), keys
    code = (
        "import sys, json, logging\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from nnstreamer_tpu_torch import chaos\n"
        "from nnstreamer_tpu_torch.obs import hooks, transfer, hwspec\n"
        "from nnstreamer_tpu_torch.obs.flightrec import FLIGHT\n"
        "from nnstreamer_tpu_torch.obs.metrics import REGISTRY\n"
        "from nnstreamer_tpu_torch.utils import log\n"
        "from nnstreamer_tpu_torch.runtime import parse_launch\n"
        "p = parse_launch('appsrc caps=other/tensors,format=static,"
        "num_tensors=1,dimensions=4,types=float32,framerate=0/1 ! "
        "appsink', device='cpu')\n"
        "p.start(); p.stop()\n"
        "h = [x for x in logging.getLogger('nnstreamer_tpu_torch').handlers"
        " if getattr(x, log._HANDLER_TAG, False)][0]\n"
        "from nnstreamer_tpu_torch.obs import prof, watch, control\n"
        "from nnstreamer_tpu_torch.utils import lockdep\n"
        "import threading\n"
        "print(json.dumps([hooks.DISABLED, transfer.ACTIVE,"
        " chaos.active_plan() is None, FLIGHT.armed,"
        " REGISTRY._server is None, hwspec.chip_hour_price(),"
        " type(h.formatter).__name__,"
        " logging.getLogger('nnstreamer_tpu_torch').level,"
        " prof.PROFILER.running, prof.DEEP.armed, watch.WATCH is None,"
        " control.CONTROLLER is None, lockdep.enabled(),"
        " type(threading.Lock()).__name__]))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NNS_TPU_")}
    jax_keys = {"NNS_TPU_OBS_DISABLE": "1",
                "NNS_TPU_CHAOS": "seed=1;drop:p=0.5",
                "NNS_TPU_FLIGHTREC_DIR": os.path.join(REPO, "build", "fr"),
                "NNS_TPU_METRICS_PORT": "0",
                "NNS_TPU_CHIP_HOUR_USD": "2.0",
                "NNS_TPU_LOG_JSON": "1", "NNS_TPU_LOG_LEVEL": "DEBUG",
                "NNS_TPU_PROF": "47",
                "NNS_TPU_PROF_DEEP_DIR": os.path.join(REPO, "build", "dp"),
                "NNS_TPU_WATCH": "0.05", "NNS_TPU_CTL": "0.05",
                "NNS_TPU_LOCKDEP": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env={**env, **jax_keys})
    assert out.returncode == 0, out.stderr
    import json

    assert json.loads(out.stdout) == [False, True, True, False, True, 0.0,
                                      "Formatter", 30, False, False, True,
                                      True, False, "lock"]
