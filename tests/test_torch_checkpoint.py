"""Checkpoints of the port's trainer against the JAX package's, on the CPU.

1. ``tests/test_checkpoint.py`` replayed through the port: the path rule
   (``is_orbax_path`` is the port's ``is_dir_path``), a directory round
   trip and a trainer that saves to a directory and a second one that
   resumes from it.  The JAX package writes orbax there; the port writes
   its step-directory format (``trainers/checkpoint.py``: one
   ``params.safetensors``), so the replay reads ``load_orbax(path,
   template)`` as ``load_dir(path)``.
2. ``tests/test_lifecycle.py::test_orbax_step_dir_resolution``'s
   assertions on the port's step helpers and model URIs, each result
   equal to the JAX package's on the same directories.
3. A trainer's weights through a step directory: train, ``save_step``,
   ``root@latest`` resolves to it, ``load_dir`` gives the tree back bit
   for bit, and a trainer that loads it at lr 0 saves the same tree.
4. A step directory as a weights-only swap source: a pool serving a
   MobileNetV1 ``.pkl`` reloads ``root@latest``, keeps its architecture,
   takes the step as its version tag, and serves the step's logits
   (f32, equal to the tree applied alone).  A directory without
   ``params.safetensors`` (a JAX orbax step among them) is refused.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from nnstreamer_tpu.filters import modeluri as jmodeluri
from nnstreamer_tpu.trainers import checkpoint as jck
from nnstreamer_tpu_torch.core import Buffer as TBuffer
from nnstreamer_tpu_torch.core import TensorsSpec as TSpec
from nnstreamer_tpu_torch.elements.basic import AppSink as TAppSink
from nnstreamer_tpu_torch.elements.basic import AppSrc as TAppSrc
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.filters import modeluri as tmodeluri
from nnstreamer_tpu_torch.models import convert
from nnstreamer_tpu_torch.models import mobilenet as tmb
from nnstreamer_tpu_torch.runtime import Pipeline as TPipeline
from nnstreamer_tpu_torch.runtime.events import Event
from nnstreamer_tpu_torch.runtime.lifecycle import LifecycleError
from nnstreamer_tpu_torch.trainers import checkpoint as tck
from torch_replay import replay

replay("test_checkpoint.py", globals(), subs=[
    ("from nnstreamer_tpu.trainers.checkpoint import (\n"
     "    is_orbax_path,\n    load_orbax,\n    save_orbax,\n)",
     "from nnstreamer_tpu.trainers.checkpoint import (\n"
     "    is_dir_path as is_orbax_path,\n    load_dir,\n"
     "    save_dir as save_orbax,\n)\n\n\n"
     "def load_orbax(path, template=None):\n"
     "    return load_dir(path)"),
    ('framework="jax-optax"', 'framework="torch-optim"'),
])


# -- 2. step directories and model URIs ----------------------------------------


def test_step_dir_resolution_as_the_jax_package(tmp_path):
    root = tmp_path / "ckpts"
    for step in (100, 200, 250):
        (root / str(step)).mkdir(parents=True)
    (root / "notes").mkdir()
    (root / "300").write_bytes(b"")      # a file, not a step
    assert tck.list_steps(str(root)) == [100, 200, 250] == \
        jck.list_steps(str(root))
    assert tck.latest_step(str(root)) == 250 == jck.latest_step(str(root))
    assert tck.step_dir(str(root), 7) == jck.step_dir(str(root), 7)
    path, tag = tmodeluri.resolve_model_uri_versioned(f"{root}@latest")
    assert path == str(root / "250") and tag == "250"
    path, tag = tmodeluri.resolve_model_uri_versioned(f"{root}@100")
    assert path == str(root / "100") and tag == "100"
    for ref in (f"{root}@latest", f"{root}@100", f"{root}@newest",
                f"file://{root}@200"):
        assert tmodeluri.resolve_model_uri_versioned(ref) == \
            jmodeluri.resolve_model_uri_versioned(ref)
    with pytest.raises(tmodeluri.ModelUriError, match="@999"):
        tmodeluri.resolve_model_uri_versioned(f"{root}@999")
    with pytest.raises(ValueError):
        tck.resolve_step_dir(str(root), "not-a-step")
    with pytest.raises(ValueError, match="no numeric step"):
        tck.resolve_step_dir(str(tmp_path), "latest")
    for path in ("/tmp/run1/ckpt", "/tmp/run1/", "/tmp/model.pkl",
                 "/tmp/model.ckpt", "/tmp/m.safetensors", "plain"):
        assert tck.is_dir_path(path) == jck.is_orbax_path(path), path


# -- 3. a trainer's weights through a step directory ---------------------------


def ck_tree_apply(params, x, train=False):
    return x @ params["w"] + params["b"]


def _train(save_path, load_path="", lr=0.5, n=16):
    p = TPipeline(device="cpu")
    src = TAppSrc(name="src", spec=TSpec.parse("4:1,1:1", "float32,int32"))
    from nnstreamer_tpu_torch.runtime.registry import make

    trn = make("tensor_trainer", el_name="trn", framework="torch-optim",
               model_config={
                   "apply": "test_torch_checkpoint:ck_tree_apply",
                   "init": {"w": np.zeros((4, 2), np.float32),
                            "b": np.zeros((2,), np.float32)},
                   "batch_size": 8, "lr": lr},
               model_save_path=save_path, model_load_path=load_path,
               num_inputs=1, num_labels=1, num_training_samples=n, epochs=1)
    snk = TAppSink(name="out", max_buffers=2 * n + 8)
    p.add(src, trn, snk).link(src, trn, snk)
    rng = np.random.default_rng(0)
    with p:
        for _ in range(n):
            x = rng.standard_normal((1, 4)).astype(np.float32)
            y = np.array([[int(x.sum() > 0)]], np.int32)
            src.push_buffer(TBuffer.of(x, y))
        src.end_of_stream()
        assert p.wait_eos(timeout=120)


def test_trainer_save_step_load_dir_resume(tmp_path):
    first = tmp_path / "run1.pkl"
    _train(str(first))
    with open(first, "rb") as f:
        tree = pickle.load(f)["params"]
    assert np.abs(tree["w"]).sum() > 0   # training moved the weights
    root = tmp_path / "ckpts"
    assert tck.save_step(str(root), 16, tree) == str(root / "16")
    assert sorted(os.listdir(root)) == ["16"]   # no hidden leftovers
    path, tag = tmodeluri.resolve_model_uri_versioned(f"{root}@latest")
    assert (path, tag) == (str(root / "16"), "16")
    back = tck.load_dir(path)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert back[k].tobytes() == tree[k].tobytes()
    # resume from the step at lr 0: the trainer starts from it, keeps it,
    # and saves it as a step directory (a path without an extension)
    _train(str(tmp_path / "resumed"), load_path=path, lr=0.0)
    again = tck.load_dir(str(tmp_path / "resumed"))
    for k in tree:
        assert again[k].tobytes() == tree[k].tobytes()
    # saving the same step again replaces its file
    tck.save_step(str(root), 16, {"w": tree["w"] * 2, "b": tree["b"]})
    np.testing.assert_array_equal(tck.load_dir(path)["w"], tree["w"] * 2)


# -- 4. a step directory as a swap source ---------------------------------------


def test_step_directory_is_a_weights_only_swap_source(tmp_path):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    tree0 = tmb.mobilenet_v1_init(0, 10, 0.25)
    tree1 = tmb.mobilenet_v1_init(1, 10, 0.25)
    model = tmp_path / "mnv1.pkl"
    with open(model, "wb") as f:
        pickle.dump({"apply": "nnstreamer_tpu_torch.models.convert:"
                              "mobilenet_v1_tree_apply",
                     "apply_kwargs": {"dtype": "float32"},
                     "params": tree0, "in_shapes": [(1, 32, 32, 3)],
                     "in_dtypes": np.dtype("float32")}, f)
    root = tmp_path / "ckpts"
    tck.save_step(str(root), 3, tree0)
    tck.save_step(str(root), 40, tree1)
    (root / "7").mkdir()                    # a step with no weights file
    want = convert.mobilenet_v1_tree_apply(
        tree1, torch.from_numpy(x), dtype="float32").detach()
    p = TPipeline(name="ck-swap", device="cpu")
    src = TAppSrc(name="src", spec=TSpec.from_shapes([(1, 32, 32, 3)],
                                                     np.float32))
    flt = TensorFilter(name="net", framework="torch-cuda", model=str(model),
                       share_model=True, is_updatable=True)
    sink = TAppSink(name="sink", max_buffers=8)
    p.add(src, flt, sink).link(src, flt, sink)
    with p:
        flt.handle_event(None, Event.reload_model(f"{root}@latest"))
        lc = flt.pool.lifecycle
        assert lc.baseline.tag == "40"
        assert lc.baseline.source == f"{root / '40'}@40"
        with pytest.raises(LifecycleError, match="params.safetensors"):
            lc.stage(f"{root}@7")
        src.push_buffer(TBuffer.of(x, pts=0))
        got = sink.pull(timeout=60)
        src.end_of_stream()
        assert p.wait_eos(timeout=60)
    assert got is not None
    torch.testing.assert_close(got.tensors[0].torch(), want, rtol=0, atol=0)
