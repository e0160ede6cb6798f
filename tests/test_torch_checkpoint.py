"""Checkpoints of the port's trainer against the JAX package's, on the CPU.

1. ``tests/test_checkpoint.py`` replayed through the port: the path rule
   (``is_orbax_path`` is the port's ``is_dir_path``), a directory round
   trip and a trainer that saves to a directory and a second one that
   resumes from it.  The port writes its own step-directory format
   (``trainers/checkpoint.py``: one ``params.safetensors``), so the replay
   reads ``load_orbax(path, template)`` as ``load_dir(path)``.
2. ``tests/test_lifecycle.py::test_orbax_step_dir_resolution``'s
   assertions on the port's step helpers and model URIs, each result
   equal to the JAX package's on the same directories.
3. A trainer's weights through a step directory: train, ``save_step``,
   ``root@latest`` resolves to it, ``load_dir`` gives the tree back bit
   for bit, and a trainer that loads it at lr 0 saves the same tree.
4. A step directory as a weights-only swap source: a pool serving a
   MobileNetV1 ``.pkl`` reloads ``root@latest``, keeps its architecture,
   takes the step as its version tag, and serves the step's logits
   (f32, equal to the tree applied alone).  A directory that holds
   neither ``params.safetensors`` nor an orbax ``_METADATA`` is refused.
5. The orbax cases of ``tests/test_checkpoint.py`` across the packages:
   the JAX package writes orbax (``save_orbax``, its ``jax-optax``
   trainer), the port reads it (``trainers/orbax_format.py``): the round
   trip with a template, a ``torch-optim`` trainer resuming from a JAX
   trainer's orbax directory, and a port pool's weights-only swap into a
   JAX-written ``root@latest`` serving, bit for bit, the logits the same
   tree gives from a safetensors step.
6. The other direction: the port writes orbax (``save_dir``/``save_step``,
   its ``torch-optim`` trainer's directory save), the JAX package reads
   it: a ``jax-optax`` trainer resumes from a port trainer's step, and a
   JAX pool's weights-only swap into a port-written ``root@latest``
   serves, bit for bit, the logits a JAX-written root of the same tree
   serves.
7. Zarr v3 steps, as orbax's ``use_zarr3`` writes them: ``load_dir``
   with and without a template equal to the JAX ``load_orbax``, a
   ``torch-optim`` trainer's ``model-load-path=`` one, and a port pool's
   weights-only swap into a zarr v3 ``root@latest``.
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
from nnstreamer_tpu_torch.models.params_io import save_safetensors
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
        with pytest.raises(LifecycleError,
                           match="neither params.safetensors.*nor _METADATA"):
            lc.stage(f"{root}@7")
        src.push_buffer(TBuffer.of(x, pts=0))
        got = sink.pull(timeout=60)
        src.end_of_stream()
        assert p.wait_eos(timeout=60)
    assert got is not None
    torch.testing.assert_close(got.tensors[0].torch(), want, rtol=0, atol=0)


# -- 5. orbax steps across the packages ----------------------------------------


def _bits_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def test_orbax_roundtrip_jax_writes_port_reads(tmp_path):
    """``TestCheckpointBackends.test_orbax_roundtrip`` with the JAX
    package writing and the port reading, with and without the
    template."""
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.zeros(3, np.float32)}
    path = str(tmp_path / "ck")
    jck.save_orbax(path, tree)
    out = tck.load_dir(path, template=tree)
    np.testing.assert_array_equal(out["w"], tree["w"])
    np.testing.assert_array_equal(out["b"], tree["b"])
    _bits_equal(out, jck.load_orbax(path, template=tree))
    _bits_equal(tck.load_dir(path), jck.load_orbax(path))


def _jax_train(save_path, n=16):
    """``TestTrainerOrbaxResume.run_training``: the JAX trainer on
    ``mesh: data:-1`` saving an orbax directory."""
    from nnstreamer_tpu.core import Buffer, TensorsSpec
    from nnstreamer_tpu.elements.basic import AppSink, AppSrc
    from nnstreamer_tpu.runtime import Pipeline
    from nnstreamer_tpu.runtime.registry import make

    p = Pipeline()
    src = AppSrc(name="src", spec=TensorsSpec.parse("4:1,1:1",
                                                    "float32,int32"))
    trn = make("tensor_trainer", el_name="trn", framework="jax-optax",
               model_config={
                   "apply": "test_torch_checkpoint:ck_tree_apply",
                   "init": {"w": np.zeros((4, 2), np.float32),
                            "b": np.zeros((2,), np.float32)},
                   "batch_size": 8, "lr": 0.5, "mesh": "data:-1"},
               model_save_path=save_path, num_inputs=1, num_labels=1,
               num_training_samples=n, epochs=1)
    snk = AppSink(name="out", max_buffers=2 * n + 8)
    p.add(src, trn, snk).link(src, trn, snk)
    rng = np.random.default_rng(0)
    with p:
        for _ in range(n):
            x = rng.standard_normal((1, 4)).astype(np.float32)
            y = np.array([[int(x.sum() > 0)]], np.int32)
            src.push_buffer(Buffer.of(x, y))
        src.end_of_stream()
        assert p.wait_eos(timeout=180)


def test_save_orbax_then_resume_jax_trainer_to_port_trainer(tmp_path):
    """``TestTrainerOrbaxResume.test_save_orbax_then_resume`` across the
    packages: the JAX trainer saves orbax, a ``torch-optim`` trainer
    resumes from it.  At lr 0 the port saves the JAX step's tree bit for
    bit (it started from it); at lr 0.5 it trains on from it."""
    ck = str(tmp_path / "trainer_ck")  # no extension: an orbax directory
    _jax_train(ck)
    template = {"w": np.zeros((4, 2), np.float32),
                "b": np.zeros((2,), np.float32)}
    restored = tck.load_dir(ck, template=template)
    _bits_equal(restored, jck.load_orbax(ck, template=template))
    assert np.abs(restored["w"]).sum() > 0
    _train(str(tmp_path / "kept"), load_path=ck, lr=0.0)
    _bits_equal(tck.load_dir(str(tmp_path / "kept")), restored)
    _train(str(tmp_path / "ck2"), load_path=ck)
    again = tck.load_dir(str(tmp_path / "ck2"))
    assert np.isfinite(again["w"]).all()
    assert not np.array_equal(again["w"], restored["w"])


def test_pool_swaps_into_a_jax_orbax_root_latest(tmp_path):
    """A port pool's weights-only swap into the JAX package's
    ``root@latest`` (orbax) serves the logits the same tree serves from
    a safetensors step: f32, bit for bit, tag = the step."""
    rng = np.random.default_rng(9)
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
    jroot, troot = tmp_path / "jax_ckpts", tmp_path / "port_ckpts"
    jck.save_orbax_step(str(jroot), 3, tree0)
    jck.save_orbax_step(str(jroot), 40, tree1)
    # an older port step: one params.safetensors, still read
    os.makedirs(troot / "40")
    save_safetensors(str(troot / "40" / tck.STEP_FILE), tree1)
    got = {}
    for name, root in (("orbax", jroot), ("safetensors", troot)):
        p = TPipeline(name=f"ck-orbax-{name}", device="cpu")
        src = TAppSrc(name="src", spec=TSpec.from_shapes([(1, 32, 32, 3)],
                                                         np.float32))
        flt = TensorFilter(name="net", framework="torch-cuda",
                           model=str(model), share_model=True,
                           is_updatable=True)
        sink = TAppSink(name="sink", max_buffers=8)
        p.add(src, flt, sink).link(src, flt, sink)
        with p:
            flt.handle_event(None, Event.reload_model(f"{root}@latest"))
            assert flt.pool.lifecycle.baseline.tag == "40"
            src.push_buffer(TBuffer.of(x, pts=0))
            out = sink.pull(timeout=60)
            src.end_of_stream()
            assert p.wait_eos(timeout=60)
        assert out is not None
        got[name] = out.tensors[0].torch()
    assert got["orbax"].dtype == torch.float32
    assert torch.equal(got["orbax"], got["safetensors"])
    want = convert.mobilenet_v1_tree_apply(
        tree1, torch.from_numpy(x), dtype="float32").detach()
    torch.testing.assert_close(got["orbax"], want, rtol=0, atol=0)


# -- 6. port steps read by the JAX package ---------------------------------------


def _jax_train_from(save_path, load_path, lr, n=16):
    """``_jax_train`` resuming from ``load_path`` at ``lr``."""
    from nnstreamer_tpu.core import Buffer, TensorsSpec
    from nnstreamer_tpu.elements.basic import AppSink, AppSrc
    from nnstreamer_tpu.runtime import Pipeline
    from nnstreamer_tpu.runtime.registry import make

    p = Pipeline()
    src = AppSrc(name="src", spec=TensorsSpec.parse("4:1,1:1",
                                                    "float32,int32"))
    trn = make("tensor_trainer", el_name="trn", framework="jax-optax",
               model_config={
                   "apply": "test_torch_checkpoint:ck_tree_apply",
                   "init": {"w": np.zeros((4, 2), np.float32),
                            "b": np.zeros((2,), np.float32)},
                   "batch_size": 8, "lr": lr, "mesh": "data:-1"},
               model_save_path=save_path, model_load_path=load_path,
               num_inputs=1, num_labels=1, num_training_samples=n, epochs=1)
    snk = AppSink(name="out", max_buffers=2 * n + 8)
    p.add(src, trn, snk).link(src, trn, snk)
    rng = np.random.default_rng(1)
    with p:
        for _ in range(n):
            x = rng.standard_normal((1, 4)).astype(np.float32)
            y = np.array([[int(x.sum() > 0)]], np.int32)
            src.push_buffer(Buffer.of(x, y))
        src.end_of_stream()
        assert p.wait_eos(timeout=180)


def test_jax_trainer_resumes_from_a_port_trainer_step(tmp_path):
    """The port's trainer saves a directory (an orbax step); the JAX
    ``jax-optax`` trainer resumes from it: at lr 0 it saves the port's
    tree bit for bit (read by both packages), at lr 0.5 it trains on."""
    ck = str(tmp_path / "port_ck")
    _train(ck)
    assert os.path.isfile(os.path.join(ck, "_METADATA"))
    assert not os.path.exists(os.path.join(ck, tck.STEP_FILE))
    port = tck.load_dir(ck)
    assert np.abs(port["w"]).sum() > 0
    _bits_equal(jck.load_orbax(ck), port)
    _jax_train_from(str(tmp_path / "kept"), ck, 0.0)
    _bits_equal(jck.load_orbax(str(tmp_path / "kept")), port)
    _bits_equal(tck.load_dir(str(tmp_path / "kept")), port)
    _jax_train_from(str(tmp_path / "on"), ck, 0.5)
    again = np.asarray(jck.load_orbax(str(tmp_path / "on"))["w"])
    assert np.isfinite(again).all() and not np.array_equal(again, port["w"])


def test_jax_pool_swaps_into_a_port_root_latest(tmp_path):
    """``test_pool_swaps_into_a_jax_orbax_root_latest`` with the roles
    exchanged: a JAX pool serving a MobileNetV1 ``.pkl`` reloads
    ``root@latest`` of a root the port wrote (``save_step``) and serves,
    bit for bit, the logits the same tree serves from a JAX-written
    root, tag = the step."""
    from nnstreamer_tpu.core import Buffer, TensorsSpec
    from nnstreamer_tpu.elements.basic import AppSink, AppSrc
    from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
    from nnstreamer_tpu.filters.jax_xla import save_params_model
    from nnstreamer_tpu.runtime import Pipeline
    from nnstreamer_tpu.runtime.events import Event as JEvent

    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    tree0 = tmb.mobilenet_v1_init(0, 10, 0.25)
    tree1 = tmb.mobilenet_v1_init(1, 10, 0.25)
    model = str(tmp_path / "mnv1.pkl")
    save_params_model(model, "nnstreamer_tpu.models.mobilenet:"
                             "mobilenet_v1_apply", tree0,
                      in_shapes=[(1, 32, 32, 3)], in_dtypes="float32")
    troot, jroot = tmp_path / "port_ckpts", tmp_path / "jax_ckpts"
    tck.save_step(str(troot), 3, tree0)
    tck.save_step(str(troot), 40, tree1)
    assert sorted(os.listdir(troot)) == ["3", "40"]  # no hidden leftovers
    jck.save_orbax_step(str(jroot), 40, tree1)
    got = {}
    for name, root in (("port", troot), ("jax", jroot)):
        p = Pipeline(name=f"ck-jax-{name}")
        src = AppSrc(name="src", spec=TensorsSpec.from_shapes(
            [(1, 32, 32, 3)], np.float32))
        flt = JFilter(name="net", framework="jax-xla", model=model,
                      share_model=True, is_updatable=True)
        sink = AppSink(name="sink", max_buffers=8)
        p.add(src, flt, sink).link(src, flt, sink)
        with p:
            flt.handle_event(None, JEvent.reload_model(f"{root}@latest"))
            assert flt.pool.lifecycle.baseline.tag == "40"
            src.push_buffer(Buffer.of(x, pts=0))
            out = sink.pull(timeout=60)
            src.end_of_stream()
            assert p.wait_eos(timeout=60)
        assert out is not None
        got[name] = np.asarray(out.tensors[0].np())
    assert got["port"].tobytes() == got["jax"].tobytes()
    # the step's weights, not the .pkl's: within 1e-4 of the step's tree
    # alone, over 1e-3 from the .pkl's (their logits lie 7e-3 apart)
    from nnstreamer_tpu.models.mobilenet import mobilenet_v1_apply

    alone = np.asarray(mobilenet_v1_apply(tree1, x))
    np.testing.assert_allclose(got["port"], alone, rtol=0, atol=1e-4)
    assert np.abs(np.asarray(mobilenet_v1_apply(tree0, x))
                  - got["port"]).max() > 1e-3


# -- 7. zarr v3 steps (orbax's use_zarr3) --------------------------------------


def _zarr3_save(path, tree):
    """``tree`` saved by orbax with ``use_zarr3=True`` (zarr v3 arrays,
    one ``sharding_indexed`` chunk a leaf), as a client of orbax other
    than the JAX package's ``save_orbax`` writes it."""
    import orbax.checkpoint as ocp

    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
        path, args=ocp.args.PyTreeSave(tree))
    return path


def test_load_dir_reads_a_zarr3_step(tmp_path):
    """``load_dir`` of a zarr v3 step, with and without a template, gives
    what the JAX package's ``load_orbax`` gives, bit for bit."""
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
            "b": np.array([1e-3, -2.5, 7e4], np.float32),
            "i": np.arange(4, dtype=np.int64)}
    path = _zarr3_save(str(tmp_path / "ck"), tree)
    assert tck.load_dir(path)["w"].tobytes() == tree["w"].tobytes()
    _bits_equal(tck.load_dir(path), jck.load_orbax(path))
    template = {"w": np.zeros((2, 3), np.float64),
                "b": np.zeros(3, np.float32), "i": np.zeros(4, np.int32)}
    _bits_equal(tck.load_dir(path, template),
                jck.load_orbax(path, template=template))


def test_port_trainer_resumes_from_a_zarr3_step(tmp_path):
    """A ``torch-optim`` trainer's ``model-load-path=`` a zarr v3 step
    (the JAX trainer's trained tree saved by orbax with ``use_zarr3``):
    at lr 0 it saves that tree bit for bit, at lr 0.5 it trains on."""
    ck = str(tmp_path / "jax_ck")
    _jax_train(ck)
    tree = {k: np.asarray(v) for k, v in jck.load_orbax(ck).items()}
    z3 = _zarr3_save(str(tmp_path / "z3"), tree)
    _train(str(tmp_path / "kept"), load_path=z3, lr=0.0)
    _bits_equal(tck.load_dir(str(tmp_path / "kept")), tree)
    _train(str(tmp_path / "on"), load_path=z3)
    again = tck.load_dir(str(tmp_path / "on"))
    assert np.isfinite(again["w"]).all()
    assert not np.array_equal(again["w"], tree["w"])


def test_pool_swaps_into_a_zarr3_root_latest(tmp_path):
    """A port pool's weights-only swap into ``root@latest`` of zarr v3
    steps (orbax's ``use_zarr3``) serves the step's logits bit for bit,
    tag = the step."""
    rng = np.random.default_rng(10)
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
    root = tmp_path / "z3_ckpts"
    _zarr3_save(str(root / "3"), tree0)
    _zarr3_save(str(root / "40"), tree1)
    p = TPipeline(name="ck-zarr3", device="cpu")
    src = TAppSrc(name="src", spec=TSpec.from_shapes([(1, 32, 32, 3)],
                                                     np.float32))
    flt = TensorFilter(name="net", framework="torch-cuda", model=str(model),
                       share_model=True, is_updatable=True)
    sink = TAppSink(name="sink", max_buffers=8)
    p.add(src, flt, sink).link(src, flt, sink)
    with p:
        flt.handle_event(None, Event.reload_model(f"{root}@latest"))
        assert flt.pool.lifecycle.baseline.tag == "40"
        src.push_buffer(TBuffer.of(x, pts=0))
        out = sink.pull(timeout=60)
        src.end_of_stream()
        assert p.wait_eos(timeout=60)
    assert out is not None
    want = convert.mobilenet_v1_tree_apply(
        tree1, torch.from_numpy(x), dtype="float32").detach()
    torch.testing.assert_close(out.tensors[0].torch(), want, rtol=0, atol=0)
