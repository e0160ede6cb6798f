"""The mesh-sharded ``tensor_filter`` of the port against the JAX package's.

``tests/test_sharded_filter.py``'s cases on the port's ``torch-cuda``
filter over 8 virtual host devices (``parallel.mesh.set_virtual_devices``),
each output held against the JAX package's ``jax-xla`` filter over its 8
virtual CPU devices on the same numpy-seeded inputs and weights; then
the sharding rules against the JAX rules on the same models (the trees
carried across by ``models/convert.py``), ``ShardedModel``, the
tensor-parallel MobileNetV2/SSD heads, the pooled ViT on ``mesh=data:4``
against the JAX pool on ``mesh=data:4``, and the attention's stride rule
on batch slices of the qkv projection.

Tolerances: f32 outputs atol 1e-4 + rtol 1e-4 against the JAX package
(the two frameworks sum products in another order); port against port
(sharded against unsharded, same ops on the same rows) bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements.filter import FilterSingle as JFilterSingle
from nnstreamer_tpu.filters import register_model as jregister
from nnstreamer_tpu.filters import unregister_model as junregister
from nnstreamer_tpu.parallel import mesh as jmesh
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.elements.basic import AppSink, AppSrc
from nnstreamer_tpu_torch.elements.filter import FilterSingle, TensorFilter
from nnstreamer_tpu_torch.elements.transform import TensorTransform
from nnstreamer_tpu_torch.filters import register_model, unregister_model
from nnstreamer_tpu_torch.filters.api import FilterError
from nnstreamer_tpu_torch.obs import transfer as _xfer
from nnstreamer_tpu_torch.obs.meshstat import MESH_STATS, shard_split
from nnstreamer_tpu_torch.parallel import mesh as tmesh
from nnstreamer_tpu_torch.parallel import sharded as tsharded
from nnstreamer_tpu_torch.runtime import Pipeline, parse_launch

TOL = dict(rtol=1e-4, atol=1e-4)
RNG = np.random.default_rng(7)
W = RNG.standard_normal((16, 8)).astype(np.float32)
B = RNG.standard_normal((8,)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _virtual_devices():
    tmesh.set_virtual_devices(8, "cpu")
    yield
    tmesh.clear_virtual_devices()


@pytest.fixture(autouse=True)
def _models():
    register_model("sh_mlp", lambda p, x: x @ p["w"] + p["b"],
                   params={"w": torch.from_numpy(W),
                           "b": torch.from_numpy(B)},
                   in_shapes=[(8, 16)])
    register_model("sh_add1", lambda x: x + 1.0, in_shapes=[(8, 16)])
    jregister("sh_mlp", lambda p, x: jnp.dot(x, p["w"]) + p["b"],
              params={"w": jnp.asarray(W), "b": jnp.asarray(B)},
              in_shapes=[(8, 16)])
    yield
    unregister_model("sh_mlp")
    unregister_model("sh_add1")
    junregister("sh_mlp")


def _expected(x):
    return x.astype(np.float32) @ W + B


def _port(**kw):
    return FilterSingle(framework="torch-cuda", device="cpu",
                        accelerator="cpu", **kw)


def _jax_out(x, **kw):
    fs = JFilterSingle(framework="jax-xla", accelerator="cpu", **kw)
    return np.asarray(fs.invoke([x])[0])


@pytest.mark.parametrize("spec", ["0-3", "4,5,6,7", "0-1,6", "3",
                                  "1, 1, 2", "8", "3-1", "", "x"])
def test_device_index_grammar_matches_jax(spec):
    def parse(fn):
        try:
            return fn(spec, 8)
        except ValueError:
            return "ValueError"

    assert parse(tmesh.parse_device_indices) == \
        parse(jmesh.parse_device_indices)


class TestFilterSingleMesh:
    def test_data_parallel_invoke_matches_jax(self):
        fs = _port(model="sh_mlp", mesh="data:-1")
        rp = fs.subplugin._placement
        assert rp.mesh.size == 8 and len(rp.groups) == 8
        x = RNG.standard_normal((8, 16)).astype(np.float32)
        out = fs.invoke([x])[0]
        np.testing.assert_allclose(out.numpy(), _expected(x), **TOL)
        np.testing.assert_allclose(
            out.numpy(), _jax_out(x, model="sh_mlp", mesh="data:-1"), **TOL)
        # every row from its own shard: one dispatch, 8 shards, 1 row each
        row = MESH_STATS.get("sh_mlp")
        assert row["shards"] == 8 and row["shard_frames"][-1] >= 1

    def test_tensor_parallel_rules_match_jax(self):
        fs = _port(model="sh_mlp", mesh="data:4,model:2", sharding="tp")
        sp = fs.subplugin
        mp = sp._model._mesh_params[sp._placement.key]
        # the dense 'w' (16, 8) splits its output dim over model:2
        assert tuple(mp.specs["w"]) == (None, "model")
        leaf = mp.tree(sp._placement.groups[0])["w"]
        assert isinstance(leaf, tsharded.ShardedLeaf)
        assert [tuple(s.shape) for s in leaf.slices] == [(16, 4), (16, 4)]
        x = RNG.standard_normal((8, 16)).astype(np.float32)
        out = fs.invoke([x])[0].numpy()
        np.testing.assert_allclose(out, _expected(x), **TOL)
        np.testing.assert_allclose(
            out, _jax_out(x, model="sh_mlp", mesh="data:4,model:2",
                          sharding="tp"), **TOL)

    def test_batch1_runs_replicated(self):
        fs = _port(model="sh_mlp", mesh="data:-1",
                   input_spec=TensorsSpec.parse("16:1", "float32"))
        x = RNG.standard_normal((1, 16)).astype(np.float32)
        MESH_STATS.reset()
        out = fs.invoke([x])[0].numpy()
        np.testing.assert_allclose(out, _expected(x), **TOL)
        assert MESH_STATS.get("sh_mlp")["replicated_dispatches"] == 1

    def test_fixed_axes_use_subset_of_devices(self):
        fs = _port(model="sh_add1", mesh="data:4")
        assert fs.subplugin._placement.mesh.size == 4
        out = fs.invoke([np.zeros((8, 16), np.float32)])
        np.testing.assert_allclose(out[0].numpy(), 1.0)

    @pytest.mark.parametrize("kw", [
        dict(mesh="data:3,model:5"),
        dict(mesh="data:-1", sharding="no-such-rules"),
        dict(sharding="tp"),
        dict(devices="0-3"),
        dict(mesh="data:-1", devices="0-99"),
        dict(mesh="data:16"),
    ])
    def test_bad_placements_raise(self, kw):
        with pytest.raises(FilterError):
            _port(model="sh_add1", **kw)

    def test_cuda_mesh_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError):
            FilterSingle(framework="torch-cuda", model="sh_add1",
                         device="cuda", mesh="data:1")

    def test_shared_key_does_not_collide_across_placements(self):
        plain = _port(model="sh_add1", shared_key="shk")
        meshed = _port(model="sh_add1", shared_key="shk", mesh="data:-1")
        lo = _port(model="sh_add1", shared_key="shk", mesh="data:4",
                   devices="0-3")
        hi = _port(model="sh_add1", shared_key="shk", mesh="data:4",
                   devices="4-7")
        assert plain.subplugin._placement is None
        assert meshed.subplugin._placement is not None
        assert set(lo.subplugin._placement.device_ids).isdisjoint(
            hi.subplugin._placement.device_ids)

    def test_set_input_info_keeps_mesh(self):
        fs = _port(model="sh_add1", mesh="data:-1")
        fs.set_input_info(TensorsSpec.parse("4:16", "float32"))
        out = fs.invoke([np.zeros((16, 4), np.float32)])
        assert tuple(out[0].shape) == (16, 4)
        assert fs.subplugin._placement is not None

    def test_rows_that_do_not_split_run_replicated(self):
        """A frame whose leading axis is not a batch (a reduction over
        it) fails the seeded split check and runs replicated: the
        function stays the unsplit one."""
        register_model("sh_mix", lambda x: x - x.mean(0, keepdim=True),
                       in_shapes=[(8, 16)])
        try:
            fs = _port(model="sh_mix", mesh="data:4")
            x = RNG.standard_normal((8, 16)).astype(np.float32)
            np.testing.assert_allclose(fs.invoke([x])[0].numpy(),
                                       x - x.mean(0, keepdims=True),
                                       rtol=1e-6, atol=1e-6)
        finally:
            unregister_model("sh_mix")


class TestPipelineMesh:
    def test_parse_launch_mesh_property(self):
        p = parse_launch(
            "appsrc name=src ! tensor_filter framework=torch-cuda "
            "model=sh_mlp mesh=data:-1 accelerator=cpu name=f ! "
            "appsink name=out", device="cpu")
        src, f, sink = (p.elements[n] for n in ("src", "f", "out"))
        src.spec = TensorsSpec.parse("16:8", "float32", rate=0)
        x = RNG.standard_normal((8, 16)).astype(np.float32)
        with p:
            src.push_buffer(Buffer.of(x, pts=3))
            src.end_of_stream()
            assert p.wait_eos(timeout=60)
            out = sink.pull(timeout=1)
            assert f.subplugin._placement.mesh.size == 8
            assert f.num_shards == 8 and f.data_shards == 8
        np.testing.assert_allclose(out[0].np(), _expected(x), **TOL)
        assert out.pts == 3

    def test_fused_prologue_runs_per_shard(self):
        p = Pipeline(device="cpu")
        src = AppSrc(name="src",
                     spec=TensorsSpec.parse("16:8", "uint8", rate=0))
        t = TensorTransform(name="t", mode="arithmetic",
                            option="typecast:float32,add:-127.5,div:127.5")
        f = TensorFilter(name="f", framework="torch-cuda", model="sh_mlp",
                         accelerator="cpu", mesh="data:-1")
        sink = AppSink(name="out")
        p.add(src, t, f, sink).link(src, t, f, sink)
        x = RNG.integers(0, 255, (8, 16), dtype=np.uint8)
        with p:
            src.push_buffer(Buffer.of(x))
            src.end_of_stream()
            assert p.wait_eos(timeout=60)
            out = sink.pull(timeout=1)
            assert f.subplugin._program.with_pre
        exp = _expected((x.astype(np.float32) - 127.5) / 127.5)
        np.testing.assert_allclose(out[0].np(), exp, **TOL)

    def test_two_stage_pipeline_on_disjoint_subsets(self, monkeypatch):
        """Stage a on devices 0-3, stage b on 4-7: the frame hands off
        device to device (one d2d/handoff row of its exact bytes) and
        the final output lives on stage b's first device."""
        monkeypatch.setattr(_xfer, "CARD_TYPES", ("cuda", "cpu"))
        register_model("sh_head", lambda x: x * 2.0, in_shapes=[(8, 8)])
        p = parse_launch(
            "appsrc name=src ! "
            "tensor_filter framework=torch-cuda model=sh_mlp "
            "mesh=data:4 devices=0-3 accelerator=cpu name=a ! "
            "tensor_filter framework=torch-cuda model=sh_head "
            "mesh=data:4 devices=4-7 accelerator=cpu name=b ! "
            "appsink name=out", device="cpu")
        try:
            src, a, b, sink = (p.elements[n]
                               for n in ("src", "a", "b", "out"))
            src.spec = TensorsSpec.parse("16:8", "float32", rate=0)
            x = RNG.standard_normal((8, 16)).astype(np.float32)
            h0 = _xfer.LEDGER.totals(direction="d2d", reason="handoff")
            with p:
                src.push_buffer(Buffer.of(x))
                src.end_of_stream()
                assert p.wait_eos(timeout=60)
                out = sink.pull(timeout=1)
                assert a.subplugin._placement.device_ids == (0, 1, 2, 3)
                assert b.subplugin._placement.device_ids == (4, 5, 6, 7)
                assert tmesh.device_ids_of(out[0].torch()) == (4, 5, 6, 7)
            h1 = _xfer.LEDGER.totals(direction="d2d", reason="handoff")
            assert (h1[0] - h0[0], h1[1] - h0[1]) == (1, 8 * 8 * 4)
            np.testing.assert_allclose(out[0].np(), _expected(x) * 2.0,
                                       **TOL)
        finally:
            unregister_model("sh_head")

    def test_mesh_matches_single_device_and_jax(self):
        x = RNG.standard_normal((8, 16)).astype(np.float32)

        def run(**fkw):
            p = Pipeline(device="cpu")
            src = AppSrc(name="src",
                         spec=TensorsSpec.parse("16:8", "float32", rate=0))
            f = TensorFilter(name="f", framework="torch-cuda",
                             model="sh_mlp", accelerator="cpu", **fkw)
            sink = AppSink(name="out")
            p.add(src, f, sink).link(src, f, sink)
            with p:
                src.push_buffer(Buffer.of(x))
                src.end_of_stream()
                assert p.wait_eos(timeout=60)
                return sink.pull(timeout=1)[0].np()

        tp = run(mesh="data:2,model:4", sharding="mobilenet")
        np.testing.assert_array_equal(tp, run())
        np.testing.assert_allclose(
            tp, _jax_out(x, model="sh_mlp", mesh="data:2,model:4",
                         sharding="mobilenet"), **TOL)


# -- sharded windows: rows per shard, kernels per shard -----------------------


def test_window_splits_in_stack_order_per_meshstat():
    """A window of n frames in a bucket over S shards: each shard's
    useful frames are meshstat's shard_split, and the prologue runs once
    per shard."""
    register_model("sh_rows", lambda x: x * 3.0, in_shapes=[(1, 4)])
    calls = []
    try:
        fs = _port(model="sh_rows", mesh="data:4")
        sp = fs.subplugin
        real = sp._model.fn

        def spy(x):
            calls.append(int(x.shape[0]))
            return real(x)

        sp._model.fn = spy
        sp._program = sp._build(sp._program.in_spec)
        MESH_STATS.reset()
        calls.clear()
        frames = [[np.full((1, 4), float(i), np.float32)] for i in range(6)]
        outs = sp.invoke_batched(frames, 8)
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o[0].numpy(),
                                          np.full((1, 4), 3.0 * i))
        # the probe runs the window once per shard (2 rows each), then
        # the first and last frame alone
        assert calls[:4] == [2, 2, 2, 2]
        row = MESH_STATS.get("sh_rows")
        assert row["shard_frames"] == shard_split(8, 6, 4) == [2, 2, 2, 0]
        assert row["pad_slots"] == 2
    finally:
        unregister_model("sh_rows")


def test_sharded_model_matches_jax():
    from nnstreamer_tpu.parallel import ShardedModel as JShardedModel
    from nnstreamer_tpu.parallel import make_mesh as jmake_mesh

    x = RNG.standard_normal((8, 16)).astype(np.float32)
    tm = tsharded.ShardedModel(
        tmesh.make_mesh("data:4,model:2"), lambda p, a: a @ p["w"] + p["b"],
        {"w": torch.from_numpy(W), "b": torch.from_numpy(B)}, name="shm")
    jm = JShardedModel(
        jmake_mesh("data:4,model:2", devices=jax.devices("cpu")[:8]),
        lambda p, a: jnp.dot(a, p["w"]) + p["b"],
        {"w": jnp.asarray(W), "b": jnp.asarray(B)}, name="shm")
    np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(),
                               np.asarray(jm(x)), **TOL)


# -- the rules on the real models, against the JAX rules ---------------------


def _jax_split_leaves(tree):
    from nnstreamer_tpu.parallel.sharded import mobilenet_param_rules

    out = []
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: out.append(tuple(leaf.shape)) if any(
            s is not None for s in mobilenet_param_rules(p, leaf)) else None,
        tree)
    return sorted(out)


def _mesh4():
    return tmesh.make_mesh("data:2,model:2", devices=tmesh.devices()[:4])


def _port_split_leaves(model):
    mesh = _mesh4()
    mp = tsharded.shard_params(mesh, model, tsharded.mobilenet_param_rules)
    tree = mp.tree(mesh.devices[0].tolist())
    shapes = []
    for m in tree.modules():
        for v in vars(m).values():
            if isinstance(v, tsharded.ShardedLeaf):
                shapes.append(tuple(v.shape))
    return mp, tree, sorted(shapes)


def _oihw_to_hwio(shape):
    return (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 \
        else shape


def test_ssd_tp_splits_the_jax_leaves_and_matches_jax():
    """The SSD's pointwise convolutions — OIHW here, HWIO in the JAX tree
    — split over model:2 in both packages, the same leaves; the raw
    heads at f32 equal the JAX package's sharded program."""
    from nnstreamer_tpu.models import ssd as jssd
    from nnstreamer_tpu.parallel import ShardedModel as JShardedModel
    from nnstreamer_tpu.parallel import make_mesh as jmake_mesh
    from nnstreamer_tpu_torch.models import convert

    jtree = jssd.ssd_mobilenet_v2_init(jax.random.PRNGKey(0), num_classes=5,
                                       image_size=64)
    jtree = jax.tree_util.tree_map(np.asarray, jtree)
    model = convert.ssd_from_jax(jtree)
    mp, tree, port_shapes = _port_split_leaves(model)
    jshapes = _jax_split_leaves({k: v for k, v in jtree.items()
                                 if k != "num_classes"})
    assert port_shapes and sorted(
        _oihw_to_hwio(s) for s in port_shapes) == jshapes
    x = np.random.default_rng(3).uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32)
    tm = tsharded.ShardedModel(
        _mesh4(), lambda m, a: m(a, dtype=torch.float32), model,
        name="ssd_tp")
    loc, cls = tm(torch.from_numpy(x))
    with torch.inference_mode():
        ref_loc, ref_cls = model(torch.from_numpy(x), dtype=torch.float32)
    np.testing.assert_array_equal(loc.numpy(), ref_loc.numpy())
    np.testing.assert_array_equal(cls.numpy(), ref_cls.numpy())
    params = {k: v for k, v in jtree.items() if k != "num_classes"}
    jm = JShardedModel(
        jmake_mesh("data:2,model:2", devices=jax.devices("cpu")[:4]),
        lambda p, a: jssd.ssd_mobilenet_v2_apply(
            {**p, "num_classes": 5}, a, dtype=jnp.float32), params,
        name="ssd_tp")
    jloc, jcls = jm(x)
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), **TOL)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), **TOL)


# -- the whole slice: the pooled ViT on mesh=data:4 ---------------------------

VIT = dict(image_size=32, patch=8, dim=64, depth=2, mlp_dim=128,
           num_classes=10)
HEADS = 2


def _pool_logits(parse, buf_of, framework, model, mesh, frames):
    """Two streams share one pool (batch 4 over mesh=data:4); the
    frames' logits in push order per stream."""
    desc = (f"appsrc name=src ! queue max-size-buffers=16 ! tensor_filter "
            f"framework={framework} model={model} share-model=true batch=4 "
            f"batch-buckets=4 batch-timeout-ms=50 accelerator=cpu "
            f"{mesh} ! appsink name=out max-buffers=64")
    pipes = [parse(desc, i) for i in range(2)]
    for p in pipes:
        p.start()
    try:
        for i, x in enumerate(frames):
            pipes[i % 2]["src"].push_buffer(buf_of(x, i))
        out = {i: None for i in range(len(frames))}
        for k in range(len(frames)):
            b = pipes[k % 2]["out"].pull(timeout=120)
            assert b is not None
            out[b.pts] = np.asarray(b.tensors[0].np(), np.float32)
        for p in pipes:
            p["src"].end_of_stream()
            p.wait_eos(timeout=60)
    finally:
        for p in pipes:
            p.stop()
    return [out[i] for i in range(len(frames))]


def test_pooled_vit_on_data4_matches_jax_pool():
    from nnstreamer_tpu.core import Buffer as JBuffer
    from nnstreamer_tpu.core import TensorsSpec as JTensorsSpec
    from nnstreamer_tpu.models import vit as jvit
    from nnstreamer_tpu.runtime import MODEL_POOL as JPOOL
    from nnstreamer_tpu.runtime import parse_launch as jparse
    from nnstreamer_tpu_torch.models import convert
    from nnstreamer_tpu_torch.models import vit as tvit
    from nnstreamer_tpu_torch.runtime.serving import MODEL_POOL

    tree = jax.tree_util.tree_map(
        np.asarray, jvit.vit_init(jax.random.PRNGKey(0), **VIT))
    model = convert.vit_from_jax(tree, heads=HEADS)
    shape = (1, 32, 32, 3)
    jregister("vit_mesh", lambda p, x: jvit.vit_apply(
        p, x, heads=HEADS, dtype=jnp.float32), params=tree,
        in_shapes=[shape])
    register_model("vit_mesh", lambda m, x: tvit.vit_apply(
        m, x, torch.float32), params=model, in_shapes=[shape])
    frames = [np.random.default_rng(10 + i).standard_normal(shape).astype(
        np.float32) for i in range(8)]

    def tparse(desc, i):
        p = parse_launch(desc, device="cpu")
        p["src"].spec = TensorsSpec.from_shapes([shape], np.float32)
        return p

    def jparse_(desc, i):
        p = jparse(desc.replace("torch-cuda", "jax-xla"))
        p["src"].spec = JTensorsSpec.from_shapes([shape], np.float32)
        return p

    try:
        MESH_STATS.reset()
        port = _pool_logits(tparse, lambda x, i: Buffer.of(x, pts=i),
                            "torch-cuda", "vit_mesh", "mesh=data:4", frames)
        row = MESH_STATS.get("vit_mesh")
        plain = _pool_logits(tparse, lambda x, i: Buffer.of(x, pts=i),
                             "torch-cuda", "vit_mesh", "", frames)
        jax_pool = _pool_logits(jparse_, lambda x, i: JBuffer.of(x, pts=i),
                                "torch-cuda", "vit_mesh", "mesh=data:4",
                                frames)
    finally:
        unregister_model("vit_mesh")
        junregister("vit_mesh")
        MODEL_POOL.clear()
        JPOOL.clear()
    assert row["shards"] == 4 and row["imbalance"] == 0.0
    for a, b, c in zip(port, plain, jax_pool):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, **TOL)


def test_attention_stride_rule_on_qkv_batch_slices():
    """A data shard's rows of the qkv projection, split into heads, are
    views the attention's stride rule accepts as they are (no copy), and
    the plain attention on them equals those rows of the whole batch."""
    from nnstreamer_tpu_torch.ops import kernels

    b, s, d, h = 8, 16, 64, 2
    qkv = torch.randn(b, s, 3 * d)
    heads = [t.reshape(t.shape[0], s, h, d // h).transpose(1, 2)
             for t in qkv.split(d, dim=-1)]
    whole = kernels.flash_attention_reference(*heads)
    for k in range(4):
        part = qkv[k * 2:(k + 1) * 2]
        views = [t.reshape(2, s, h, d // h).transpose(1, 2)
                 for t in part.split(d, dim=-1)]
        for v in views:
            lay = kernels._fa_layout(v)
            assert not isinstance(lay, str), lay
            assert v.data_ptr() != 0 and v.storage_offset() >= 0
        got = kernels.flash_attention_reference(*views)
        np.testing.assert_allclose(got.numpy(), whole[k * 2:(k + 1) * 2]
                                   .numpy(), rtol=1e-6, atol=1e-6)
