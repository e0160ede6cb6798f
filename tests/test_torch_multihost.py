"""The port's multi-process layer (``nnstreamer_tpu_torch/parallel/
multihost.py``): ``tests/test_multihost.py`` replayed over 8 virtual host
devices (``parallel.mesh.set_virtual_devices``), the ``initialize`` contract on
``torch.distributed``, and a TWO-PROCESS gloo world — the counterpart of
``tests/test_multihost_twoprocess.py``: two worker processes join one
group through ``multihost.initialize`` (4 virtual devices each), run a
psum and the other collectives over both processes against their
one-device meaning, a sharded filter whose batch spans both processes,
and a ``share-model`` pool on ``mesh=dcn.data:2,data:4`` whose global
window each process demuxes to its own frames.

Every worker has its own timeout and a free port, so no test can hang
the run.  Tolerances: data movement bit-equal, sums and attention at f32
atol 1e-5.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_replay import replay

from nnstreamer_tpu_torch.parallel import mesh as _mesh
from nnstreamer_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _virtual_devices():
    _mesh.set_virtual_devices(8, "cpu")
    yield
    _mesh.clear_virtual_devices()


replay("test_multihost.py", globals(), subs=(
    ('    import jax\n\n    devs = jax.devices("cpu")\n',
     '    from nnstreamer_tpu.parallel.mesh import local_devices\n\n'
     '    devs = local_devices("cpu")\n'),
    ("        import jax\n\n        from nnstreamer_tpu.parallel.multihost "
     "import _mesh_by_process\n",
     "        from nnstreamer_tpu.parallel.multihost import "
     "_mesh_by_process\n"),
    ("_mesh_by_process(jax, ", "_mesh_by_process("),
    # the sharded compute: the port's ShardedModel over the hybrid mesh
    ("        import jax\n        from jax.sharding import NamedSharding, "
     "PartitionSpec as P\n",
     "        import torch\n"
     "        from nnstreamer_tpu.parallel import ShardedModel\n"),
    ('        s = NamedSharding(m, P("data", "model"))\n'
     "        xd = jax.device_put(x, s)\n"
     "        y = jax.jit(lambda a: a * 2 + 1, out_shardings=s)(xd)\n",
     "        y = ShardedModel(m, lambda a: a * 2 + 1)(torch.from_numpy(x))\n"),
), leave_out=("TestInitialize",))


class TestPortInitialize:
    """``initialize`` passes only what it was given to
    ``init_process_group`` (the environment's rendezvous applies
    otherwise), and never drops NCCL to gloo without a card."""

    def test_explicit_args_pass_through(self, monkeypatch):
        import torch.distributed as dist

        calls = {}
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: calls.update(
                                backend=backend, **kw))
        multihost.initialize(coordinator_address="10.0.0.1:1234",
                             num_processes=4, process_id=2,
                             backend="gloo")
        assert calls == {"backend": "gloo",
                         "init_method": "tcp://10.0.0.1:1234",
                         "world_size": 4, "rank": 2}

    def test_autodetect_passes_nothing(self, monkeypatch):
        import torch.distributed as dist

        calls = {"n": 0, "kw": None}

        def fake(backend, **kw):
            calls["n"] += 1
            calls["kw"] = kw

        monkeypatch.setattr(dist, "init_process_group", fake)
        multihost.initialize(backend="gloo")
        assert calls == {"n": 1, "kw": {}}

    def test_nccl_without_card_raises(self, monkeypatch):
        import torch.distributed as dist

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(dist, "init_process_group",
                            lambda *a, **k: pytest.fail("group formed"))
        with pytest.raises(RuntimeError, match="nccl"):
            multihost.initialize(backend="nccl")

    def test_default_backend_follows_the_card(self, monkeypatch):
        import torch.distributed as dist

        seen = []
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: seen.append(backend))
        multihost.initialize()
        assert seen == ["nccl" if torch.cuda.is_available() else "gloo"]


class TestPortHybridMesh:
    def test_dcn_axes_recorded(self):
        m = multihost.hybrid_mesh([("model", 2), ("data", 2)],
                                  [("replica", 1)])
        assert m.dcn_axes == ("replica",)
        assert m.shape == {"replica": 1, "model": 2, "data": 2}


# -- the two-process gloo world -----------------------------------------------

WORKER = textwrap.dedent("""\
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch

    pid = int(sys.argv[1])
    port = sys.argv[2]

    from nnstreamer_tpu_torch.parallel import mesh, multihost

    mesh.set_virtual_devices(4, "cpu")
    multihost.initialize(coordinator_address="127.0.0.1:" + port,
                         num_processes=2, process_id=pid, backend="gloo")
    idx, cnt = multihost.process_info()
    assert (idx, cnt) == (pid, 2), (idx, cnt)
    assert len(mesh.devices()) == 8 and len(mesh.local_devices()) == 4
    assert [d.process_index for d in mesh.devices()] == [0] * 4 + [1] * 4

    m = multihost.hybrid_mesh([("data", 4)], [("replica", 2)])
    assert m.axis_names == ("replica", "data")
    assert m.shape == {{"replica": 2, "data": 4}}

    # -- the collectives across BOTH processes ------------------------------
    from nnstreamer_tpu_torch.parallel import collectives as C

    both = ("replica", "data")
    x = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    got = C.psum_reduce(m, both)(x)
    assert float(got.sum()) == float(x.sum()), (got, x.sum())
    print(f"psum ok process={{pid}} value={{float(got.sum())}}", flush=True)
    assert torch.equal(C.all_gather_merge(m, both)(x), x)
    assert torch.equal(C.ring_shift(m, both, 1)(x), torch.roll(x, 1, 0))
    y = torch.arange(8 * 8 * 2, dtype=torch.float32).reshape(8, 8, 2)
    assert torch.equal(C.all_to_all_regroup(m, both, 1, 0)(y), y)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 8, generator=g) for _ in range(3))
    ref = torch.softmax(q @ k.transpose(1, 2) / 8 ** 0.5, -1) @ v
    att = C.ring_attention(m, both)(q, k, v)
    assert torch.allclose(att, ref, rtol=1e-5, atol=1e-5), \\
        (att - ref).abs().max()
    print(f"collectives ok process={{pid}}", flush=True)

    # -- a sharded filter whose batch spans both processes ------------------
    from nnstreamer_tpu_torch.elements.filter import FilterSingle
    from nnstreamer_tpu_torch.filters import register_model

    register_model("twoproc_double", lambda a: a * 2.0 + 1.0,
                   in_shapes=[(8, 4)], in_dtypes=np.float32)
    flt = FilterSingle(framework="torch-cuda", model="twoproc_double",
                       device="cpu", mesh="dcn.data:2,data:4")
    rp = flt.subplugin._placement
    assert rp.num_processes == 2 and rp.data_axis_size == 8
    assert len(rp.groups) == 4
    xin = np.arange(32, dtype=np.float32).reshape(8, 4)
    out = flt.invoke([xin])[0].numpy()
    np.testing.assert_array_equal(out, xin * 2.0 + 1.0)
    print(f"filter ok process={{pid}} shards={{len(rp.groups)}}", flush=True)

    # -- the shared pool's global window, per-process demux -----------------
    from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
    from nnstreamer_tpu_torch.elements.basic import AppSink, AppSrc, Queue
    from nnstreamer_tpu_torch.elements.filter import TensorFilter
    from nnstreamer_tpu_torch.runtime import Pipeline

    register_model("twoproc_pool", lambda a: a * 2.0 + 1.0,
                   in_shapes=[(1, 4)], in_dtypes=np.float32)
    spec = TensorsSpec.from_shapes([(1, 4)], np.float32)
    batch = 4
    p = Pipeline(name="pool" + str(pid), device="cpu")
    src = AppSrc(name="src", spec=spec, max_buffers=batch + 4)
    q = Queue(name="q", max_size_buffers=16)
    flt = TensorFilter(name="net", framework="torch-cuda",
                       model="twoproc_pool", share_model=True,
                       batch=batch, batch_timeout_ms=60000.0,
                       batch_buckets=str(batch),
                       mesh="dcn.data:2,data:4")
    sink = AppSink(name="out", max_buffers=16)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    p.start()
    rp = flt.pool.placement
    assert rp.num_processes == 2 and rp.data_axis_size == 8
    assert rp.process_index == pid
    for i in range(batch):
        src.push_buffer(Buffer.of(
            np.full((1, 4), 10.0 * pid + i, np.float32), pts=i))
    for i in range(batch):
        b = sink.pull(timeout=30)
        assert b is not None, i
        assert b.pts == i, (b.pts, i)
        np.testing.assert_array_equal(
            b.tensors[0].np(), np.full((1, 4), (10.0 * pid + i) * 2.0 + 1.0))
    st = flt.pool.stats.snapshot()
    assert st["invokes"] == 1 and st["frames"] == batch, st
    src.end_of_stream()
    assert p.wait_eos(timeout=30)
    p.stop()
    from nnstreamer_tpu_torch.obs.meshstat import MESH_STATS

    row = MESH_STATS.get("twoproc_pool")
    assert row["data_axis"] == "data" and row["shard_frames"] == [1] * 4
    print("pool ok process=" + str(pid), flush=True)
    multihost.shutdown()
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_world(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for i in range(2)]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=180)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for pr in procs:
            pr.kill()
            pr.communicate()
        pytest.fail("two-process workers timed out:\n" + "\n".join(outs))
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {i} failed:\n{out}"
        for what in ("psum ok", "collectives ok", "filter ok", "pool ok"):
            assert f"{what} process={i}" in out, out
        assert f"value={16 * 15 / 2}" in out, out
