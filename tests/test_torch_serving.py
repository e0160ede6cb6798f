"""The port's shared-model serving (``runtime/serving.py`` +
``tensor_filter share-model=true``) against the JAX package's, on the CPU.

The scenarios of ``tests/test_serving.py`` run through both packages
(``pkg`` parameter): per-stream FIFO order, pts and payload integrity
under concurrent streams with cross-stream coalescing; one pipeline
stopping midway while the survivor keeps dispatching; restart after stop;
conflicting pool settings; a sharer with incompatible caps; invoke-dynamic
refused; the per-stream ``flush_stream``; the adaptive window.  Values
are exact (the model is ``x * 2 + 1`` in f32).

Port only: a framework without ``SUPPORTS_BATCH`` dispatches per frame,
and a model whose outputs do not scale with the window, or that mixes
the rows of its leading axis, runs it frame by frame, equal to the JAX
pool's ``vmap`` within 1e-6.

The slice as a whole: 3 streams × ``share-model=true batch=4`` over the
small ViT of ``tests/test_torch_vit.py`` (weights carried across by
``vit_from_jax``, f32 compute), transform unfused ahead of the pooled
filter as the pool requires: per-frame logits equal to the JAX pool's
within 1e-3.  The same slice from model files: each package's pool
opens its own weights file of one numpy tree (``file://…@v0``), hot-swaps
to ``@v1`` and serves again, per-frame logits equal within 1e-3.

Admission's ingress anchor (both packages): a source stamps each buffer
with its ingress time only while a pool's admission controller is armed
(armed by the attach of a stream under ``slo-ms``, disarmed with the last
stream); a pool held back behind an upstream ``queue`` takes that stamp
as each frame's entry time, so the backlog's wait reaches the p99, which
crosses the shedding ramp at the same observation in both packages.

Every pipeline and pool a test starts is stopped and its threads joined.
"""

import functools
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu.core as jcore
import nnstreamer_tpu.elements.basic as jbasic
import nnstreamer_tpu.runtime as jruntime
import nnstreamer_tpu.runtime.admission as jadmission
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.elements.basic as tbasic
import nnstreamer_tpu_torch.runtime as truntime
import nnstreamer_tpu_torch.runtime.admission as tadmission
from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
from nnstreamer_tpu.filters import jax_xla
from nnstreamer_tpu.models import vit as jvit
from nnstreamer_tpu.runtime import serving as jserving
from nnstreamer_tpu_torch.elements.filter import TensorFilter as TFilter
from nnstreamer_tpu_torch.filters import (
    TorchCudaFilter,
    register_filter,
    register_model,
    unregister_model,
)
from nnstreamer_tpu_torch.filters.api import SHARED_MODELS, FilterProps
from nnstreamer_tpu_torch.models import convert
from nnstreamer_tpu_torch.models import vit as tvit
from nnstreamer_tpu_torch.runtime import serving as tserving

SHAPE = (4,)

PKGS = {
    "jax": SimpleNamespace(
        core=jcore, basic=jbasic, Filter=JFilter, fw="jax-xla",
        serving=jserving, admission=jadmission, NegotiationError=jruntime.NegotiationError,
        pipeline=lambda name: jruntime.Pipeline(name=name),
        parse_launch=jruntime.parse_launch),
    "port": SimpleNamespace(
        core=tcore, basic=tbasic, Filter=TFilter, fw="torch-cuda",
        serving=tserving, admission=tadmission, NegotiationError=truntime.NegotiationError,
        pipeline=lambda name: truntime.Pipeline(name=name, device="cpu"),
        parse_launch=functools.partial(truntime.parse_launch,
                                       device="cpu")),
}


@register_filter
class _NoBatchFilter(TorchCudaFilter):
    """torch-cuda without the batched entry point."""
    NAME = "torch-cuda-nobatch"
    SUPPORTS_BATCH = False


@pytest.fixture(scope="module", autouse=True)
def _model():
    jax_xla.register_model("_t_torch_serving", lambda x: x * 2.0 + 1.0,
                           in_shapes=[SHAPE], in_dtypes=np.float32)
    register_model("_t_torch_serving", lambda x: x * 2.0 + 1.0,
                   in_shapes=[SHAPE], in_dtypes=np.float32)
    yield
    jax_xla.unregister_model("_t_torch_serving")
    unregister_model("_t_torch_serving")


@pytest.fixture(autouse=True)
def _pool_clean():
    threads = set(threading.enumerate())
    yield
    # a failed test must not leak refcounts into the next one
    for k in PKGS.values():
        k.serving.MODEL_POOL.clear()
    with jax_xla.JaxXlaFilter._shared_lock:
        jax_xla.JaxXlaFilter._shared_instances.clear()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            set(threading.enumerate()) - threads:
        time.sleep(0.01)
    assert not {t.name for t in set(threading.enumerate()) - threads
                if t.name.startswith("nns")}


def _frame(k, stream: int, i: int):
    # stream-tagged values so demux mixups are detectable, not just
    # ordering slips
    return k.core.Buffer.of(np.full(SHAPE, stream * 1000.0 + i, np.float32),
                            pts=i)


def _pipeline(k, tag: str, share=True, batch=8, timeout_ms=50.0, n_bufs=64,
              framework=None, model="_t_torch_serving", spec=None,
              **filter_props):
    p = k.pipeline(f"p_{tag}")
    spec = spec or k.core.TensorsSpec.from_shapes([SHAPE], np.float32)
    src = k.basic.AppSrc(name="src", spec=spec, max_buffers=n_bufs + 4)
    q = k.basic.Queue(name="q", max_size_buffers=n_bufs + 4)
    flt = k.Filter(name="net", framework=framework or k.fw, model=model,
                   batch=batch, batch_timeout_ms=timeout_ms,
                   share_model=share, **filter_props)
    sink = k.basic.AppSink(name="out", max_buffers=n_bufs + 4)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    return p, src, flt, sink


def _pull_all(sink, n, timeout=10.0):
    out = []
    for _ in range(n):
        b = sink.pull(timeout=timeout)
        assert b is not None, f"stream stalled after {len(out)}/{n} buffers"
        out.append(b)
    return out


def _check_stream(bufs, stream: int):
    """Per-stream FIFO + pts + value integrity."""
    for i, b in enumerate(bufs):
        assert b.pts == i, f"stream {stream}: pts {b.pts} at slot {i}"
        np.testing.assert_array_equal(
            np.asarray(b.tensors[0].np()),
            np.full(SHAPE, (stream * 1000.0 + i) * 2.0 + 1.0),
            err_msg=f"stream {stream} frame {i}: wrong payload")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_concurrent_streams_fifo_pts_and_cross_stream_coalescing(pkg):
    """Every dispatch is held until each stream has parked a frame.  A
    producer whose window fills dispatches inline, and a fast one can
    fill window after window of its own frames before another stream's
    thread runs; the JAX pool only mixed streams because its first
    dispatch compiles for ~0.2 s while the others park.  Behind a held
    dispatch at most ``batch - 1`` frames plus one of each blocked
    stream wait, so the frames of the other three streams cannot all
    land in single-stream windows."""
    k = PKGS[pkg]
    n_streams, n = 4, 40
    parked, all_parked = set(), threading.Event()
    submit_from = k.serving.SharedBatcher.submit_from
    dispatch = k.serving.PoolEntry._dispatch

    def recording(self, stream, item, *a, **kw):
        parked.add(id(stream))
        if len(parked) == n_streams:
            all_parked.set()
        return submit_from(self, stream, item, *a, **kw)

    def held(self, items):
        all_parked.wait(10)
        return dispatch(self, items)

    k.serving.SharedBatcher.submit_from = recording
    k.serving.PoolEntry._dispatch = held
    try:
        _run_concurrent_streams(k, n_streams, n)
    finally:
        k.serving.SharedBatcher.submit_from = submit_from
        k.serving.PoolEntry._dispatch = dispatch
    assert all_parked.is_set()


def _run_concurrent_streams(k, n_streams, n):
    pipes = [_pipeline(k, str(s)) for s in range(n_streams)]
    for p, *_ in pipes:
        p.start()
    flt0 = pipes[0][2]
    assert flt0.pool_streams == n_streams
    assert all(p[2].subplugin is flt0.subplugin for p in pipes)

    def produce(s):
        _, src, _, _ = pipes[s]
        for i in range(n):
            src.push_buffer(_frame(k, s, i))
        src.end_of_stream()

    threads = [threading.Thread(target=produce, args=(s,))
               for s in range(n_streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for p, *_ in pipes:
        assert p.wait_eos(timeout=30)
    st = flt0.pool.stats
    assert st.total_frame_num == n_streams * n
    assert st.total_invoke_num < n_streams * n
    assert st.avg_stream_occupancy > 1.0
    for s, (p, _, flt, sink) in enumerate(pipes):
        _check_stream(_pull_all(sink, n), s)
        assert flt.invoke_stats.total_frame_num == n
        p.stop()
    assert len(k.serving.MODEL_POOL) == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_one_pipeline_stops_midstream_survivor_keeps_dispatching(pkg):
    k = PKGS[pkg]
    p1, s1, f1, k1 = _pipeline(k, "a")
    p2, s2, f2, k2 = _pipeline(k, "b")
    p1.start()
    p2.start()
    assert f1.subplugin is f2.subplugin and f1.pool.refcount == 2
    n = 10
    for i in range(n):
        s1.push_buffer(_frame(k, 1, i))
        s2.push_buffer(_frame(k, 2, i))
    _check_stream(_pull_all(k1, n), 1)
    entry = f2.pool
    p1.stop()  # refcount drops, entry survives for the survivor
    assert len(k.serving.MODEL_POOL) == 1
    assert entry.refcount == 1 and entry.attached_streams == 1
    for i in range(n, 2 * n):
        s2.push_buffer(_frame(k, 2, i))
    s2.end_of_stream()
    assert p2.wait_eos(timeout=30)
    _check_stream(_pull_all(k2, 2 * n), 2)
    p2.stop()
    assert len(k.serving.MODEL_POOL) == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_restart_after_stop_reattaches_cleanly(pkg):
    k = PKGS[pkg]
    p1, s1, f1, k1 = _pipeline(k, "a")
    p2, s2, f2, k2 = _pipeline(k, "b")
    p1.start()
    p2.start()
    p1.stop()
    assert f1.subplugin is None and f1.pool is None
    p1.start()  # re-acquires the (still alive) entry and reattaches
    assert f1.subplugin is f2.subplugin
    assert f1.pool is f2.pool and f1.pool.refcount == 2
    assert f1.pool.attached_streams == 2
    n = 6
    for i in range(n):
        s1.push_buffer(_frame(k, 1, i))
    s1.end_of_stream()
    assert p1.wait_eos(timeout=30)
    _check_stream(_pull_all(k1, n), 1)
    p1.stop()
    p2.stop()
    assert len(k.serving.MODEL_POOL) == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_conflicting_batch_settings_across_sharers_rejected(pkg):
    k = PKGS[pkg]
    p1, *_ = _pipeline(k, "a", batch=4)
    p2, *_ = _pipeline(k, "b", batch=8)  # disagrees with the pool
    p1.start()
    with pytest.raises(ValueError, match="conflict"):
        p2.start()
    p2.stop()
    p1.stop()
    assert len(k.serving.MODEL_POOL) == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_sharer_with_incompatible_caps_rejected_not_reshaped(pkg):
    k = PKGS[pkg]
    p1, s1, f1, k1 = _pipeline(k, "a")
    p1.start()
    wide = k.core.TensorsSpec.from_shapes([(8,)], np.float32)
    p2, *_ = _pipeline(k, "bad", spec=wide)
    with pytest.raises(k.NegotiationError, match="identical input"):
        p2.start()
    assert f1.pool.refcount == 1  # the failed start released its share
    n = 5
    for i in range(n):
        s1.push_buffer(_frame(k, 1, i))
    s1.end_of_stream()
    assert p1.wait_eos(timeout=30)
    _check_stream(_pull_all(k1, n), 1)
    p1.stop()
    assert len(k.serving.MODEL_POOL) == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_share_model_rejects_invoke_dynamic(pkg):
    k = PKGS[pkg]
    p, _, flt, _ = _pipeline(k, "dyn")
    flt.invoke_dynamic = True
    with pytest.raises(ValueError, match="share-model"):
        flt.open_fw()
    assert len(k.serving.MODEL_POOL) == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_flush_stream_drains_only_that_streams_parked_frames(pkg):
    flushed = []
    sb = PKGS[pkg].serving.SharedBatcher(
        max_batch=4, timeout_s=1000.0, flush_fn=flushed.extend,
        adaptive=False)
    sb.submit_from("A", 1)
    sb.submit_from("B", 2)
    sb.submit_from("A", 3)
    sb.flush_stream("A")
    assert [it[:2] for it in flushed] == [("A", 1), ("B", 2), ("A", 3)]
    sb.submit_from("B", 4)
    sb.flush_stream("A")  # nothing of A parked: B's window is untouched
    assert len(flushed) == 3 and sb.pending_of("B") == 1
    sb.flush_stream("B")
    assert flushed[-1][:2] == ("B", 4)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_edf_window_formation_keeps_per_stream_fifo(pkg):
    flushed = []
    sb = PKGS[pkg].serving.SharedBatcher(
        max_batch=2, timeout_s=1000.0, flush_fn=flushed.append,
        adaptive=False)
    sb.edf = True
    sb._flush_serial_lock.acquire()  # hold windows while the queue fills
    try:
        for stream, dl, enq in (("bulk", 1.0, 0.0), ("bulk", 1.0, 0.1),
                                ("rt", 0.05, 0.2), ("rt", 0.05, 0.3)):
            with sb._cv:
                sb._pending.append((stream, enq, enq + dl, enq))
    finally:
        sb._flush_serial_lock.release()
    sb.flush()
    assert [[it[:2] for it in w] for w in flushed] == [
        [("rt", 0.2), ("rt", 0.3)], [("bulk", 0.0), ("bulk", 0.1)]]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_adaptive_window_flushes_on_idle_device_before_deadline(pkg):
    k = PKGS[pkg]
    p, src, flt, sink = _pipeline(k, "a", timeout_ms=60_000.0)
    with p:
        t0 = time.monotonic()
        src.push_buffer(_frame(k, 0, 0))
        b = sink.pull(timeout=10.0)
        assert b is not None and b.pts == 0
        assert time.monotonic() - t0 < 5.0  # far below the 60 s deadline
        assert flt.pool.batcher.flushes_adaptive >= 1
        src.end_of_stream()
        assert p.wait_eos(timeout=30)
    assert len(k.serving.MODEL_POOL) == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_pool_entry_stats_visible_on_element(pkg):
    k = PKGS[pkg]
    (p1, s1, f1, k1), (p2, s2, f2, k2) = (_pipeline(k, t) for t in "ab")
    p1.start()
    p2.start()
    n = 12
    for i in range(n):
        s1.push_buffer(_frame(k, 1, i))
        s2.push_buffer(_frame(k, 2, i))
    s1.end_of_stream()
    s2.end_of_stream()
    assert p1.wait_eos(timeout=30) and p2.wait_eos(timeout=30)
    _pull_all(k1, n)
    _pull_all(k2, n)
    assert f1.pool.stats is f2.pool.stats
    assert f1.pool.stats.total_frame_num == 2 * n
    assert f1.pool.stats.attached_streams == 2
    assert f1.pool_stream_occupancy >= 1.0
    p1.stop()
    p2.stop()


def test_pool_key_and_shared_instance_follow_the_device():
    """``accelerator=cpu`` and ``true:cpu`` on a CPU pipeline are one
    pool key, so the pool opens ONE instance for all three and closes it
    when the last sharer releases it."""
    props = [FilterProps(framework="torch-cuda", model="_t_torch_serving",
                         accelerator=a, device=torch.device("cpu"))
             for a in ("", "cpu", "true:cpu")]
    keys = [tserving.pool_key("torch-cuda", pr) for pr in props]
    assert len(set(keys)) == 1
    opened = []

    def open_fn(pr):
        opened.append(TorchCudaFilter.open_shared(pr))
        return opened[-1]

    pool = tserving.ModelPool()
    entries = [pool.acquire(k, functools.partial(open_fn, pr),
                            TorchCudaFilter.close_shared)
               for k, pr in zip(keys, props)]
    assert len(opened) == 1 and all(e is entries[0] for e in entries)
    assert entries[0].refcount == 3 and opened[0]._program is not None
    for e in entries:
        pool.release(e)
    assert opened[0]._program is None and len(pool) == 0


def test_shared_tensor_filter_key_shares_the_program():
    desc = ("appsrc name=src ! tensor_filter framework=torch-cuda "
            "model=_t_torch_serving shared-tensor-filter-key=k1 ! "
            "appsink name=out")
    p1, p2 = (truntime.parse_launch(desc, device="cpu") for _ in range(2))
    for p in (p1, p2):
        p["src"].spec = tcore.TensorsSpec.parse("4", "float32")
    with p1, p2:
        f1, f2 = (p.elements["tensor_filter0"] for p in (p1, p2))
        assert f1.subplugin is not f2.subplugin
        assert f1.subplugin._program is f2.subplugin._program
        for i, p in enumerate((p1, p2)):
            p["src"].push_buffer(_frame(PKGS["port"], i, 0))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=30)
            _check_stream([p["out"].pull(timeout=1)], i)
    SHARED_MODELS.remove("torch-cuda:k1:cpu")


def test_framework_without_supports_batch_dispatches_per_frame():
    k = PKGS["port"]
    p1, s1, f1, k1 = _pipeline(k, "a", framework="torch-cuda-nobatch",
                               batch=4)
    p2, s2, f2, k2 = _pipeline(k, "b", framework="torch-cuda-nobatch",
                               batch=4)
    p1.start()
    p2.start()
    assert f1.subplugin is f2.subplugin  # shared instance
    assert f1._pool_batched is False and f1.pool.batcher is None
    n = 8
    for i in range(n):
        s1.push_buffer(_frame(k, 1, i))
        s2.push_buffer(_frame(k, 2, i))
    s1.end_of_stream()
    s2.end_of_stream()
    assert p1.wait_eos(timeout=30) and p2.wait_eos(timeout=30)
    _check_stream(_pull_all(k1, n), 1)
    _check_stream(_pull_all(k2, n), 2)
    assert f1.invoke_stats.total_invoke_num == n  # per-frame dispatch
    p1.stop()
    p2.stop()


def test_window_of_a_model_that_does_not_scale_runs_per_frame():
    """Per frame (2, 4) → its column means (4,): folded, the window's
    leading axis would vanish, so the pool runs the window frame by
    frame; each frame equals the JAX pool's (vmap) result."""
    shape = (2, 4)
    jax_xla.register_model("_t_torch_serving_mean", lambda x: x.mean(0),
                           in_shapes=[shape], in_dtypes=np.float32)
    register_model("_t_torch_serving_mean", lambda x: x.mean(0),
                   in_shapes=[shape], in_dtypes=np.float32)
    rng = np.random.default_rng(3)
    xs = [[rng.standard_normal(shape).astype(np.float32) for _ in range(5)]
          for _ in range(2)]
    got = {}
    for pkg, k in PKGS.items():
        spec = k.core.TensorsSpec.from_shapes([shape], np.float32)
        pipes = [_pipeline(k, f"m{s}", batch=4, timeout_ms=60_000.0,
                           model="_t_torch_serving_mean", spec=spec)
                 for s in range(2)]
        for p, *_ in pipes:
            p.start()
        for s, (_, src, _, _) in enumerate(pipes):
            for i, x in enumerate(xs[s]):
                src.push_buffer(k.core.Buffer.of(x, pts=i))
        for p, src, _, _ in pipes:
            src.end_of_stream()
            assert p.wait_eos(timeout=60)
        got[pkg] = [[np.asarray(b.tensors[0].np())
                     for b in _pull_all(sink, 5)] for _, _, _, sink in pipes]
        if pkg == "port":
            # a window of one folds trivially; any larger one may not
            folds = {b: v for (_, b), v in
                     pipes[0][2].subplugin._batch_fold.items()}
            assert False in folds.values()
            assert not any(v for b, v in folds.items() if b > 1)
        for p, *_ in pipes:
            p.stop()
    for s in range(2):
        for i in range(5):
            assert got["port"][s][i].shape == (4,)
            np.testing.assert_allclose(got["port"][s][i], got["jax"][s][i],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got["port"][s][i], xs[s][i].mean(0),
                                       rtol=1e-6, atol=1e-6)
    jax_xla.unregister_model("_t_torch_serving_mean")
    unregister_model("_t_torch_serving_mean")


def test_window_of_a_model_that_mixes_rows_runs_per_frame():
    """Per frame (1, 4) → scaled by its own largest magnitude.  Folded,
    the window would be scaled by the largest over all its frames: the
    output shapes fit, but the rows of the first and last frame differ
    from those frames alone, so the verdict is per frame and every
    frame equals the JAX pool's (vmap) result.  A window whose probe
    frames are one input proves nothing and is not cached."""
    shape = (1, 4)

    def jax_fn(x):
        return x / jnp.abs(x).max()

    def port_fn(x):
        return x / x.abs().max()

    jax_xla.register_model("_t_torch_serving_mix", jax_fn,
                           in_shapes=[shape], in_dtypes=np.float32)
    register_model("_t_torch_serving_mix", port_fn,
                   in_shapes=[shape], in_dtypes=np.float32)
    rng = np.random.default_rng(4)
    xs = [[(rng.standard_normal(shape) * (1 + 10 * s + i)).astype(np.float32)
           for i in range(5)] for s in range(2)]
    got = {}
    for pkg, k in PKGS.items():
        spec = k.core.TensorsSpec.from_shapes([shape], np.float32)
        pipes = [_pipeline(k, f"x{s}", batch=4, timeout_ms=60_000.0,
                           model="_t_torch_serving_mix", spec=spec)
                 for s in range(2)]
        for p, *_ in pipes:
            p.start()
        for s, (_, src, _, _) in enumerate(pipes):
            for i, x in enumerate(xs[s]):
                src.push_buffer(k.core.Buffer.of(x, pts=i))
        for p, src, _, _ in pipes:
            src.end_of_stream()
            assert p.wait_eos(timeout=60)
        got[pkg] = [[np.asarray(b.tensors[0].np())
                     for b in _pull_all(sink, 5)] for _, _, _, sink in pipes]
        if pkg == "port":
            sp = pipes[0][2].subplugin
            assert sp._batch_fold and not any(sp._batch_fold.values())
        for p, *_ in pipes:
            p.stop()
    for s in range(2):
        for i in range(5):
            want = xs[s][i] / np.abs(xs[s][i]).max()
            np.testing.assert_allclose(got["port"][s][i], got["jax"][s][i],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got["port"][s][i], want,
                                       rtol=1e-6, atol=1e-6)
    # the verdict waits for two different probe frames
    sp = TorchCudaFilter()
    sp.configure(FilterProps(framework="torch-cuda",
                             model="_t_torch_serving_mix",
                             device=torch.device("cpu")))
    x0, x1 = xs[0][0], xs[1][4]
    assert np.allclose(sp.invoke_batched([[x0], [x0]], 2)[1][0].numpy(),
                       x0 / np.abs(x0).max())
    assert not sp._batch_fold
    outs = sp.invoke_batched([[x0], [x1]], 2)
    assert sp._batch_fold == {(sp._program.in_spec, 2): False}
    np.testing.assert_allclose(outs[0][0].numpy(), x0 / np.abs(x0).max(),
                               rtol=1e-6)
    sp.close()
    jax_xla.unregister_model("_t_torch_serving_mix")
    unregister_model("_t_torch_serving_mix")


# -- the slice as a whole: pooled small ViT ----------------------------------

TINY = dict(image_size=32, patch=8, dim=256, depth=2, mlp_dim=128,
            num_classes=5)
SLICE = ("appsrc name=src ! queue max-size-buffers=16 ! "
         "tensor_transform mode=arithmetic "
         "option=typecast:float32,add:-127.5,div:127.5 backend=pallas ! "
         "tensor_filter name=net framework={fw} model=torch_serving_vit "
         "share-model=true batch=4 batch-timeout-ms=50 batch-buckets=2,4 ! "
         "appsink name=out max-buffers=16")


def test_pooled_vit_slice_matches_jax_pool():
    heads, n_streams, n = 2, 3, 4
    tree = jax.tree_util.tree_map(np.asarray, jvit.vit_init(
        jax.random.PRNGKey(0), **TINY))
    shapes = [(1, 32, 32, 3)]
    jax_xla.register_model(
        "torch_serving_vit",
        lambda p, x: jvit.vit_apply(p, x, heads=heads, dtype=jnp.float32),
        params=tree, in_shapes=shapes, in_dtypes=np.float32)
    register_model("torch_serving_vit",
                   lambda m, x: tvit.vit_apply(m, x, torch.float32),
                   params=convert.vit_from_jax(tree, heads),
                   in_shapes=shapes, in_dtypes=np.float32)
    rng = np.random.default_rng(5)
    frames = [[rng.integers(0, 256, shapes[0], dtype=np.uint8)
               for _ in range(n)] for _ in range(n_streams)]
    logits = {}
    for pkg, k in PKGS.items():
        pipes = [k.parse_launch(SLICE.format(fw=k.fw))
                 for _ in range(n_streams)]
        for p in pipes:
            p["src"].spec = k.core.TensorsSpec.from_shapes(shapes, np.uint8)
            p.start()
        assert pipes[0]["net"].pool_streams == n_streams
        assert not pipes[0].fused_segments  # share-model: never fused

        def produce(s):
            for i, x in enumerate(frames[s]):
                pipes[s]["src"].push_buffer(k.core.Buffer.of(x, pts=i))
            pipes[s]["src"].end_of_stream()

        threads = [threading.Thread(target=produce, args=(s,))
                   for s in range(n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for p in pipes:
            assert p.wait_eos(timeout=300)
        logits[pkg] = []
        for p in pipes:
            bufs = _pull_all(p["out"], n)
            assert [b.pts for b in bufs] == list(range(n))
            logits[pkg].append([np.asarray(b.tensors[0].np())
                                for b in bufs])
        st = pipes[0]["net"].pool.stats
        assert st.total_frame_num == n_streams * n
        for p in pipes:
            p.stop()
    for s in range(n_streams):
        for i in range(n):
            got, want = logits["port"][s][i], logits["jax"][s][i]
            assert got.shape == want.shape == (1, 5)
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


FILE_SLICE = ("appsrc name=src ! queue max-size-buffers=16 ! "
              "tensor_transform mode=arithmetic "
              "option=typecast:float32,add:-127.5,div:127.5 backend=pallas ! "
              "tensor_filter name=net framework={fw} model={model} "
              "share-model=true batch=4 batch-timeout-ms=50 "
              "batch-buckets=2,4 is-updatable=true ! "
              "appsink name=out max-buffers=16")
SMALL = dict(image_size=32, patch=8, dim=64, depth=2, mlp_dim=128,
             num_classes=5)


def jax_vit_f32(params, x):
    """The JAX files' ``apply``: the JAX package's ViT in f32, 2 heads."""
    return jvit.vit_apply(params, x, heads=2, dtype=jnp.float32)


def test_pooled_vit_from_weights_files_hot_swap_matches_jax_pool(tmp_path):
    """The slice from model files: each package's pool opens its own
    ``file://…@v0`` (one numpy tree per version, written once per
    package: the same pytree, each naming its own ``apply``), serves 3
    streams, hot-swaps to ``@v1`` through ``reload_model`` and serves
    again.  Per-frame logits equal to the JAX pool's within 1e-3 (f32),
    before and after the swap; the swap is recorded with its tag."""
    from nnstreamer_tpu.models import params_io as jio
    from nnstreamer_tpu_torch.models import params_io as tio

    n_streams, n = 3, 4
    shapes = [[1, 32, 32, 3]]
    files = {}
    for seed in (0, 1):
        tree = tvit.vit_tree(seed, **SMALL)
        meta = {"in_shapes": "[[1, 32, 32, 3]]", "in_dtypes": "float32"}
        files["jax", seed] = str(tmp_path / f"jax_v{seed}.safetensors")
        jio.save_safetensors(files["jax", seed], tree, metadata=dict(
            meta, apply="test_torch_serving:jax_vit_f32"))
        files["port", seed] = str(tmp_path / f"port_v{seed}.npz")
        tio.save_npz(files["port", seed], tree,
                     apply="nnstreamer_tpu_torch.models.vit:vit_tree_apply",
                     in_shapes=shapes, in_dtypes=np.float32,
                     apply_kwargs={"heads": 2, "dtype": "float32"})
    rng = np.random.default_rng(8)
    frames = [[rng.integers(0, 256, shapes[0], dtype=np.uint8)
               for _ in range(2 * n)] for _ in range(n_streams)]
    logits = {}
    for pkg, k in PKGS.items():
        pipes = [k.parse_launch(FILE_SLICE.format(
            fw=k.fw, model=f"file://{files[pkg, 0]}@v0"))
            for _ in range(n_streams)]
        for p in pipes:
            p["src"].spec = k.core.TensorsSpec.from_shapes(shapes, np.uint8)
            p.start()
        entry = pipes[0]["net"].pool
        outs = [[] for _ in pipes]
        for half in (0, 1):
            if half:
                res = entry.reload_model(f"file://{files[pkg, 1]}@v1")
                assert res["version"] == "v1"
            for s, p in enumerate(pipes):
                for i in range(half * n, (half + 1) * n):
                    p["src"].push_buffer(k.core.Buffer.of(frames[s][i],
                                                          pts=i))
            for s, p in enumerate(pipes):
                outs[s] += _pull_all(p["out"], n)
        lc = entry.lifecycle
        assert lc.swaps == 1 and lc.baseline.tag == "v1"
        assert any(ev["event"] == "swap" and ev["source"].endswith("@v1")
                   for ev in lc.history)
        for p in pipes:
            p.stop()
        logits[pkg] = [[np.asarray(b.tensors[0].np()) for b in bufs]
                       for bufs in outs]
        for bufs in outs:
            assert [b.pts for b in bufs] == list(range(2 * n))
    for s in range(n_streams):
        for i in range(2 * n):
            got, want = logits["port"][s][i], logits["jax"][s][i]
            assert got.shape == want.shape == (1, 5)
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_filter_parses_every_serving_property_and_arms_admission():
    """Every serving property of the JAX package's ``tensor_filter``
    parses in the port's launch grammar; ``slo-ms`` arms the pool's
    admission controller (EDF windows), ``priority``/``deadline-ms``/
    ``queue-limit`` become the stream's policy."""
    desc = ("appsrc name=src ! queue ! tensor_filter name=net "
            "framework=torch-cuda model=_t_torch_serving batch=4 "
            "batch-timeout-ms=5 batch-buckets=2,4 share-model=true "
            "priority=high deadline-ms=10 slo-ms=500 queue-limit=6 "
            "stat-sample-interval-ms=0 invoke-dynamic=false "
            "shared-tensor-filter-key= ! appsink name=out")
    p = truntime.parse_launch(desc, device="cpu")
    net = p["net"]
    assert (net.batch, net.batch_timeout_ms, net.batch_buckets,
            net.share_model, net.priority, net.deadline_ms, net.slo_ms,
            net.queue_limit, net.stat_sample_interval_ms,
            net.invoke_dynamic) == (4, 5, "2,4", True, "high", 10, 500, 6,
                                    0, False)
    p["src"].spec = tcore.TensorsSpec.parse("4", "float32")
    with p:
        entry = net.pool
        assert entry.admission is not None and entry.batcher.edf
        assert entry.buckets == (2, 4) and entry.sample_interval == 0
        pol = entry._policies[id(net)]
        assert (pol.priority, pol.deadline_s, pol.queue_limit) == \
            (0, 0.01, 6)
        for i in range(5):
            p["src"].push_buffer(_frame(PKGS["port"], 7, i))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=30)
        assert entry.admission.snapshot()["submitted"]["high"] == 5
    _check_stream(_pull_all(p["out"], 5), 7)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_invoke_dynamic_reshapes_per_buffer(pkg):
    """invoke-dynamic: the filter re-specializes to each buffer's schema
    and emits a flexible stream."""
    k = PKGS[pkg]
    p = k.parse_launch("appsrc name=src ! tensor_filter name=net "
                       f"framework={k.fw} model=_t_torch_serving "
                       "invoke-dynamic=true ! appsink name=out")
    p["src"].spec = k.core.TensorsSpec.parse("4", "float32")
    xs = [np.arange(4, dtype=np.float32), np.arange(6, dtype=np.float32),
          np.arange(6, dtype=np.float32) + 1]
    with p:
        for i, x in enumerate(xs):
            p["src"].push_buffer(k.core.Buffer.of(x, pts=i))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=60)
    outs = _pull_all(p["out"], 3)
    for x, b in zip(xs, outs):
        assert b.format.name == "FLEXIBLE"
        np.testing.assert_array_equal(np.asarray(b.tensors[0].np()),
                                      x * 2.0 + 1.0)
    assert p["net"].in_spec.tensors[0].shape == (6,)


# -- admission's ingress anchor ----------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ingress_stamp_gated_on_active_controller(pkg):
    """``tests/test_chaos.py``'s case on both packages: the stamp waits
    for an armed controller, which the pool's attach under ``slo-ms``
    arms and the last stream's detach disarms."""
    k = PKGS[pkg]
    assert not k.admission.ACTIVE
    p0, src0, _, sink0 = _pipeline(k, "nostamp", batch=4, timeout_ms=2.0)
    with p0:
        src0.push_buffer(_frame(k, 0, 0))
        out = sink0.pull(timeout=10)
        assert out is not None
        assert not k.admission.ACTIVE          # no slo-ms: never armed
    p, src, flt, sink = _pipeline(k, "stamp", batch=4, timeout_ms=2.0,
                                  slo_ms=100.0)
    seen = []
    orig = k.serving.PoolEntry.submit

    def spy(self, owner, buf):
        seen.append(buf.meta.get(k.admission.INGRESS_TS_META))
        return orig(self, owner, buf)

    k.serving.PoolEntry.submit = spy
    try:
        p.start()
        try:
            assert k.admission.ACTIVE           # armed by the pool attach
            t0 = time.monotonic()
            src.push_buffer(_frame(k, 0, 0))
            assert sink.pull(timeout=10) is not None
        finally:
            p.stop()
    finally:
        k.serving.PoolEntry.submit = orig
    assert not k.admission.ACTIVE               # disarmed with the last stream
    assert len(seen) == 1 and seen[0] is not None and seen[0] >= t0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_stall_behind_upstream_queue_reaches_the_p99(pkg):
    """The pool is held back (its submit waits on a gate) while 32 frames
    pile up in the upstream ``queue``; after 0.3 s it is let go.  Every
    frame's ``enq`` is its ingress stamp, so every latency includes the
    stall, and the p99 crosses the ramp (SLO 100 ms) at the first
    recompute, observation 16, in both packages; later frames are shed."""
    k = PKGS[pkg]
    stall, n = 0.3, 32
    gate = threading.Event()
    pool_submit = k.serving.PoolEntry.submit
    submit_from = k.serving.SharedBatcher.submit_from
    observe = k.admission.AdmissionController.observe
    enqs, crossed = [], []

    def held(self, owner, buf):
        gate.wait(10)
        return pool_submit(self, owner, buf)

    def recording(self, stream, item, deadline_s=0.0, enq=None):
        enqs.append((item.meta.get(k.admission.INGRESS_TS_META), enq))
        return submit_from(self, stream, item, deadline_s=deadline_s,
                           enq=enq)

    def watched(self, lat_s):
        observe(self, lat_s)
        if self.at_risk and not crossed:
            crossed.append((len(self._lat), self.p99_s))

    k.serving.PoolEntry.submit = held
    k.serving.SharedBatcher.submit_from = recording
    k.admission.AdmissionController.observe = watched
    p, src, flt, sink = _pipeline(k, "stall", batch=4, timeout_ms=2.0,
                                  slo_ms=100.0)
    try:
        p.start()
        try:
            t0 = time.monotonic()
            for i in range(n):
                src.push_buffer(_frame(k, 0, i))
            time.sleep(stall)
            released = time.monotonic()
            gate.set()
            got = []
            while (b := sink.pull(timeout=2.0)) is not None:
                got.append(b)
            adm = flt.pool.admission
            shed = adm.snapshot()["shed"]["normal"]
        finally:
            p.stop()
    finally:
        k.serving.PoolEntry.submit = pool_submit
        k.serving.SharedBatcher.submit_from = submit_from
        k.admission.AdmissionController.observe = observe
    assert len(enqs) >= 16 and len(got) == len(enqs)
    for stamp, enq in enqs:
        assert stamp is not None and enq == stamp      # ingress, not submit
        assert t0 <= stamp <= released - stall + 0.25
    assert crossed and crossed[0][0] == 16, crossed
    assert crossed[0][1] >= stall
    assert shed > 0 and len(got) + shed == n
