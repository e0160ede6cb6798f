"""The port's micro-batching and admission control against the JAX package.

- ``parse_buckets`` / ``pick_bucket``: equal to the JAX package's on a
  table of specs, errors included;
- ``MicroBatcher``: the ordering and flush-reason scenarios of
  ``tests/test_batching.py`` on the port's batcher, and the
  ``tensor_filter batch=`` pipeline scenarios through the port's
  ``parse_launch``/elements on the CPU (values exact: the model is
  ``x * 2 + 1`` in f32);
- ``AdmissionController``: one seeded latency sequence through both
  packages gives the same ``p99_s``, ``shed_probability`` and ``admit``
  verdicts, exactly (both draw from ``random.Random(0)``).

Every pipeline a test starts is stopped and its threads joined.
"""

import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu.runtime import admission as jadm
from nnstreamer_tpu.runtime import batching as jbat
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.elements.basic import AppSink, AppSrc, Queue
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.filters import register_model, unregister_model
from nnstreamer_tpu_torch.runtime import Pipeline, StreamError
from nnstreamer_tpu_torch.runtime import admission as tadm
from nnstreamer_tpu_torch.runtime import batching as tbat
from nnstreamer_tpu_torch.runtime.batching import MicroBatcher
from nnstreamer_tpu_torch.utils.stats import InvokeStats

SHAPE = (4,)


@pytest.fixture(scope="module", autouse=True)
def _model():
    register_model("_t_torch_batching", lambda x: x * 2.0 + 1.0,
                   in_shapes=[SHAPE], in_dtypes=np.float32)
    yield
    unregister_model("_t_torch_batching")


def _frame(i: int) -> Buffer:
    return Buffer.of(np.full(SHAPE, float(i), np.float32), pts=i)


def _pipeline(batch, timeout_ms=1000.0, buckets="", n_bufs=64):
    spec = TensorsSpec.from_shapes([SHAPE], np.float32)
    p = Pipeline(device="cpu")
    src = AppSrc(name="src", spec=spec, max_buffers=n_bufs + 4)
    q = Queue(name="q", max_size_buffers=n_bufs + 4)
    flt = TensorFilter(name="net", framework="torch-cuda",
                       model="_t_torch_batching", batch=batch,
                       batch_timeout_ms=timeout_ms, batch_buckets=buckets)
    sink = AppSink(name="out", max_buffers=n_bufs + 4)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    return p, src, flt, sink


def _pull_all(sink, n, timeout=10.0):
    out = []
    for _ in range(n):
        b = sink.pull(timeout=timeout)
        assert b is not None, f"stream stalled after {len(out)}/{n} buffers"
        out.append(b)
    return out


def _run(p, src, n):
    with p:
        for i in range(n):
            src.push_buffer(_frame(i))
        src.end_of_stream()
        assert p.wait_eos(timeout=30)


# -- bucket helpers: equal to the JAX package --------------------------------

BUCKET_SPECS = [("", 8), ("", 6), ("", 1), ("", 64), ("2, 5", 8),
                ("8,16,32,64", 64), ("4", 4), ("16", 8), ("0", 8),
                ("3,,1", 4), ("", 0)]


@pytest.mark.parametrize("spec,max_batch", BUCKET_SPECS)
def test_parse_buckets_equals_jax(spec, max_batch):
    try:
        want = jbat.parse_buckets(spec, max_batch)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tbat.parse_buckets(spec, max_batch)
        assert str(got.value) == str(e)
        return
    assert tbat.parse_buckets(spec, max_batch) == want


@pytest.mark.parametrize("buckets", [(1, 2, 4, 8), (8, 16, 32, 64), (4,)])
def test_pick_bucket_equals_jax(buckets):
    for n in range(1, buckets[-1] + 2):
        try:
            want = jbat.pick_bucket(n, buckets)
        except ValueError:
            with pytest.raises(ValueError):
                tbat.pick_bucket(n, buckets)
            continue
        assert tbat.pick_bucket(n, buckets) == want


# -- MicroBatcher unit -------------------------------------------------------


def test_microbatcher_concurrent_producers_preserve_order():
    flushed = []
    mb = MicroBatcher(max_batch=4, timeout_s=0.005, flush_fn=flushed.extend)
    mb.start()
    n_producers, per = 4, 50

    def produce(pid):
        for i in range(per):
            mb.submit((pid, i))

    threads = [threading.Thread(target=produce, args=(pid,))
               for pid in range(n_producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    mb.flush()
    mb.stop()
    assert len(flushed) == n_producers * per
    assert len(set(flushed)) == n_producers * per  # no dup, no loss
    for pid in range(n_producers):
        seq = [i for q, i in flushed if q == pid]
        assert seq == sorted(seq), f"producer {pid} reordered"


def test_microbatcher_deadline_flush():
    flushed = []
    mb = MicroBatcher(max_batch=16, timeout_s=0.02, flush_fn=flushed.extend,
                      name="t")
    mb.start()
    assert mb._thread.name == "nns:batch:t"
    mb.submit("a")
    mb.submit("b")
    deadline = time.monotonic() + 5.0
    while len(flushed) < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    mb.stop()
    assert flushed == ["a", "b"]
    assert mb.flushes_deadline >= 1 and mb.flushes_full == 0


def test_microbatcher_full_and_forced_flush_reasons():
    windows = []
    mb = MicroBatcher(max_batch=3, timeout_s=1000.0, flush_fn=windows.append)
    for i in range(7):
        mb.submit(i)  # no timer: only full windows move
    assert windows == [[0, 1, 2], [3, 4, 5]] and mb.flushes_full == 2
    assert mb.pending == 1
    mb.flush()
    assert windows[-1] == [6] and mb.flushes_forced == 1


def test_microbatcher_timer_error_routed():
    errors = []

    def boom(items):
        raise RuntimeError("flush failed")

    mb = MicroBatcher(max_batch=16, timeout_s=0.01, flush_fn=boom,
                      error_fn=errors.append)
    mb.start()
    mb.submit("x")
    deadline = time.monotonic() + 5.0
    while not errors and time.monotonic() < deadline:
        time.sleep(0.005)
    mb.stop()
    assert errors and "flush failed" in str(errors[0])


def test_adaptive_default_off_and_settle_capped_by_deadline():
    mb = MicroBatcher(max_batch=4, timeout_s=0.0005, flush_fn=lambda b: None)
    assert mb.adaptive is False
    assert mb.settle_s == 0.0005  # never later than the deadline
    assert MicroBatcher.ADAPTIVE_SETTLE_S == \
        jbat.MicroBatcher.ADAPTIVE_SETTLE_S


# -- tensor_filter batch= through the port ------------------------------------


def test_batched_pipeline_order_pts_and_values():
    n = 25
    p, src, flt, sink = _pipeline(batch=4, n_bufs=n)
    _run(p, src, n)
    outs = _pull_all(sink, n)
    for i, b in enumerate(outs):
        assert b.pts == i
        np.testing.assert_array_equal(b.tensors[0].np(),
                                      np.full(SHAPE, i * 2.0 + 1.0))
    st = flt.invoke_stats
    assert st.total_frame_num == n and st.total_invoke_num < n


def test_partial_batch_flushes_on_eos_no_frame_loss():
    n = 10
    p, src, flt, sink = _pipeline(batch=4, timeout_ms=60_000.0, n_bufs=n)
    _run(p, src, n)
    st = flt.invoke_stats
    assert st.total_frame_num == n
    assert st.total_invoke_num == 3  # 4 + 4 + 2(EOS partial)
    assert st.avg_batch_occupancy == pytest.approx(n / 3)
    assert [b.pts for b in _pull_all(sink, n, timeout=1.0)] == list(range(n))


def test_bucket_cache_hits_and_misses():
    n = 10  # windows 4, 4, 2 -> buckets {4, 2}: 2 misses, 1 hit
    p, src, flt, sink = _pipeline(batch=4, timeout_ms=60_000.0, n_bufs=n)
    with p:
        for i in range(n):
            src.push_buffer(_frame(i))
        src.end_of_stream()
        assert p.wait_eos(timeout=30)
        sp = flt.subplugin
        assert (sp.batch_cache_misses, sp.batch_cache_hits) == (2, 1)
        assert sp.cache_snapshot()["by_bucket"] == {
            "2": {"hits": 0, "misses": 1}, "4": {"hits": 1, "misses": 1}}
        assert sp.hot_buckets() == (2, 4)
    _pull_all(sink, n, timeout=1.0)


def test_explicit_buckets_pad_the_tail():
    n = 5  # windows 4 + 1(EOS); buckets "4" -> the tail pads up to 4
    p, src, flt, sink = _pipeline(batch=4, timeout_ms=60_000.0,
                                  buckets="4", n_bufs=n)
    with p:
        for i in range(n):
            src.push_buffer(_frame(i))
        src.end_of_stream()
        assert p.wait_eos(timeout=30)
        assert flt._buckets == (4,)
        assert flt.subplugin.batch_cache_misses == 1
        assert flt.subplugin.batch_cache_hits == 1
    outs = _pull_all(sink, n, timeout=1.0)
    assert [b.pts for b in outs] == list(range(n))
    np.testing.assert_array_equal(outs[-1].tensors[0].np(),
                                  np.full(SHAPE, 9.0))


def test_deadline_flush_in_pipeline():
    p, src, flt, sink = _pipeline(batch=8, timeout_ms=30.0, n_bufs=8)
    with p:
        for i in range(3):
            src.push_buffer(_frame(i))
        assert [b.pts for b in _pull_all(sink, 3)] == [0, 1, 2]
        src.end_of_stream()
        assert p.wait_eos(timeout=30)


def test_batch1_default_stays_single_buffer_path():
    n = 6
    p, src, flt, sink = _pipeline(batch=1, n_bufs=n)
    with p:
        assert flt._batcher is None  # no coalescer, no timer thread
        for i in range(n):
            src.push_buffer(_frame(i))
        src.end_of_stream()
        assert p.wait_eos(timeout=30)
        assert flt.invoke_stats.total_invoke_num == n
        assert flt.subplugin.batch_cache_misses == 0
    assert [b.pts for b in _pull_all(sink, n, timeout=1.0)] == list(range(n))


def test_batch_with_invoke_dynamic_rejected():
    p, src, flt, sink = _pipeline(batch=4)
    flt.invoke_dynamic = True
    with pytest.raises(ValueError, match="invoke-dynamic"):
        p.start()
    p.stop()


def test_batch_restart_recreates_batcher():
    p, src, flt, sink = _pipeline(batch=4, n_bufs=8)
    for i in range(2):
        with p:
            assert flt._batcher is not None
            src.push_buffer(_frame(i))
            src.end_of_stream()
            assert p.wait_eos(timeout=30)
        assert flt._batcher is None  # stop() tears the coalescer down
    assert [b.pts for b in _pull_all(sink, 2)] == [0, 1]


def test_no_subplugin_reports_before_throttle():
    flt = TensorFilter(name="net", framework="torch-cuda",
                       model="_t_torch_batching")
    flt._throttle_interval = 10.0
    flt._last_invoke_ts = time.monotonic()
    with pytest.raises(StreamError, match="no sub-plugin"):
        flt.chain(flt.sinkpad, _frame(0))


def test_qos_throttle_drops_frames():
    from nnstreamer_tpu_torch.runtime import Event

    n = 6
    p, src, flt, sink = _pipeline(batch=1, n_bufs=n)
    with p:
        flt.handle_upstream_event(flt.srcpad, Event.qos_throttle(0.01))
        assert flt._throttle_interval == pytest.approx(100.0)
        assert src._throttle_rate == 0.01  # the event went upstream too
        src._throttle_rate = None  # ... where it would pace the source
        for i in range(n):
            src.push_buffer(_frame(i))
        src.end_of_stream()
        assert p.wait_eos(timeout=30)
    assert [b.pts for b in _pull_all(sink, 1)] == [0]  # one per 100 s
    assert sink.pull(timeout=0.1) is None


def test_invoke_stats_stream_occupancy():
    st = InvokeStats()
    st.count(frames=8, streams=4)
    st.record(0.001, frames=2, streams=2)
    assert st.total_stream_num == 6
    assert st.avg_stream_occupancy == pytest.approx(3.0)
    assert st.avg_batch_occupancy == pytest.approx(5.0)
    assert InvokeStats().avg_stream_occupancy == 0.0


# -- admission control: equal to the JAX package ----------------------------


def test_parse_priority_equals_jax():
    for v in ("high", "normal", "LOW", "", None, 0, 1, 2):
        assert tadm.parse_priority(v) == jadm.parse_priority(v)
    for v in ("urgent", 3):
        with pytest.raises(ValueError):
            tadm.parse_priority(v)
        with pytest.raises(ValueError):
            jadm.parse_priority(v)


def test_admission_controller_equals_jax_on_a_seeded_sequence():
    """Latencies that climb through the shed ramp and fall back: after
    every observation the two controllers agree on p99, probability and
    at-risk, and on every admit verdict for each priority."""
    rng = np.random.default_rng(7)
    ramp = np.concatenate([np.linspace(0.002, 0.012, 400),
                           np.linspace(0.012, 0.003, 200)])
    lats = ramp * rng.uniform(0.8, 1.2, ramp.size)
    j = jadm.AdmissionController(0.010)
    t = tadm.AdmissionController(0.010)
    prios = rng.integers(0, 3, lats.size)
    for lat, prio in zip(lats, prios):
        j.observe(float(lat))
        t.observe(float(lat))
        assert t.p99_s == j.p99_s
        assert t.shed_probability == j.shed_probability
        assert t.at_risk == j.at_risk
        assert t.admit(int(prio)) == j.admit(int(prio))
    assert t.snapshot() == j.snapshot()
    assert t.total_shed == j.total_shed > 0
    assert t.risk_episodes == j.risk_episodes >= 1
