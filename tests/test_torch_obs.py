"""The observability tests of ``tests/test_obs.py`` through both packages.

Every test runs twice (``pkg``): ``jax`` — the JAX package, as the
original test runs it; ``port`` — ``nnstreamer_tpu_torch`` on the CPU with
the same numpy frames and a ``torch-cuda`` model of the same function.
Covered: the registry (concurrent counters, kind conflicts, the
Prometheus exposition golden byte for byte, label escaping, the -1
sentinels left out, pipelines registered while playing, element stats in
the snapshot and the exposition), the HTTP endpoint (``/metrics``,
``/json``, a fresh listener after close), the latency tracer (residencies
summing to the end-to-end latency, batched park/dispatch/demux marks,
1-in-N sampling, a tee fan-out closing once, no per-buffer state while
detached, the Chrome trace nesting and saving), ``InvokeStats`` (one
consistent snapshot, the latency-report threshold) and the log module
(idempotent configure, JSON lines).  The port alone: ``/snapshot`` and
``/healthz`` over HTTP, the snapshot's tables, the trace context blobs
and their clock math, and the kill switch read from the port's own key.
The nns-top tests of ``tests/test_obs.py`` run in
``tests/test_torch_top.py``.
"""

import json
import logging
import os
import subprocess
import sys
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import nnstreamer_tpu.elements.basic as jbasic
import nnstreamer_tpu.elements.filter as jfilter
import nnstreamer_tpu.filters.jax_xla as jxla
import nnstreamer_tpu.obs as jobs
import nnstreamer_tpu.obs.metrics as jmetrics
import nnstreamer_tpu.obs.tracectx as jctx
import nnstreamer_tpu.runtime as jruntime
import nnstreamer_tpu.utils.log as jlog
import nnstreamer_tpu.utils.stats as jstats
import nnstreamer_tpu_torch.elements.basic as tbasic
import nnstreamer_tpu_torch.elements.filter as tfilter
import nnstreamer_tpu_torch.filters as tfilters
import nnstreamer_tpu_torch.obs as tobs
import nnstreamer_tpu_torch.obs.metrics as tmetrics
import nnstreamer_tpu_torch.obs.tracectx as tctx
import nnstreamer_tpu_torch.runtime as truntime
import nnstreamer_tpu_torch.utils.log as tlog
import nnstreamer_tpu_torch.utils.stats as tstats
from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import TensorsSpec as JSpec
from nnstreamer_tpu_torch.core import Buffer as TBuffer
from nnstreamer_tpu_torch.core import TensorsSpec as TSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4,)

PKGS = {
    "jax": SimpleNamespace(
        Buffer=JBuffer, TensorsSpec=JSpec, basic=jbasic,
        TensorFilter=jfilter.TensorFilter, obs=jobs, metrics=jmetrics,
        Pipeline=lambda name: jruntime.Pipeline(name=name),
        parse_launch=jruntime.parse_launch, log=jlog, stats=jstats,
        framework="jax-xla", register=jxla.register_model,
        unregister=jxla.unregister_model, logger="nnstreamer_tpu",
        json_env="NNS_TPU_LOG_JSON"),
    "port": SimpleNamespace(
        Buffer=TBuffer, TensorsSpec=TSpec, basic=tbasic,
        TensorFilter=tfilter.TensorFilter, obs=tobs, metrics=tmetrics,
        Pipeline=lambda name: truntime.Pipeline(name=name, device="cpu"),
        parse_launch=lambda d: truntime.parse_launch(d, device="cpu"),
        log=tlog, stats=tstats, framework="torch-cuda",
        register=tfilters.register_model,
        unregister=tfilters.unregister_model,
        logger="nnstreamer_tpu_torch", json_env="NNS_TPU_TORCH_LOG_JSON"),
}


@pytest.fixture(params=list(PKGS))
def P(request):
    pkg = PKGS[request.param]
    pkg.register("_t_obs", lambda x: x * 2.0 + 1.0,
                 in_shapes=[SHAPE], in_dtypes=np.float32)
    yield pkg
    pkg.unregister("_t_obs")
    pkg.obs.hooks.detach()


def _pipeline(P, batch=1, name="obs", timeout_ms=5.0, n=64):
    spec = P.TensorsSpec.from_shapes([SHAPE], np.float32)
    p = P.Pipeline(name)
    src = P.basic.AppSrc(name="src", spec=spec, max_buffers=n + 4)
    q = P.basic.Queue(name="q", max_size_buffers=n + 4)
    flt = P.TensorFilter(name="net", framework=P.framework, model="_t_obs",
                         batch=batch, batch_timeout_ms=timeout_ms)
    sink = P.basic.AppSink(name="out", max_buffers=n + 4)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    return p, src, flt, sink


def _run(P, p, src, sink, n=16):
    outs = []
    for i in range(n):
        src.push_buffer(P.Buffer.of(
            np.full(SHAPE, float(i), np.float32), pts=i))
    for _ in range(n):
        b = sink.pull(timeout=10)
        assert b is not None, f"stalled after {len(outs)}"
        outs.append(b)
    src.end_of_stream()
    assert p.wait_eos(timeout=10)
    return outs


# -- registry: instruments ---------------------------------------------------


def test_counter_concurrent_producers_exact_total(P):
    reg = P.metrics.MetricsRegistry()
    fam = reg.counter("t_total", "test", labelnames=("worker",))
    shared = fam.labels(worker="all")

    def bump():
        own = fam.labels(worker="all")
        for _ in range(5000):
            own.inc()

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert shared.value == 8 * 5000


def test_counter_rejects_negative_and_kind_conflicts(P):
    reg = P.metrics.MetricsRegistry()
    c = reg.counter("t_c", "c").labels()
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        reg.gauge("t_c", "now a gauge?")
    g = reg.gauge("t_g", "g").labels()
    g.set(5)
    g.dec(2)
    assert g.value == 3
    h = reg.histogram("t_h", "h", buckets=(1.0,))
    with pytest.raises(ValueError):
        h.labels().inc()
    with pytest.raises(ValueError):
        reg.histogram("t_h", "h", buckets=(2.0,))
    assert reg.histogram("t_h", "h", buckets=(1.0,)) is h


GOLDEN = (
    "# HELP nns_t_depth queue depth\n"
    "# TYPE nns_t_depth gauge\n"
    "nns_t_depth 2.5\n"
    "# HELP nns_t_frames_total frames seen\n"
    "# TYPE nns_t_frames_total counter\n"
    'nns_t_frames_total{element="net",pipeline="p0"} 3\n'
    'nns_t_frames_total{element="net",pipeline="p1"} 1\n'
    "# HELP nns_t_lat_s latency\n"
    "# TYPE nns_t_lat_s histogram\n"
    'nns_t_lat_s_bucket{le="0.1"} 1\n'
    'nns_t_lat_s_bucket{le="1"} 2\n'
    'nns_t_lat_s_bucket{le="+Inf"} 3\n'
    "nns_t_lat_s_sum 99.55\n"
    "nns_t_lat_s_count 3\n")


def _golden_registry(metrics):
    reg = metrics.MetricsRegistry()
    c = reg.counter("nns_t_frames_total", "frames seen",
                    labelnames=("pipeline", "element"))
    c.labels(pipeline="p0", element="net").inc(3)
    c.labels(pipeline="p1", element="net").inc()
    reg.gauge("nns_t_depth", "queue depth").labels().set(2.5)
    h = reg.histogram("nns_t_lat_s", "latency", buckets=(0.1, 1.0))
    h.labels().observe(0.05)
    h.labels().observe(0.5)
    h.labels().observe(99.0)
    return reg


def test_exposition_format_golden(P):
    """Prometheus text format 0.0.4, byte-exact for a fixed registry."""
    assert _golden_registry(P.metrics).exposition() == GOLDEN


def test_exposition_byte_equal_across_packages():
    assert _golden_registry(tmetrics).exposition() == \
        _golden_registry(jmetrics).exposition()


def test_label_escaping(P):
    reg = P.metrics.MetricsRegistry()
    reg.counter("t_esc", "", labelnames=("k",)).labels(k='a"b\\c\nd').inc()
    line = [ln for ln in reg.exposition().splitlines()
            if ln.startswith("t_esc{")][0]
    assert line == 't_esc{k="a\\"b\\\\c\\nd"} 1'


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99, 1.0])
def test_bucket_quantile_same_in_both(q):
    bounds = (.001, .0025, .005, .01, .025, float("inf"))
    dist = [3, 0, 7, 12, 1, 0]
    assert tmetrics.bucket_quantile(bounds, dist, q) == \
        jmetrics.bucket_quantile(bounds, dist, q)


# -- registry: pipeline collection ------------------------------------------


def test_exposition_omits_unknown_sentinels(P):
    p, src, flt, sink = _pipeline(P, name="obs_sentinel")
    p.start()
    try:
        expo = P.obs.REGISTRY.exposition()
        assert ('nns_filter_invokes_total{element="net",'
                'pipeline="obs_sentinel"} 0') in expo
        for absent in ("nns_filter_latency_us",
                       "nns_filter_throughput_milli_fps",
                       "nns_filter_dispatch_milli_fps"):
            assert f'{absent}{{element="net",pipeline="obs_sentinel"' \
                not in expo
    finally:
        p.stop()


def test_pipeline_registered_while_playing_only(P):
    p, src, flt, sink = _pipeline(P, name="obs_reg")
    p.start()
    try:
        names = [t["pipeline"] for t in P.obs.REGISTRY.snapshot()["pipelines"]]
        assert "obs_reg" in names
    finally:
        p.stop()
    names = [t["pipeline"] for t in P.obs.REGISTRY.snapshot()["pipelines"]]
    assert "obs_reg" not in names


def test_snapshot_and_exposition_carry_element_stats(P):
    p, src, flt, sink = _pipeline(P, batch=4, name="obs_stats")
    p.start()
    try:
        _run(P, p, src, sink, n=16)
        snap = P.obs.REGISTRY.snapshot()
        table = [t for t in snap["pipelines"]
                 if t["pipeline"] == "obs_stats"][0]
        rows = {r["element"]: r for r in table["elements"]}
        assert rows["src"]["stats"]["buffers_out"] == 16
        assert rows["net"]["stats"]["buffers_in"] == 16
        assert "queue" in rows["q"]
        f = rows["net"]["filter"]
        assert f["frames"] == 16 and f["invokes"] <= 16
        assert f["batcher"]["max_batch"] == 4
        assert f["model"] == "_t_obs"
        expo = P.obs.REGISTRY.exposition()
        assert ('nns_element_buffers_out_total{element="src",'
                'pipeline="obs_stats"} 16') in expo
        assert "nns_filter_invokes_total" in expo
        assert "nns_batcher_flushes_total" in expo
    finally:
        p.stop()


def test_port_snapshot_tables():
    """The port's snapshot keeps the JAX package's keys for every table
    it has, the ``mesh`` table included; the XLA compile table is absent,
    not stubbed (the port compiles no XLA programs)."""
    snap = tobs.REGISTRY.snapshot()
    jsnap = jobs.REGISTRY.snapshot()
    assert snap["version"] == jsnap["version"]
    assert set(snap) == {"version", "time", "host", "pipelines", "pools",
                         "models", "links", "transfers", "device_memory",
                         "executables", "mesh", "stages", "tenants",
                         "forecasts", "control", "profile", "metrics"}
    assert set(snap) <= set(jsnap)
    assert set(jsnap) - set(snap) == {"compiles"}
    for table in ("forecasts", "control", "profile"):
        assert set(snap[table]) == set(jsnap[table]), table
    json.dumps(snap)


def test_serve_after_close_starts_fresh_listener(P):
    reg = P.metrics.MetricsRegistry()
    s1 = reg.serve(port=0)
    p1 = s1.port
    s1.close()
    s2 = reg.serve(port=0)
    try:
        assert s2 is not s1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{s2.port}/metrics", timeout=5) as r:
            r.read()
    finally:
        s2.close()
    assert p1


def test_metrics_http_endpoint(P):
    reg = P.metrics.MetricsRegistry()
    reg.counter("t_http_total", "h").labels().inc(7)
    srv = reg.serve(port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            text = r.read().decode()
        assert "t_http_total 7" in text
        with urllib.request.urlopen(base + "/json", timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert doc["metrics"]["t_http_total"]["samples"][0]["value"] == 7
    finally:
        srv.close()


def test_port_http_snapshot_healthz_and_404():
    reg = tmetrics.MetricsRegistry(collect_devices=True)
    reg.gauge("t_snap", "s").labels().set(3)
    srv = reg.serve(port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/snapshot", timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert doc["metrics"]["t_snap"]["samples"][0]["value"] == 3
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            health = json.loads(r.read().decode())
        assert health["status"] == "ok"
        assert health["device_memory"] == []  # no card in use
        # the active layer's summaries, present with nothing running
        assert health["alerts"]["firing"] == 0
        assert health["prof"]["running"] is False
        assert {"capacity", "control"} <= set(health)
        with urllib.request.urlopen(base + "/prof", timeout=5) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nothing-here", timeout=5)
    finally:
        srv.close()


# -- tracer ------------------------------------------------------------------


def test_tracer_residency_sums_to_e2e(P):
    p, src, flt, sink = _pipeline(P, name="obs_tr")
    with P.obs.LatencyTracer(sample_every=1) as tr:
        p.start()
        try:
            _run(P, p, src, sink, n=8)
        finally:
            p.stop()
    recs = tr.records()
    assert len(recs) == 8
    for r in recs:
        assert r["e2e_s"] > 0
        assert set(r["residency_s"]) == {"src", "q", "net", "out"}
        assert sum(r["residency_s"].values()) == pytest.approx(
            r["e2e_s"], abs=1e-6)
    assert sorted(r["pts"] for r in recs) == list(range(8))


def test_tracer_batched_park_dispatch_demux_marks(P):
    p, src, flt, sink = _pipeline(P, batch=4, name="obs_trb")
    with P.obs.LatencyTracer(sample_every=1) as tr:
        p.start()
        try:
            _run(P, p, src, sink, n=8)
        finally:
            p.stop()
    r = tr.records()[0]
    phases = [ph for _, name, ph in r["marks"] if name == "net"]
    for needed in ("chain-in", "park", "dispatch", "demux"):
        assert needed in phases, r["marks"]
    t = {ph: ts for ts, name, ph in r["marks"] if name == "net"}
    assert t["park"] <= t["dispatch"] <= t["demux"]


def test_tracer_sampling_one_in_n(P):
    p, src, flt, sink = _pipeline(P, name="obs_trs")
    with P.obs.LatencyTracer(sample_every=4) as tr:
        p.start()
        try:
            _run(P, p, src, sink, n=16)
        finally:
            p.stop()
    assert len(tr.records()) == 4
    s = tr.summary()
    assert s["count"] == 4 and s["e2e_p99_s"] >= s["e2e_p50_s"]


def test_tracer_tee_fanout_finalizes_once(P):
    p = P.parse_launch(
        "appsrc name=src caps=other/tensors,format=static,num_tensors=1,"
        "dimensions=4,types=float32,framerate=0/1 ! tee name=t "
        "t. ! queue name=q1 ! appsink name=s1 max_buffers=32 "
        "t. ! queue name=q2 ! appsink name=s2 max_buffers=32")
    with P.obs.LatencyTracer(sample_every=1) as tr:
        p.start()
        try:
            for i in range(6):
                p["src"].push_buffer(P.Buffer.of(
                    np.full(SHAPE, float(i), np.float32), pts=i))
            for name in ("s1", "s2"):
                for _ in range(6):
                    assert p[name].pull(timeout=10) is not None
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=10)
        finally:
            p.stop()
    assert len(tr.records()) == 6


def test_hooks_are_noops_when_disabled(P):
    """No tracer attached: buffers carry no trace state and a detached
    tracer receives no callbacks (the hook is one global read)."""

    class Spy(P.obs.LatencyTracer):
        calls = 0

        def source_created(self, element, buf):
            Spy.calls += 1
            super().source_created(element, buf)

    spy = Spy()
    spy.install()
    spy.uninstall()
    assert P.obs.hooks.tracer is None
    p, src, flt, sink = _pipeline(P, batch=4, name="obs_off")
    p.start()
    try:
        outs = _run(P, p, src, sink, n=8)
    finally:
        p.stop()
    assert Spy.calls == 0
    for b in outs:
        assert P.obs.TRACE_META_KEY not in b.meta
        assert b.meta == {}


def test_chrome_trace_loads_and_nests(P):
    p, src, flt, sink = _pipeline(P, batch=4, name="obs_ct")
    with P.obs.LatencyTracer(sample_every=1) as tr:
        p.start()
        try:
            _run(P, p, src, sink, n=8)
        finally:
            p.stop()
    doc = json.loads(json.dumps(tr.chrome_trace()))
    events = doc["traceEvents"]
    assert events and all(e["ph"] in ("X", "i") for e in events)
    frames = {e["tid"]: e for e in events if e["cat"] == "frame"}
    assert len(frames) == 8
    eps = 1e-3
    for e in events:
        f = frames[e["tid"]]
        assert e["ts"] >= f["ts"] - eps
        assert e["ts"] + e.get("dur", 0) <= f["ts"] + f["dur"] + eps
    names = {e["name"] for e in events if e["cat"] == "element"}
    assert {"src", "q", "net", "out"} <= names
    sub = {e["name"] for e in events if e["cat"] == "phase"}
    assert "q:queued" in sub and "net:parked" in sub


def test_chrome_trace_saves(P, tmp_path):
    tr = P.obs.LatencyTracer()
    path = tmp_path / "trace.json"
    tr.save_chrome_trace(str(path))
    assert json.loads(path.read_text()) == {"traceEvents": [],
                                            "displayTimeUnit": "ms"}


def test_tracer_sampled_invoke_split_marks(P):
    """latency=1: every dispatch is a sample, so every traced frame gets
    the host-prep / device / host-drain marks in order."""
    spec = P.TensorsSpec.from_shapes([SHAPE], np.float32)
    p = P.Pipeline("obs_split")
    src = P.basic.AppSrc(name="src", spec=spec, max_buffers=16)
    flt = P.TensorFilter(name="net", framework=P.framework, model="_t_obs",
                         latency=1)
    sink = P.basic.AppSink(name="out", max_buffers=16)
    p.add(src, flt, sink).link(src, flt, sink)
    with P.obs.LatencyTracer(sample_every=1) as tr:
        p.start()
        try:
            _run(P, p, src, sink, n=4)
        finally:
            p.stop()
    for r in tr.records():
        t = {ph: ts for ts, name, ph in r["marks"] if name == "net"}
        assert t["invoke-prep"] <= t["invoke-device"] \
            <= t["invoke-drain"] <= t["invoke-done"]
    assert flt.invoke_stats.phase_samples == 4


def test_port_tracer_closes_deferred_record_at_fence():
    """A record a sink deferred to its fence closes at the fence with a
    ``device-done`` mark as its end; the partition stays exact, and the
    window's device time is read from the events it carries."""
    tr = tobs.LatencyTracer()

    class _El:
        def __init__(self, name, sink=False):
            self.name = name
            self.sinkpads = [object()]
            self.srcpads = [] if sink else [object()]

    class _Ev:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, other):
            return other.ms - self.ms

    src, net, out = _El("src"), _El("net"), _El("out", sink=True)
    buf = TBuffer.of(np.zeros(4, np.float32), pts=3)
    tr.source_created(src, buf)
    tr.pre_chain(net, buf)
    tr.device_window([buf], _Ev(1.0), _Ev(3.5))
    tr.post_chain(net, buf)
    tr.pre_chain(out, buf)
    buf.meta[tobs.TRACE_META_KEY]["fence_pending"] = True
    tr.post_chain(out, buf)
    assert tr.records() == []  # deferred
    tr.sink_fenced(out, 0.001, (buf.meta[tobs.TRACE_META_KEY],))
    (rec,) = tr.records()
    assert rec["marks"][-1][2] == "device-done"
    assert rec["end"] == rec["marks"][-1][0]
    assert sum(rec["residency_s"].values()) == pytest.approx(rec["e2e_s"])
    assert rec["device_window_s"] == pytest.approx(2.5e-3)
    assert tr.summary()["sink_fence_waits"] == 1


# -- trace contexts ----------------------------------------------------------


@pytest.mark.parametrize("t", [(1.0, 5.25, 5.5, 2.0), (10.0, 3.0, 3.1, 10.4),
                               (0.0, 0.0, 0.0, 0.0)])
def test_offset_and_delay_matches_jax(t):
    from nnstreamer_tpu.edge.ntputil import offset_and_delay
    from nnstreamer_tpu_torch.edge import ntputil

    assert ntputil.offset_and_delay(*t) == offset_and_delay(*t)


def test_trace_context_round_trip_same_as_jax():
    """Request → server plant → reply → absorb: the same remote entry in
    both packages for the same timestamps, and the mapped server window
    nests inside [t1, t4]."""
    out = {}
    for name, ctx in (("jax", jctx), ("port", tctx)):
        tr = {"id": "ab-1", "frame": 1, "marks": [(1.0, "src", "source")]}
        req = ctx.decode_ctx(ctx.encode_ctx(ctx.request_ctx(tr, 2.0)))
        meta = {}
        req["t2"] = 7.0
        ctx.plant_server_trace(meta, req, "qsrc")
        srv = meta[ctx.TRACE_META_KEY]
        srv["marks"] = [(7.0, "qsrc", "source"), (7.2, "net", "chain-in")]
        rep = ctx.reply_ctx(srv)
        rep["t3"], rep["host"] = 7.5, "h:1"
        off = ctx.absorb_reply(tr, rep, 3.0, "qcli")
        out[name] = (off, tr["remote"])
        r = tr["remote"][0]
        assert r["t_out"] <= r["t2"] <= r["t3"] <= r["t_in"]
    assert out["jax"] == out["port"]


def test_trailer_round_trip_same_as_jax():
    ctx = {"v": 1, "id": "x-2", "frame": 2}
    blob = tctx.append_trailer(b"payload", ctx)
    assert blob == jctx.append_trailer(b"payload", ctx)
    assert tctx.split_trailer(blob) == (b"payload", ctx)
    assert tctx.split_trailer(b"no trailer") == (b"no trailer", None)


# -- satellites: InvokeStats -------------------------------------------------


def test_invoke_stats_snapshot_consistent_under_concurrent_records(P):
    st = P.stats.InvokeStats()
    stop = threading.Event()

    def producer():
        while not stop.is_set():
            st.record(0.001, frames=3, streams=2)

    threads = [threading.Thread(target=producer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(300):
            s = st.snapshot()
            if s["invokes"] == 0:
                continue
            assert s["frames"] == 3 * s["invokes"]
            assert s["avg_batch_occupancy"] == pytest.approx(
                s["frames"] / s["invokes"])
            assert s["avg_stream_occupancy"] == pytest.approx(2.0)
    finally:
        stop.set()
        for t in threads:
            t.join()
    s = st.snapshot()
    assert set(s) == {"invokes", "frames", "latency_us",
                      "throughput_milli_fps", "dispatch_milli_fps",
                      "avg_batch_occupancy", "avg_stream_occupancy",
                      "attached_streams", "host_prep_us", "device_us",
                      "host_drain_us", "phase"}


def test_latency_to_report_thresholds(P):
    st = P.stats.InvokeStats()
    assert st.latency_to_report() is None
    st.record(0.001)
    first = st.latency_to_report()
    assert first == int(1000 * 1.05)
    assert st.latency_to_report() is None
    for _ in range(st._recent.maxlen):
        st.record(0.002)
    assert st.latency_to_report() == int(2000 * 1.05)


# -- satellites: log ---------------------------------------------------------


def test_log_configure_is_idempotent(P):
    logger = logging.getLogger(P.logger)

    def ours():
        return [h for h in logger.handlers
                if getattr(h, P.log._HANDLER_TAG, False)]

    assert len(ours()) == 1
    P.log.configure()
    P.log.configure()
    assert len(ours()) == 1
    P.log.configure(force=True)
    assert len(ours()) == 1


def test_log_json_lines_output(P, monkeypatch):
    monkeypatch.setenv(P.json_env, "1")
    P.log.configure(force=True)
    logger = logging.getLogger(P.logger)
    ours = [h for h in logger.handlers
            if getattr(h, P.log._HANDLER_TAG, False)]
    assert isinstance(ours[0].formatter, P.log.JsonLineFormatter)
    rec = logger.makeRecord(P.logger, logging.WARNING, "f", 1,
                            "boom %d", (7,), None)
    rec.element = "net"
    doc = json.loads(ours[0].formatter.format(rec))
    assert doc["msg"] == "boom 7"
    assert doc["element"] == "net"
    assert doc["level"] == "WARNING" and "ts" in doc
    monkeypatch.delenv(P.json_env)
    P.log.configure(force=True)


# -- the kill switch ---------------------------------------------------------


def _child(code: str, **env):
    e = {k: v for k, v in os.environ.items()
         if not k.startswith("NNS_TPU_")}
    e.update(env)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, env=e)
    assert out.returncode == 0, out.stderr
    return out.stdout


_DISABLE_PROBE = """
import sys
sys.modules['jax'] = None
import numpy as np
from nnstreamer_tpu_torch.obs import hooks, transfer, LatencyTracer
from nnstreamer_tpu_torch.utils.stats import DispatchSampler, InvokeStats
from nnstreamer_tpu_torch.obs.flightrec import FLIGHT
tr = LatencyTracer().install()
s = DispatchSampler(InvokeStats())
sample, _ = s.begin(0.0, force=True)
s.end([], 0.0, sample)
print(hooks.DISABLED, hooks.tracer is None, transfer.ACTIVE, sample,
      s._last_out is None, FLIGHT.enabled)
"""


def test_port_kill_switch_reads_its_own_key():
    """``NNS_TPU_TORCH_OBS_DISABLE=1`` turns the port's obs layer off: no
    tracer attaches, no dispatch is a blocking sample (not even with
    latency=1) and none keeps an output alive, the ledger and the flight
    recorder are inert.  The JAX package's key leaves the port on."""
    assert _child(_DISABLE_PROBE, NNS_TPU_TORCH_OBS_DISABLE="1").split() \
        == ["True", "True", "False", "False", "True", "False"]
    assert _child(_DISABLE_PROBE, NNS_TPU_OBS_DISABLE="1").split() \
        == ["False", "False", "True", "True", "True", "True"]
