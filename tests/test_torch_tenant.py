"""Tenant and stage attribution, the phase split, LATENCY reports and the
flight recorder's dump on an element error, through the port.

- ``TenantStats``: the exact integer-nanosecond split, no drift over
  thousands of ragged windows, unsampled windows counting frames only,
  dollars derived at scrape time from ``NNS_TPU_TORCH_CHIP_HOUR_USD``,
  SLO attainment and sheds — and the same rows as the JAX package's
  store over the same windows.
- End to end: three tenants sharing one port pool (``tenant=``), the
  device-time split exactly equal to the pool's total, the ``tenants``
  table and ``nns_tenant_*`` families; the scrape/record race.
- ``tensor_if offload=`` records each routing decision; the ratio is the
  one the seeded predicate gives, in both packages.
- ``tests/test_costattr.py``'s phase partition through the port's filter
  and pool (``latency=1``), with the registry's ``nns_invoke_*``
  histograms; the Chrome trace's invoke sub-phases.
- ``tests/test_latency_report.py``'s threshold through the element:
  ``latency-report=true`` posts LATENCY bus messages, in both packages.
- The flight recorder dumps on an element error: a trace and a snapshot
  that load, with ``nns_element_errors_total`` counted.
"""

import json
import random
import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu.obs.tenantstat as jten
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.elements.basic import AppSink, AppSrc, Queue
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.filters import register_model, unregister_model
from nnstreamer_tpu_torch.obs import LatencyTracer
from nnstreamer_tpu_torch.obs.flightrec import FLIGHT
from nnstreamer_tpu_torch.obs.metrics import REGISTRY
from nnstreamer_tpu_torch.obs.stagestat import STAGE_STATS
from nnstreamer_tpu_torch.obs.tenantstat import (DEFAULT_TENANT,
                                                 TENANT_STATS, TenantStats)
from nnstreamer_tpu_torch.runtime import Pipeline, parse_launch
from nnstreamer_tpu_torch.runtime.events import MessageKind
from nnstreamer_tpu_torch.runtime.serving import MODEL_POOL

SHAPE = (4,)
SPEC = TensorsSpec.from_shapes([SHAPE], np.float32)
STORES = {"jax": jten.TenantStats, "port": TenantStats}


@pytest.fixture(scope="module", autouse=True)
def _model():
    register_model("_t_tenant", lambda x: x * 2.0 + 1.0,
                   in_shapes=[SHAPE], in_dtypes=np.float32)
    yield
    unregister_model("_t_tenant")


@pytest.fixture(autouse=True)
def _clean():
    TENANT_STATS.reset()
    yield
    TENANT_STATS.reset()
    MODEL_POOL.clear()


@pytest.fixture(params=list(STORES))
def Store(request):
    return STORES[request.param]


# -- the exact split -------------------------------------------------------------


def test_record_window_splits_device_ns_exactly(Store):
    st = Store()
    st.record_window("pl", {"a": 3, "b": 2, "c": 1}, device_ns=1000003)
    tenant_ns, pool_ns = st.exactness("pl")
    assert tenant_ns == pool_ns == 1000003
    rows = {r["tenant"]: r for r in st.snapshot()}
    assert rows["b"]["device_seconds"] == pytest.approx(
        (1000003 * 2 // 6) / 1e9)
    assert rows["c"]["device_seconds"] == pytest.approx(
        (1000003 // 6) / 1e9)
    assert rows["a"]["frames"] == 3 and rows["c"]["frames"] == 1


def test_exactness_never_drifts_over_many_windows(Store):
    st = Store()
    rng = random.Random(19)
    total = 0
    for _ in range(2000):
        frames = {t: rng.randint(0, 7)
                  for t in ("alpha", "beta", "gamma", "default")}
        if not any(frames.values()):
            frames["alpha"] = 1
        ns = rng.choice((0, 1, 997, 65537, 1000000007))
        st.record_window("pl", frames, device_ns=ns)
        total += ns
    tenant_ns, pool_ns = st.exactness("pl")
    assert tenant_ns == pool_ns == total


def test_unsampled_windows_count_frames_not_time(Store):
    st = Store()
    st.record_window("pl", {"a": 4}, device_ns=None)
    st.record_window("pl", {"": 2}, device_ns=None)
    assert st.exactness("pl") == (0, 0)
    rows = {r["tenant"]: r for r in st.snapshot()}
    assert rows["a"]["frames"] == 4
    assert rows[DEFAULT_TENANT]["frames"] == 2
    assert rows["a"]["device_seconds"] == 0.0
    st.record_window("pl", {"z": 0}, device_ns=123)
    assert "z" not in {r["tenant"] for r in st.snapshot()}


def test_port_dollars_derive_at_scrape_time(monkeypatch):
    """The port prices nothing unless its key sets a price; history
    re-prices on the next scrape."""
    st = TenantStats()
    st.record_window("pl", {"a": 1}, device_ns=3_600_000_000_000)
    monkeypatch.delenv("NNS_TPU_TORCH_CHIP_HOUR_USD", raising=False)
    monkeypatch.setenv("NNS_TPU_CHIP_HOUR_USD", "2.5")  # the JAX key
    (row,) = st.snapshot()
    assert row["dollars"] == 0.0
    monkeypatch.setenv("NNS_TPU_TORCH_CHIP_HOUR_USD", "2.5")
    (row,) = st.snapshot()
    assert row["dollars"] == pytest.approx(2.5)
    monkeypatch.setenv("NNS_TPU_TORCH_CHIP_HOUR_USD", "10")
    (row,) = st.snapshot()
    assert row["dollars"] == pytest.approx(10.0)
    monkeypatch.setenv("NNS_TPU_TORCH_CHIP_HOUR_USD", "not-a-price")
    (row,) = st.snapshot()
    assert row["dollars"] == 0.0


def test_slo_attainment_and_shed_accounting(Store):
    st = Store()
    for lat in (0.01, 0.02, 0.5):
        st.record_latency("pl", "a", lat, slo_s=0.1)
    st.record_shed("pl", "a", "slo", frames=3)
    st.record_shed("pl", "a", "queue-full")
    (row,) = st.snapshot()
    assert row["slo_attainment"] == pytest.approx(2.0 / 3.0)
    assert row["slo_frames"] == 3
    assert row["shed"] == {"slo": 3, "queue-full": 1}
    st.record_window("pl", {"quiet": 1})
    quiet = [r for r in st.snapshot() if r["tenant"] == "quiet"][0]
    assert quiet["slo_attainment"] is None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_same_attribution_as_jax(seed, monkeypatch):
    monkeypatch.setenv("NNS_TPU_TORCH_CHIP_HOUR_USD", "1.5")
    monkeypatch.setenv("NNS_TPU_CHIP_HOUR_USD", "1.5")
    rng = random.Random(seed)
    a, b = jten.TenantStats(), TenantStats()
    for _ in range(500):
        frames = {t: rng.randint(0, 9) for t in ("a", "b", "", "c")}
        ns = rng.choice((None, 0, 7, 1_000_003, 2 ** 33 + 1))
        lat, slo = rng.random() * 0.2, 0.1
        for st in (a, b):
            st.record_window("pool", frames, device_ns=ns)
            st.record_latency("pool", "a", lat, slo)
            if ns is None:
                st.record_shed("pool", "b", "slo")
    assert b.snapshot() == a.snapshot()
    assert b.exactness("pool") == a.exactness("pool")


# -- end to end through the port's pool ---------------------------------------


def _tenant_pipe(tag, tenant, batch=8):
    p = Pipeline(name=f"ten_{tag}", device="cpu")
    src = AppSrc(name="src", spec=SPEC, max_buffers=128)
    q = Queue(name="q", max_size_buffers=128)
    flt = TensorFilter(name="net", framework="torch-cuda",
                       model="_t_tenant", batch=batch,
                       batch_timeout_ms=5.0, batch_buckets=str(batch),
                       share_model=True, tenant=tenant,
                       stat_sample_interval_ms=0.0)
    sink = AppSink(name="sink", max_buffers=128)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    return p, src, flt, sink


def test_pipeline_attribution_exact():
    n = 48
    pipes = [_tenant_pipe("a", "alpha"), _tenant_pipe("b", "beta"),
             _tenant_pipe("d", "")]
    for p, *_ in pipes:
        p.start()
    label = pipes[0][2].pool.label()

    def produce(src):
        for i in range(n):
            src.push_buffer(Buffer.of(
                np.full(SHAPE, float(i), np.float32), pts=i))
        src.end_of_stream()

    threads = [threading.Thread(target=produce, args=(src,))
               for _p, src, _f, _s in pipes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for p, *_ in pipes:
        assert p.wait_eos(timeout=30)
    try:
        tenant_ns, pool_ns = TENANT_STATS.exactness(label)
        assert tenant_ns == pool_ns
        assert pool_ns > 0
        rows = {r["tenant"]: r
                for r in TENANT_STATS.snapshot() if r["pool"] == label}
        assert set(rows) == {"alpha", "beta", DEFAULT_TENANT}
        assert all(r["frames"] == n for r in rows.values())
        # the pool's device phase total is what the tenants split
        ph = pipes[0][2].pool.stats.snapshot()["phase"]
        assert pool_ns / 1e9 == pytest.approx(ph["device_s"], abs=1e-6)
        snap = REGISTRY.snapshot()
        tab = [r for r in snap["tenants"] if r["pool"] == label]
        assert [r["tenant"] for r in tab] \
            == sorted(r["tenant"] for r in tab)
        fams = snap["metrics"]
        seconds = {s["labels"]["tenant"]: s["value"] for s in
                   fams["nns_tenant_device_seconds_total"]["samples"]
                   if s["labels"]["pool"] == label}
        assert sum(seconds.values()) == pytest.approx(pool_ns / 1e9)
        frames = {s["labels"]["tenant"]: s["value"] for s in
                  fams["nns_tenant_frames_total"]["samples"]
                  if s["labels"]["pool"] == label}
        assert frames == {"alpha": n, "beta": n, DEFAULT_TENANT: n}
        assert "nns_tenant_dollars_total" in fams
        json.dumps(snap["tenants"])
    finally:
        for p, *_ in pipes:
            p.stop()


def test_tenant_register_scrape_race():
    stop = threading.Event()
    errors = []

    def scraper():
        try:
            while not stop.is_set():
                json.dumps(REGISTRY.snapshot()["tenants"])
        except Exception as e:  # noqa: BLE001 - the assert is the point
            errors.append(e)

    def dispatcher():
        try:
            i = 0
            while not stop.is_set():
                TENANT_STATS.record_window(
                    "race-pool", {"a": 1 + i % 3, "b": 2}, device_ns=997)
                i += 1
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def admitter():
        try:
            while not stop.is_set():
                TENANT_STATS.record_latency("race-pool", "a", 0.01, 0.1)
                TENANT_STATS.record_shed("race-pool", "b", "slo")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=f)
               for f in (scraper, dispatcher, admitter)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert errors == []
    tenant_ns, pool_ns = TENANT_STATS.exactness("race-pool")
    assert tenant_ns == pool_ns > 0


# -- tensor_if offload -----------------------------------------------------------

OFFLOAD = (
    "appsrc name=src caps=other/tensors,format=static,num_tensors=1,"
    "dimensions=4,types=float32,framerate=0/1 ! tensor_if name=gate "
    "compared-value=A_VALUE compared-value-option=0:0 supplied-value=2 "
    "operator=GE then=PASSTHROUGH else=SKIP offload={off} ! "
    "appsink name=out")


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("off", ["then", "else"])
def test_tensor_if_offload_ratio(pkg, off):
    if pkg == "jax":
        from nnstreamer_tpu.core import Buffer as B
        from nnstreamer_tpu.obs.stagestat import STAGE_STATS as store
        from nnstreamer_tpu.runtime import parse_launch as parse
        p = parse(OFFLOAD.format(off=off))
    else:
        B, store = Buffer, STAGE_STATS
        p = parse_launch(OFFLOAD.format(off=off), device="cpu")
    p.name = f"offload_{pkg}_{off}"
    vals = [0, 1, 2, 3, 4, 1, 2, 0]  # 4 of 8 take the then branch
    with p:
        for i, v in enumerate(vals):
            p["src"].push_buffer(B.of(np.full(SHAPE, float(v), np.float32),
                                      pts=i))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=10)
    row = store.get(p.name, "gate")
    assert row["kind"] == "offload"
    assert row["offloaded"] + row["kept"] == 8
    assert row["offloaded"] == 4
    assert row["ratio"] == 0.5
    if pkg == "port":
        fam = REGISTRY.snapshot()["metrics"]["nns_cascade_offload_ratio"]
        assert any(s["labels"] == {"pipeline": p.name, "element": "gate"}
                   and s["value"] == 0.5 for s in fam["samples"])


def test_stage_store_same_as_jax():
    from nnstreamer_tpu.obs.stagestat import StageStats as JStage

    from nnstreamer_tpu_torch.obs.stagestat import StageStats

    a, b = JStage(), StageStats()
    for st in (a, b):
        st.record_handoff("p", "cls", "0-3", "4-7", 2, 4096)
        st.record_handoff("p", "cls", "0-3", "4-5", 1, 2048)
        st.record_emit("p", "cls", 2)
        for v in (True, False, True):
            st.record_offload("p", "gate", v, "cls")
    assert b.snapshot() == a.snapshot()


# -- the phase partition (tests/test_costattr.py) -----------------------------


def _cost_pipeline(batch=1, name="cost", **kw):
    p = Pipeline(name=name, device="cpu")
    src = AppSrc(name="src", spec=SPEC, max_buffers=256)
    q = Queue(name="q", max_size_buffers=256)
    flt = TensorFilter(name=kw.pop("el_name", "net"), framework="torch-cuda",
                       model="_t_tenant", batch=batch, batch_timeout_ms=2.0,
                       batch_buckets=str(batch) if batch > 1 else "",
                       latency=1, **kw)
    sink = AppSink(name="out", max_buffers=256)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    return p, src, flt, sink


def _run(src, sink, n):
    for i in range(n):
        src.push_buffer(Buffer.of(
            np.full(SHAPE, float(i % 5), np.float32), pts=i))
    for _ in range(n):
        assert sink.pull(timeout=30) is not None


def test_phase_split_sums_to_invoke_latency_single_frame():
    p, src, flt, sink = _cost_pipeline(name="cost_phase1")
    with p:
        _run(src, sink, 20)
        s = flt.invoke_stats.snapshot()
    ph = s["phase"]
    assert ph["samples"] == s["invokes"] == 20
    assert s["host_prep_us"] >= 0 and s["host_drain_us"] >= 0
    lat_total_s = flt.invoke_stats.total_invoke_latency_us / 1e6
    prep_dev = ph["host_prep_s"] + ph["device_s"]
    assert prep_dev == pytest.approx(lat_total_s, rel=0.05, abs=2e-5)
    assert prep_dev + ph["host_drain_s"] >= lat_total_s


def _hist_sum(fams, name, **match):
    return sum(s["value"] for s in fams[name]["samples"]
               if s.get("name", "").endswith("_sum")
               and all(s["labels"].get(k) == v for k, v in match.items()))


def test_phase_split_batched_and_registry_histograms():
    p, src, flt, sink = _cost_pipeline(batch=4, name="cost_phaseb",
                                       el_name="tnet_cost_b")
    with p:
        _run(src, sink, 32)
        s = flt.invoke_stats.snapshot()
        fams = REGISTRY.collect()
    ph = s["phase"]
    assert ph["samples"] == s["invokes"] > 0
    assert s["frames"] == 32
    dev = _hist_sum(fams, "nns_invoke_device_seconds",
                    source="tnet_cost_b", kind="element", bucket="4")
    prep = _hist_sum(fams, "nns_invoke_host_seconds",
                     source="tnet_cost_b", phase="prep")
    drain = _hist_sum(fams, "nns_invoke_host_seconds",
                      source="tnet_cost_b", phase="drain")
    assert dev == pytest.approx(ph["device_s"], rel=1e-6)
    assert prep == pytest.approx(ph["host_prep_s"], rel=1e-6)
    assert drain == pytest.approx(ph["host_drain_s"], rel=1e-6)


def test_pool_dispatch_phase_split_and_registry():
    p1, s1, f1, k1 = _cost_pipeline(batch=4, name="cost_poolA",
                                    share_model=True)
    p2, s2, f2, k2 = _cost_pipeline(batch=4, name="cost_poolB",
                                    share_model=True)
    p1.start()
    p2.start()
    before = _hist_sum(REGISTRY.collect(), "nns_invoke_device_seconds",
                       kind="pool", source=f1.pool.label())
    try:
        for i in range(8):
            s1.push_buffer(Buffer.of(np.zeros(SHAPE, np.float32), pts=i))
            s2.push_buffer(Buffer.of(np.zeros(SHAPE, np.float32), pts=i))
        got = 0
        deadline = time.monotonic() + 20
        while got < 16 and time.monotonic() < deadline:
            if k1.pull(timeout=0.2) is not None:
                got += 1
            if k2.pull(timeout=0.2) is not None:
                got += 1
        assert got == 16
        entry = f1.pool
        stats = entry.stats.snapshot()
        assert stats["phase"]["samples"] > 0
        fams = REGISTRY.collect()
        dev = _hist_sum(fams, "nns_invoke_device_seconds", kind="pool",
                        source=entry.label()) - before
        assert dev == pytest.approx(stats["phase"]["device_s"], rel=1e-6)
    finally:
        p1.stop()
        p2.stop()


def test_chrome_trace_carries_invoke_subphases():
    p, src, flt, sink = _cost_pipeline(batch=4, name="cost_trace")
    with LatencyTracer(sample_every=1) as tr:
        with p:
            _run(src, sink, 16)
    ct = tr.chrome_trace()
    names = {e["name"] for e in ct["traceEvents"]}
    assert {"net:host-prep", "net:device", "net:host-drain"} <= names
    by_tid = {}
    for e in ct["traceEvents"]:
        by_tid.setdefault(e["tid"], []).append(e)
    checked = 0
    for evs in by_tid.values():
        frames = [e for e in evs if e["cat"] == "frame"]
        phases = [e for e in evs if e["cat"] == "phase"
                  and e["name"].startswith("net:")]
        if not frames or not phases:
            continue
        f = frames[0]
        for e in phases:
            assert e["ts"] >= f["ts"] - 1
            assert e["ts"] + e["dur"] <= f["ts"] + f["dur"] + 1
        checked += 1
    assert checked > 0


# -- latency-report= (tests/test_latency_report.py) ---------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_latency_report_posts_latency_messages(pkg):
    if pkg == "jax":
        from nnstreamer_tpu.core import Buffer as B
        from nnstreamer_tpu.filters.jax_xla import register_model as reg
        from nnstreamer_tpu.runtime import parse_launch as parse
        from nnstreamer_tpu.runtime.events import MessageKind as MK
        fw, kw = "jax-xla", {}
    else:
        B, reg, parse, MK = Buffer, register_model, parse_launch, MessageKind
        fw, kw = "torch-cuda", {"device": "cpu"}
    reg("_t_latrep", lambda x: x + 1.0, in_shapes=[SHAPE],
        in_dtypes=np.float32)
    p = parse("appsrc name=src caps=other/tensors,format=static,"
              "num_tensors=1,dimensions=4,types=float32,framerate=0/1 ! "
              f"tensor_filter name=net framework={fw} model=_t_latrep "
              "latency=1 latency-report=true ! appsink name=out", **kw)
    msgs = []
    p.bus.add_watch(lambda m: msgs.append(m)
                    if m.kind == MK.LATENCY else None)
    with p:
        for i in range(6):
            p["src"].push_buffer(B.of(np.zeros(SHAPE, np.float32), pts=i))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=30)
    assert msgs, "no LATENCY message"
    assert all(m.source == "net" and m.data["latency_us"] >= 0
               for m in msgs)
    # thresholded: not one message a dispatch unless the mean keeps moving
    assert len(msgs) <= 6
    assert p["net"].invoke_stats.phase_samples == 6


# -- the flight recorder on an element error -----------------------------------


def test_flightrec_element_error_trigger(tmp_path):
    from nnstreamer_tpu_torch.runtime.element import TransformElement

    FLIGHT.clear()
    FLIGHT.arm(str(tmp_path))
    FLIGHT.min_dump_interval_s = 0.0

    class Boom(TransformElement):
        FACTORY = "t_boom"

        def transform(self, buf):
            raise RuntimeError("injected chain failure")

    p = Pipeline(name="tx_err", device="cpu")
    src = AppSrc(name="src", spec=SPEC, max_buffers=8)
    boom = Boom(name="boom")
    sink = AppSink(name="out", max_buffers=8)
    p.add(src, boom, sink).link(src, boom, sink)
    try:
        p.start()
        try:
            src.push_buffer(Buffer.of(np.ones(SHAPE, np.float32), pts=0))
            t0 = time.monotonic()
            while not FLIGHT.dumps and time.monotonic() - t0 < 10.0:
                time.sleep(0.01)
        finally:
            p.stop()
        assert FLIGHT.triggers.get("element-error", 0) >= 1
        assert FLIGHT.dumps
        trace_path, snap_path = FLIGHT.dumps[0]
        assert "flightrec-001-element-error-trace.json" in trace_path
        with open(trace_path) as f:
            trace = json.load(f)
        with open(snap_path) as f:
            snap = json.load(f)
        assert any(e["name"] == "error:boom" for e in trace["traceEvents"])
        errs = snap["snapshot"]["metrics"]["nns_element_errors_total"]
        assert any(s["labels"] == {"pipeline": "tx_err", "element": "boom"}
                   for s in errs["samples"])
        kinds = {e["kind"] for e in FLIGHT.events()}
        assert "error" in kinds and "trigger" in kinds
    finally:
        FLIGHT.disarm()
        FLIGHT.min_dump_interval_s = 5.0
        FLIGHT.clear()
