"""The port's transfer ledger, device memory and flight recorder.

The ledger's arithmetic is held against the JAX package's ledger for the
same record calls (rows, bytes, seconds buckets, totals).  The port's
seams are held on the CPU with a fake device tag: ``CARD_TYPES`` widened
to ``cpu``, so a CPU tensor counts as one on a card.  The scenarios of
``tests/test_transfer.py`` then run through the port: uploads and drains
byte-exact with their labels, the window stacked on the host and copied
once, the weights' placement, the kill switch, residency tagging, the
tracer's crossings per frame and its xfer spans, the packed decoder
drain, ``image_labeling``'s one (index, score) pair, ``tensor_if``'s one
scalar verdict, and a CPU tensor crossing nothing without the fake tag.
Device memory: an empty table with no card in use, and the rows read
from ``torch.cuda.memory_stats``/``mem_get_info`` (stubbed here; the card
tests hold the real ones).  The flight recorder: the hard-shed trigger,
the pool's shed wiring, ``/dump``, the ring's bound and horizon.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import nnstreamer_tpu.obs.transfer as jxfer
from nnstreamer_tpu_torch.core import Buffer, Tensor, TensorsSpec
from nnstreamer_tpu_torch.decoders import drain_once
from nnstreamer_tpu_torch.elements.basic import AppSink, AppSrc, Queue
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.filters import register_model, unregister_model
from nnstreamer_tpu_torch.obs import REGISTRY, LatencyTracer, devicemem
from nnstreamer_tpu_torch.obs import hooks
from nnstreamer_tpu_torch.obs import transfer as xfer
from nnstreamer_tpu_torch.obs.flightrec import FLIGHT, FlightRecorder
from nnstreamer_tpu_torch.runtime import Pipeline, parse_launch

SHAPE = (4,)
FRAME_BYTES = 16  # 4 x float32


@pytest.fixture(scope="module", autouse=True)
def _model():
    register_model("_t_xfer", lambda x: x * 2.0 + 1.0,
                   in_shapes=[SHAPE], in_dtypes=np.float32)
    yield
    unregister_model("_t_xfer")


@pytest.fixture(autouse=True)
def _fresh_obs():
    xfer.set_enabled(True)
    xfer.LEDGER.clear()
    FLIGHT.clear()
    yield
    hooks.detach()
    xfer.set_enabled(True)
    xfer.LEDGER.clear()
    FLIGHT.disarm()
    FLIGHT.min_dump_interval_s = 5.0


@pytest.fixture
def fake_card(monkeypatch):
    """The CPU counts as a card: the seams record on CPU tensors."""
    monkeypatch.setattr(xfer, "CARD_TYPES", ("cuda", "cpu"))


def _pipeline(name, batch=1, n=32, model="_t_xfer", buckets=""):
    spec = TensorsSpec.from_shapes([SHAPE], np.float32)
    p = Pipeline(name=name, device="cpu")
    src = AppSrc(name="src", spec=spec, max_buffers=n + 4)
    q = Queue(name="q", max_size_buffers=n + 4)
    flt = TensorFilter(name="net", framework="torch-cuda", model=model,
                       batch=batch, batch_timeout_ms=5.0,
                       batch_buckets=buckets)
    sink = AppSink(name="out", max_buffers=n + 4)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    return p, src, flt, sink


def _run(p, src, sink, n=16, drain=True):
    outs = []
    for i in range(n):
        src.push_buffer(Buffer.of(
            np.full(SHAPE, float(i), np.float32), pts=i))
    for _ in range(n):
        b = sink.pull(timeout=10)
        assert b is not None, f"stalled after {len(outs)}"
        if drain:
            for t in b.tensors:
                t.np()
        outs.append(b)
    src.end_of_stream()
    assert p.wait_eos(timeout=10)
    return outs


# -- the ledger's arithmetic against the JAX ledger --------------------------

CALLS = [
    [("h2d", "input", 16, 0.0, "net", "p"),
     ("h2d", "input", 16, 2e-6, "net", "p"),
     ("d2h", "drain", 8, 3e-4, "dec", "p")],
    [("h2d", "weights", 4096, 0.02, "", ""),
     ("d2d", "handoff", 64, 0.0, "stage", "q"),
     ("d2h", "drain", 1, 1.0, "if", "q"),
     ("d2h", "drain", 1, 7.5, "if", "q")],
    [("h2d", "pad", 32, 1e-6, "pool", ""),
     ("h2d", "pad", 32, 2.5e-6, "pool", ""),
     ("h2d", "input", 10 ** 9, 0.25, "src", "big")],
]


@pytest.mark.parametrize("calls", CALLS)
def test_ledger_arithmetic_same_as_jax(calls):
    a, b = jxfer.TransferLedger(), xfer.TransferLedger()
    for direction, reason, nbytes, secs, source, pipe in calls:
        for led in (a, b):
            led.record(direction, reason, nbytes, secs, source=source,
                       pipeline=pipe)
    assert b.snapshot() == a.snapshot()
    for kw in ({}, {"direction": "h2d"}, {"reason": "drain"},
               {"pipeline": "p"}):
        assert b.totals(**kw) == a.totals(**kw)
    assert xfer.TRANSFER_SECONDS_BUCKETS == jxfer.TRANSFER_SECONDS_BUCKETS
    # the port's queue prefetch-host= adds one reason of its own
    assert (xfer.DIRECTIONS, xfer.REASONS) == (jxfer.DIRECTIONS,
                                               jxfer.REASONS + ("prefetch",))


def test_ledger_context_labels_and_trace_spans_same_as_jax():
    out = []
    for mod in (jxfer, xfer):
        led, tr = mod.TransferLedger(), {}
        prev = mod.push_context("pipe", "el", (tr,))
        try:
            led.record("d2h", "drain", 24, 0.5)
        finally:
            mod.pop_context(prev)
        (row,) = led.snapshot()
        (span,) = tr["xfers"]
        out.append((row["pipeline"], row["source"], span[1:]))
    assert out[0] == out[1] == ("pipe", "el",
                                (0.5, "el", "d2h", "drain", 24))


# -- the port's seams ----------------------------------------------------------


def test_cpu_tensor_crosses_nothing():
    """Without the fake tag a CPU tensor is not on a card: no row."""
    n = 4
    p, src, flt, sink = _pipeline("xt_cpu", n=n)
    p.start()
    try:
        _run(p, src, sink, n=n)
    finally:
        p.stop()
    assert xfer.LEDGER.snapshot() == []
    assert not xfer.on_card(torch.zeros(1))
    assert xfer.on_card(torch.device("cuda"))
    assert xfer.on_card("cuda:0") and not xfer.on_card("cpu")


def test_ledger_byte_exact_h2d_and_d2h(fake_card):
    n = 16
    p, src, flt, sink = _pipeline("xt_exact", n=n)
    p.start()
    try:
        _run(p, src, sink, n=n)
    finally:
        p.stop()
    assert xfer.LEDGER.totals(pipeline="xt_exact", direction="h2d",
                              reason="input") == (n, n * FRAME_BYTES)
    assert xfer.LEDGER.totals(direction="d2h", reason="drain") == \
        (n, n * FRAME_BYTES)
    rows = {(r["pipeline"], r["source"]): r
            for r in xfer.LEDGER.snapshot()
            if r["direction"] == "h2d" and r["reason"] == "input"}
    assert ("xt_exact", "net") in rows
    snap = REGISTRY.snapshot()
    fam = snap["metrics"]["nns_transfer_bytes_total"]
    exported = sum(s["value"] for s in fam["samples"]
                   if s["labels"]["pipeline"] == "xt_exact"
                   and s["labels"]["direction"] == "h2d")
    assert exported == n * FRAME_BYTES
    assert "nns_transfer_seconds" in snap["metrics"]
    assert 'nns_transfer_bytes_total{direction="h2d"' in \
        REGISTRY.exposition()


def test_ledger_batched_window_one_copy(fake_card):
    """The port stacks a window's host frames on the host and copies the
    stack once, pad rows included: one ``input`` crossing a window, of
    bucket x frame bytes (the JAX package counts each frame and the pad
    replays apart)."""
    n = 6  # batch=4, pinned bucket → one full window + one padded
    p, src, flt, sink = _pipeline("xt_batch", batch=4, n=n, buckets="4")
    p.start()
    try:
        _run(p, src, sink, n=n, drain=False)
    finally:
        p.stop()
    windows = flt.invoke_stats.total_invoke_num
    c, b = xfer.LEDGER.totals(pipeline="xt_batch", direction="h2d",
                              reason="input")
    # the probe window's fold check also runs its first and last frame
    # alone: two uploads more
    assert c == windows + 2
    assert b == windows * 4 * FRAME_BYTES + 2 * FRAME_BYTES


def test_ledger_weights_recorded(fake_card):
    w = np.ones((8,), np.float32)
    register_model("_t_xfer_w", lambda p, x: x * p["w"][0],
                   params={"w": w}, in_shapes=[SHAPE],
                   in_dtypes=np.float32)
    try:
        p, src, flt, sink = _pipeline("xt_w", model="_t_xfer_w", n=4)
        p.start()
        try:
            _run(p, src, sink, n=4, drain=False)
        finally:
            p.stop()
        assert xfer.LEDGER.totals(direction="h2d", reason="weights") == \
            (1, w.nbytes)
    finally:
        unregister_model("_t_xfer_w")


def test_ledger_disabled_records_nothing(fake_card):
    xfer.set_enabled(False)
    t = Tensor(np.ones(SHAPE, np.float32))
    t.torch(torch.device("cpu"))
    Tensor(torch.ones(SHAPE)).np()
    assert xfer.LEDGER.snapshot() == []


def test_buffer_residency_tagging(fake_card, monkeypatch):
    host = Buffer.of(np.ones(SHAPE, np.float32))
    assert host.residency == "host"
    dev = Buffer(tensors=[Tensor(torch.ones(SHAPE))])
    assert dev.residency == "device"
    mixed = Buffer(tensors=[Tensor(np.ones(SHAPE, np.float32)),
                            Tensor(torch.ones(SHAPE))])
    assert mixed.residency == "mixed"
    monkeypatch.setattr(xfer, "CARD_TYPES", ("cuda",))
    assert dev.residency == "host"  # a CPU tensor is not on a card


def test_tracer_crossings_per_frame_and_xfer_spans(fake_card):
    n = 8
    p, src, flt, sink = _pipeline("xt_trace", n=n)
    with LatencyTracer(sample_every=1) as tr:
        p.start()
        try:
            _run(p, src, sink, n=n, drain=False)
        finally:
            p.stop()
    s = tr.summary()
    assert s["count"] == n
    assert s["crossings_per_frame"] == pytest.approx(1.0)
    recs = tr.records()
    assert all(r["crossings"] == 1 for r in recs)
    assert any(r["xfers"] for r in recs)
    doc = tr.chrome_trace()
    names = {e["name"] for e in doc["traceEvents"] if e["cat"] == "xfer"}
    assert any(nm.startswith("net:h2d:input") for nm in names)
    assert any("residency host->device" in nm for nm in names)


def test_drain_once_is_one_crossing(fake_card):
    ts = [Tensor(torch.arange(6, dtype=torch.float32)),
          Tensor(torch.ones(3, dtype=torch.int32)),
          Tensor(np.zeros(2, np.uint8))]
    out = drain_once(ts)
    assert [a.dtype for a in out] == [np.float32, np.int32, np.uint8]
    assert xfer.LEDGER.totals(direction="d2h") == (1, 24 + 12)


def test_image_labeling_one_pair_a_frame(fake_card, tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("a\nb\nc\nd\n")
    p = parse_launch(
        "appsrc name=src caps=other/tensors,format=static,num_tensors=1,"
        "dimensions=4:1,types=float32,framerate=0/1 ! tensor_decoder "
        f"mode=image_labeling option1={labels} ! appsink name=out",
        device="cpu")
    with p:
        for i in range(3):
            x = torch.zeros(1, 4)
            x[0, i + 1] = 5.0
            p["src"].push_buffer(Buffer.of(x, pts=i))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=10)
    got = [p["out"].pull(timeout=1).meta["label"] for _ in range(3)]
    assert got == ["b", "c", "d"]
    assert xfer.LEDGER.totals(direction="d2h") == (3, 3 * 8)


def test_tensor_if_one_scalar_a_verdict(fake_card):
    p = parse_launch(
        "appsrc name=src caps=other/tensors,format=static,num_tensors=1,"
        "dimensions=4,types=float32,framerate=0/1 ! tensor_if name=tif "
        "compared-value=TENSOR_AVERAGE_VALUE compared-value-option=0 "
        "supplied-value=1 operator=GE then=PASSTHROUGH else=SKIP ! "
        "appsink name=out", device="cpu")
    with p:
        for i in range(4):
            p["src"].push_buffer(Buffer.of(torch.full((4,), float(i)),
                                           pts=i))
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=10)
    assert p["tif"].verdict_copies == 4
    # the average crosses as one float64 scalar a verdict
    assert xfer.LEDGER.totals(pipeline=p.name, direction="d2h") == (4, 32)


# -- device memory ------------------------------------------------------------


def test_device_memory_empty_without_a_card():
    assert devicemem.device_memory_table() == []
    assert devicemem.device_memory_summary() == []
    assert REGISTRY.snapshot()["device_memory"] == []


def test_device_memory_rows_from_memory_stats(monkeypatch):
    stats = {"allocated_bytes.all.current": 100,
             "allocated_bytes.all.peak": 200,
             "reserved_bytes.all.current": 300}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (1, 400))
    dev = torch.device("cuda", 0)
    rows = devicemem.device_memory_table(devices=[dev])
    assert rows == [{"device": "cuda:0", "in_use": 100, "peak": 200,
                     "reserved": 300, "limit": 400}]
    assert devicemem.device_memory_summary(devices=[dev]) == \
        [{"device": "cuda:0", "in_use": 100}]
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {})
    assert devicemem.device_memory_table(devices=[dev]) == []


def test_device_memory_gauges(monkeypatch):
    from nnstreamer_tpu_torch.obs import metrics

    monkeypatch.setattr(metrics, "_device_table", lambda: [
        {"device": "cuda:0", "in_use": 1, "peak": 2, "limit": 4,
         "reserved": 3}])
    fam = REGISTRY.snapshot()["metrics"]["nns_device_memory_bytes"]
    got = {s["labels"]["kind"]: s["value"] for s in fam["samples"]}
    assert got == {"in_use": 1, "peak": 2, "limit": 4, "reserved": 3}


def test_pool_weight_bytes_exported():
    w = np.ones((16,), np.float32)
    register_model("_t_xfer_pool", lambda p, x: x + p["w"][0],
                   params={"w": w}, in_shapes=[SHAPE],
                   in_dtypes=np.float32)
    try:
        spec = TensorsSpec.from_shapes([SHAPE], np.float32)
        p = Pipeline(name="xt_pool", device="cpu")
        src = AppSrc(name="src", spec=spec, max_buffers=8)
        flt = TensorFilter(name="net", framework="torch-cuda",
                           model="_t_xfer_pool", share_model=True)
        sink = AppSink(name="out", max_buffers=8)
        p.add(src, flt, sink).link(src, flt, sink)
        p.start()
        try:
            snap = REGISTRY.snapshot()
            pool = [r for r in snap["pools"]
                    if "_t_xfer_pool" in r["pool"]][0]
            assert pool["weights"] == {"bytes": w.nbytes,
                                       "placement": "host"}
            fam = snap["metrics"]["nns_model_weight_bytes"]
            assert any(s["value"] == w.nbytes for s in fam["samples"])
        finally:
            p.stop()
    finally:
        unregister_model("_t_xfer_pool")


# -- flight recorder ----------------------------------------------------------


def _wait_dumps(n=1, deadline_s=10.0):
    t0 = time.monotonic()
    while len(FLIGHT.dumps) < n and time.monotonic() - t0 < deadline_s:
        time.sleep(0.01)
    return FLIGHT.dumps


def _valid_dump(trace_path, snap_path):
    with open(trace_path) as f:
        trace = json.load(f)
    assert isinstance(trace["traceEvents"], list)
    with open(snap_path) as f:
        snap = json.load(f)
    assert snap["snapshot"]["version"] == 10
    return trace, snap


def test_flightrec_hard_shed_trigger(tmp_path):
    FLIGHT.arm(str(tmp_path))
    FLIGHT.min_dump_interval_s = 0.0
    FLIGHT.shed("torch-cuda:m", "low", "slo", total_shed=3, hard=False)
    assert FLIGHT.triggers.get("admission-hard-shed", 0) == 0
    FLIGHT.shed("torch-cuda:m", "low", "slo", total_shed=9, hard=True)
    assert FLIGHT.triggers.get("admission-hard-shed", 0) == 1
    assert _wait_dumps()
    trace, _ = _valid_dump(*FLIGHT.dumps[-1])
    shed_marks = [e for e in trace["traceEvents"]
                  if e["name"].startswith("shed")]
    assert shed_marks and shed_marks[-1]["args"]["total_shed"] == 9


def test_flightrec_warn_shed_wiring(tmp_path):
    from nnstreamer_tpu_torch.runtime.admission import (
        AdmissionController,
        StreamPolicy,
    )
    from nnstreamer_tpu_torch.runtime.serving import PoolEntry

    FLIGHT.arm(str(tmp_path))
    FLIGHT.min_dump_interval_s = 0.0

    class Owner:
        name = "own"

        def post_message(self, msg):
            self.last = msg

    entry = PoolEntry(("torch-cuda", "m", ""), object(), lambda sp: None)
    adm = AdmissionController(slo_s=0.001)
    for _ in range(64):
        adm.observe(1.0)
    assert adm.shed_probability >= 1.0
    entry.admission = adm
    owner = Owner()
    entry._warn_shed(owner, StreamPolicy(priority=2), adm, reason="slo")
    assert FLIGHT.triggers.get("admission-hard-shed", 0) >= 1
    assert owner.last.data["shed"] is True


def test_flightrec_dump_endpoint():
    from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    srv = reg.serve(port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/dump", timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert isinstance(doc["trace"]["traceEvents"], list)
        assert doc["snapshot"]["version"] == 10
        assert FLIGHT.triggers.get("endpoint", 0) >= 1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=5) as r:
            hz = json.loads(r.read().decode())
        assert "device_memory" in hz
    finally:
        srv.close()


def test_flightrec_rate_limit_and_horizon():
    rec = FlightRecorder(max_events=4, horizon_s=0.0,
                         min_dump_interval_s=3600.0)
    for i in range(8):
        rec.note("k", f"e{i}")
    assert len(rec._events) == 4
    assert rec.events() == []
    assert rec.trigger("x") is None
    assert rec.triggers["x"] == 1


def test_flightrec_notes_lifecycle_steps():
    from nnstreamer_tpu_torch.runtime.lifecycle import VersionManager
    from nnstreamer_tpu_torch.runtime.serving import PoolEntry

    entry = PoolEntry(("torch-cuda", "m", ""), object(), lambda sp: None)
    VersionManager(entry)._note("swap", version="v1", frames=3)
    (e,) = [e for e in FLIGHT.events() if e["kind"] == "lifecycle"]
    assert e["name"] == "torch-cuda:m:swap"
    assert e["args"] == {"version": "v1", "frames": 3}
