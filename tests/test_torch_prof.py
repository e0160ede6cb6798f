from torch_replay import replay
replay("test_prof.py", globals())


# -- the port alone: card waits, the dispatch split, the device capture ------

import sys as _sys  # noqa: E402

from nnstreamer_tpu_torch.elements.filter import TensorFilter  # noqa: E402
from nnstreamer_tpu_torch.filters import (register_model,  # noqa: E402
                                          unregister_model)
from nnstreamer_tpu_torch.elements.basic import Identity  # noqa: E402
from nnstreamer_tpu_torch.utils import device as _device  # noqa: E402
from nnstreamer_tpu_torch.utils import profile as _uprofile  # noqa: E402

CARD_WAIT_S = 0.01


class CardWaitSink(AppSink):
    """Blocks CARD_WAIT_S a buffer in a stub card wait: the C call
    (``time.sleep``) stands where ``Event.synchronize`` blocks on a
    card, under the port's one named wait function."""

    def chain(self, pad, buf):
        _device.card_wait(time.sleep, CARD_WAIT_S)
        return super().chain(pad, buf)


def test_card_wait_counts_as_wait_in_accounts_and_sampler():
    p = Pipeline(device="cpu", name="cardwait")
    src = AppSrc(name="src", spec=_spec(), max_buffers=64)
    q = Queue(name="q", max_size_buffers=64)
    sink = CardWaitSink(name="out", max_buffers=64)
    p.add(src, q, sink).link(src, q, sink)
    p.start()
    try:
        n = 12
        for i in range(n):
            src.push_buffer(Buffer.of(np.zeros(SHAPE, np.float32), pts=i))
        waiting = []
        for _ in range(n):
            # the sink thread is blocked in card_wait most of the time:
            # sample its top frame directly
            for ident, frame in _sys._current_frames().items():
                info = prof.THREADS.lookup(ident)
                if info and info.get("element") == "q":
                    waiting.append(prof._is_waiting(frame))
            assert sink.pull(timeout=10) is not None
    finally:
        p.stop()
    rows = {(r["pipeline"], r["element"]): r for r in prof.account_rows()}
    q_row = rows[("cardwait", "q")]
    assert q_row["card_wait_s"] >= n * CARD_WAIT_S * 0.9
    # the card wait sits on the wait side: the run side is what is left
    assert q_row["wait_s"] >= q_row["card_wait_s"]
    assert q_row["run_s"] < q_row["card_wait_s"]
    assert waiting and all(waiting), waiting
    assert "card_wait" in prof._WAIT_LEAVES


@pytest.fixture
def _pooled():
    register_model("_t_prof_pool", lambda x: x * 2.0,
                   in_shapes=[SHAPE], in_dtypes=np.float32)
    p = Pipeline(device="cpu", name="profpool")
    src = AppSrc(name="src", spec=_spec(), max_buffers=256)
    q = Queue(name="q", max_size_buffers=256)
    flt = TensorFilter(name="net", framework="torch-cuda",
                       model="_t_prof_pool", batch=4, batch_timeout_ms=2.0,
                       batch_buckets="4", share_model=True)
    sink = AppSink(name="out", max_buffers=256)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    p.start()
    yield p, src, flt, sink
    p.stop()
    from nnstreamer_tpu_torch.runtime.serving import MODEL_POOL

    MODEL_POOL.clear()
    unregister_model("_t_prof_pool")


def _stream(src, sink, first, n):
    for i in range(first, first + n):
        src.push_buffer(Buffer.of(np.full(SHAPE, float(i), np.float32),
                                  pts=i))
    outs = [sink.pull(timeout=10) for _ in range(n)]
    assert [b.pts for b in outs] == list(range(first, first + n))
    for b in outs:
        np.testing.assert_array_equal(b.tensors[0].np(),
                                      np.full(SHAPE, 2.0 * b.pts))


def test_pool_dispatch_account_splits_the_cycle(_pooled):
    _p, src, flt, sink = _pooled
    _stream(src, sink, 0, 16)
    rows = {r["pool"]: r for r in prof.dispatch_rows()}
    row = rows[flt._pool_entry.label()]
    assert row["dispatches"] >= 4
    assert 0.0 <= row["cpu_s"] <= row["wall_s"] + 1e-3
    assert row["card_wait_s"] >= 0.0
    assert row["wall_ms"] == pytest.approx(
        row["wall_s"] / row["dispatches"] * 1e3, rel=1e-3)


def test_deep_capture_device_session_at_a_quiescent_point(_pooled, tmp_path):
    """The deep capture's torch.profiler session starts and stops inside
    the gate; frames that arrive meanwhile are delayed, never lost; the
    trace is written and loads."""
    _p, src, flt, sink = _pooled
    _stream(src, sink, 0, 8)
    holds = _uprofile.GATE.holds
    prof.DEEP.arm(str(tmp_path), seconds=0.3, hz=50.0, min_interval_s=0.0,
                  device=True)
    assert prof.deep_trigger("unit")
    _stream(src, sink, 8, 40)
    deadline = time.monotonic() + 20
    while not prof.DEEP.captures and time.monotonic() < deadline:
        time.sleep(0.02)
    assert prof.DEEP.captures, "no capture written"
    assert prof.DEEP.device_failures == 0, prof.DEEP.last_device_error
    (trace,) = prof.DEEP.device_traces
    with open(trace) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    assert _uprofile.GATE.holds == holds + 2  # one start, one stop
    assert not flt._pool_entry.batcher.paused  # the pool is never paused
    _stream(src, sink, 48, 8)
    health = prof.prof_health()
    assert health["deep_device_failures"] == 0
    assert health["deep_gate_max_hold_s"] > 0


def test_deep_capture_without_quiescent_point_is_counted(tmp_path):
    """A device session that cannot reach a quiescent point (a thread
    stays inside the gate) is counted and logged, the host capture
    still lands, and the gate reopens."""
    inside, leave = threading.Event(), threading.Event()

    def busy():
        with _uprofile.GATE.inside():
            inside.set()
            leave.wait(10)

    t = threading.Thread(target=busy)
    t.start()
    inside.wait(5)
    prof.DEEP.arm(str(tmp_path), seconds=0.05, hz=50.0,
                  min_interval_s=0.0, device=True)
    prof.DEEP.quiesce_s = 0.1
    try:
        assert prof.deep_trigger("busy")
        deadline = time.monotonic() + 10
        while not prof.DEEP.captures and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        prof.DEEP.quiesce_s = 5.0
        leave.set()
        t.join(5)
    assert prof.DEEP.captures and not prof.DEEP.device_traces
    assert prof.DEEP.device_failures == 1
    assert "quiescent" in prof.DEEP.last_device_error
    assert prof.prof_health()["deep_device_failures"] == 1
    with _uprofile.GATE.inside():  # reopened: entering does not block
        pass


class _OpClock:
    """How many threads are inside a stub torch op, and whether one was
    while a profiler session started or stopped."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active = 0
        self.ops = 0
        self.overlaps = []

    def op(self, seconds=0.001):
        with self.lock:
            self.active += 1
            self.ops += 1
        time.sleep(seconds)
        with self.lock:
            self.active -= 1

    def session_call(self, what):
        # a start/stop that takes a while: nothing may run meanwhile
        with self.lock:
            ops0 = self.ops
            if self.active:
                self.overlaps.append((what, "entry", self.active))
        for _ in range(10):
            time.sleep(0.003)
            with self.lock:
                if self.active or self.ops != ops0:
                    self.overlaps.append((what, "during", self.active))


def test_deep_capture_holds_off_open_loop_traffic(tmp_path, monkeypatch):
    """Open-loop frames (a camera that never waits for results) keep
    arriving through a deep capture: on the source loop, the queue loop
    and the pool's window drain, no stub torch op runs while the
    session starts or stops, and every frame arrives, in order."""
    clock = _OpClock()

    class BusyOp(Identity):
        def chain(self, pad, buf):
            clock.op()
            self.push(buf)

    class FakeSession:
        def __init__(self, activities=None):
            pass

        def start(self):
            clock.session_call("start")

        def stop(self):
            clock.session_call("stop")

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [{"name": "stub"}]}, f)

    import torch.profiler

    monkeypatch.setattr(torch.profiler, "profile", FakeSession)

    def model(x):
        clock.op(0.002)
        return x * 2.0

    register_model("_t_prof_open", model, in_shapes=[SHAPE],
                   in_dtypes=np.float32)
    p = Pipeline(device="cpu", name="openloop")
    src = AppSrc(name="src", spec=_spec(), max_buffers=4096)
    pre = BusyOp(name="pre")
    q = Queue(name="q", max_size_buffers=4096)
    mid = BusyOp(name="mid")
    flt = TensorFilter(name="net", framework="torch-cuda",
                       model="_t_prof_open", batch=4, batch_timeout_ms=2.0,
                       batch_buckets="4", share_model=True)
    sink = AppSink(name="out", max_buffers=4096)
    p.add(src, pre, q, mid, flt, sink).link(src, pre, q, mid, flt, sink)
    n = 0
    stop = threading.Event()

    def camera():
        nonlocal n
        while not stop.is_set():
            src.push_buffer(Buffer.of(np.full(SHAPE, float(n), np.float32),
                                      pts=n))
            n += 1
            time.sleep(0.002)

    cam = threading.Thread(target=camera)
    p.start()
    try:
        cam.start()
        prof.DEEP.arm(str(tmp_path), seconds=0.2, hz=50.0,
                      min_interval_s=0.0, device=True)
        assert prof.deep_trigger("open-loop")
        deadline = time.monotonic() + 20
        while not prof.DEEP.device_traces and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.05)
        stop.set()
        cam.join(5)
        outs = [sink.pull(timeout=10) for _ in range(n)]
    finally:
        stop.set()
        p.stop()
        from nnstreamer_tpu_torch.runtime.serving import MODEL_POOL

        MODEL_POOL.clear()
        unregister_model("_t_prof_open")
    assert prof.DEEP.device_failures == 0, prof.DEEP.last_device_error
    assert prof.DEEP.device_traces
    assert clock.overlaps == []
    assert n > 50
    assert [b.pts for b in outs] == list(range(n))


def test_card_wait_is_bare_under_the_kill_switch(monkeypatch):
    """With NNS_TPU_TORCH_OBS_DISABLE set, card_wait is the call alone:
    no clock moves."""
    from nnstreamer_tpu_torch.obs import hooks as _obs_hooks

    monkeypatch.setattr(_obs_hooks, "DISABLED", True)
    w0 = _device.card_wait_seconds()
    assert _device.card_wait(time.sleep, 0.01) is None
    assert _device.card_wait_seconds() == w0
    monkeypatch.setattr(_obs_hooks, "DISABLED", False)
    _device.card_wait(time.sleep, 0.01)
    assert _device.card_wait_seconds() >= w0 + 0.009


def test_deep_first_trigger_on_a_fresh_clock(tmp_path, monkeypatch):
    """The first episode is never rate-limited, even where the monotonic
    clock still reads less than min_interval_s (a freshly booted
    machine); the second one within the interval is."""
    prof.DEEP.arm(str(tmp_path), seconds=0.01, hz=50.0,
                  min_interval_s=3600.0)
    real, base = time.monotonic, time.monotonic()
    monkeypatch.setattr(prof.time, "monotonic", lambda: real() - base + 5.0)
    assert prof.deep_trigger("fresh")
    deadline = time.time() + 10
    while not prof.DEEP.captures and time.time() < deadline:
        time.sleep(0.02)
    assert prof.DEEP.captures
    assert not prof.deep_trigger("again")
    assert prof.DEEP.skipped == 1


def test_deep_one_capture_at_a_time(tmp_path):
    """A trigger while an episode runs is skipped, whatever the rate
    limit allows: two torch.profiler sessions cannot overlap."""
    prof.DEEP.arm(str(tmp_path), seconds=0.3, hz=50.0, min_interval_s=0.0)
    assert prof.deep_trigger("first")
    assert not prof.deep_trigger("second")
    assert prof.DEEP.skipped == 1
    deadline = time.time() + 10
    while not prof.DEEP.captures and time.time() < deadline:
        time.sleep(0.02)
    time.sleep(0.05)  # the episode's thread clears its flag on exit
    assert prof.deep_trigger("third")
