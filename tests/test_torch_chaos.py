"""Fault injection through both packages: the plan, its seams, admission.

``TestFaultPlan`` replays ``tests/test_chaos.py``'s plan tests through
``[jax]`` and ``[port]``: the grammar, its refusals, seeded determinism,
``every``/``after``/``count``, label and direction filters, composed
wire ops, corruption, reorder, the partition window, the invoke and queue
faults, the registry counter and the environment install (the port reads
``NNS_TPU_TORCH_CHAOS``).  Then the port's plan makes the same decisions
as the JAX plan for the same spec and event sequence.  The seams run
through the port's filter and pool: a ``fail-invoke`` on a shared window
reaches every owner's bus, a broken downstream errors only its own
stream, ``slow-invoke`` loses nothing and its sleeps are accounted,
``chaos=`` on a filter, ``queue-pressure`` in a micro-batched window —
with ``nns_chaos_injected_total`` equal to ``plan.counts()``.  Admission
(``TestAdmission``): the priority grammar, the ramp, EDF formation,
backpressure, and the p99 read from the registry's histogram.
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

import nnstreamer_tpu.chaos as jchaos
import nnstreamer_tpu.chaos.hooks as jchaos_hooks
import nnstreamer_tpu.chaos.plan as jplan
import nnstreamer_tpu.obs.metrics as jmetrics
import nnstreamer_tpu.runtime.admission as jadm
import nnstreamer_tpu.runtime.serving as jserving
import nnstreamer_tpu_torch.chaos as tchaos
import nnstreamer_tpu_torch.chaos.hooks as tchaos_hooks
import nnstreamer_tpu_torch.chaos.plan as tplan
import nnstreamer_tpu_torch.obs.metrics as tmetrics
import nnstreamer_tpu_torch.runtime.admission as tadm
import nnstreamer_tpu_torch.runtime.serving as tserving
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.elements.basic import AppSink, AppSrc, Queue
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.filters import register_model, unregister_model
from nnstreamer_tpu_torch.runtime import Pipeline
from nnstreamer_tpu_torch.runtime.events import MessageKind
from nnstreamer_tpu_torch.runtime.serving import MODEL_POOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": SimpleNamespace(chaos=jchaos, hooks=jchaos_hooks, plan=jplan,
                           metrics=jmetrics, adm=jadm, serving=jserving,
                           env="NNS_TPU_CHAOS"),
    "port": SimpleNamespace(chaos=tchaos, hooks=tchaos_hooks, plan=tplan,
                            metrics=tmetrics, adm=tadm, serving=tserving,
                            env="NNS_TPU_TORCH_CHAOS"),
}


@pytest.fixture(params=list(PKGS))
def P(request):
    pkg = PKGS[request.param]
    pkg.chaos.uninstall_plan()
    yield pkg
    pkg.chaos.uninstall_plan()


@pytest.fixture(autouse=True)
def _clean():
    tchaos.uninstall_plan()
    yield
    tchaos.uninstall_plan()
    MODEL_POOL.clear()


# -- FaultPlan ----------------------------------------------------------------


class TestFaultPlan:
    def test_parse_grammar(self, P):
        p = P.plan.FaultPlan.parse(
            "seed=42;drop:p=0.5;delay:ms=20,every=3,match=qcli;"
            "slow-invoke:ms=5,after=2,count=1;queue-pressure:ms=1")
        assert p.seed == 42
        assert [s.fault for s in p.specs] == [
            "drop", "delay", "slow-invoke", "queue-pressure"]
        assert p.specs[1].ms == 20 and p.specs[1].every == 3
        assert p.specs[2].after == 2 and p.specs[2].count == 1

    @pytest.mark.parametrize("bad", [
        "", "seed=1", "nosuchfault:p=0.5", "drop:p=2.0",
        "drop:wat=1", "drop:dir=sideways", "slow-invoke:ms=-1",
    ])
    def test_parse_rejects(self, P, bad):
        with pytest.raises(ValueError):
            P.plan.FaultPlan.parse(bad)

    def test_seeded_determinism(self, P):
        def run(seed):
            p = P.plan.FaultPlan.parse(f"seed={seed};drop:p=0.4")
            return [p.wire("l", "tx", b"x") is not None for _ in range(50)]

        assert run(7) == run(7)
        assert run(7) != run(8)

    def test_every_after_count(self, P):
        p = P.plan.FaultPlan([P.plan.FaultSpec("drop", every=3, after=2,
                                               count=2)])
        fired = [p.wire("l", "tx", b"x") is not None for _ in range(14)]
        assert fired.count(True) == 2
        assert p.counts() == {"drop": 2}

    def test_match_and_direction_filters(self, P):
        p = P.plan.FaultPlan([P.plan.FaultSpec("drop", match="qcli")])
        assert p.wire("other:peer", "tx", b"x") is None
        assert p.wire("qcli:127.0.0.1:5", "tx", b"x").frames == []
        p = P.plan.FaultPlan([P.plan.FaultSpec("drop", direction="rx")])
        assert p.wire("l", "tx", b"x") is None
        assert p.wire("l", "rx", b"x").frames == []

    def test_duplicate_and_delay_compose(self, P):
        p = P.plan.FaultPlan([P.plan.FaultSpec("duplicate"),
                              P.plan.FaultSpec("delay", ms=30)])
        op = p.wire("l", "tx", b"abc")
        assert op.frames == [b"abc", b"abc"]
        assert op.delay_s == pytest.approx(0.03)

    def test_corrupt_flips_bytes_only(self, P):
        p = P.plan.FaultPlan([P.plan.FaultSpec("corrupt")], seed=5)
        op = p.wire("l", "tx", b"hello world")
        assert len(op.frames) == 1 and op.frames[0] != b"hello world"
        assert p.wire("l", "tx", object()) is None

    def test_reorder_swaps_adjacent(self, P):
        p = P.plan.FaultPlan([P.plan.FaultSpec("reorder", every=1)])
        assert p.wire("l", "tx", b"A").frames == []
        assert p.wire("l", "tx", b"B").frames == [b"B", b"A"]
        assert p.flush_held("l", "tx") is None

    def test_partition_window_drops_everything(self, P):
        p = P.plan.FaultPlan([P.plan.FaultSpec("partition", ms=150,
                                               count=1)])
        assert p.wire("l", "tx", b"x").frames == []
        assert p.wire("l", "rx", b"y").frames == []
        time.sleep(0.2)
        assert p.wire("l", "tx", b"z") is None

    def test_invoke_faults(self, P):
        p = P.plan.FaultPlan([P.plan.FaultSpec("slow-invoke", ms=10,
                                               count=1),
                              P.plan.FaultSpec("fail-invoke", after=1,
                                               count=1)])
        assert p.invoke_fault("m") == ("slow", pytest.approx(0.01))
        assert p.invoke_fault("m") == ("fail", 0.0)
        assert p.invoke_fault("m") is None
        q = P.plan.FaultPlan([P.plan.FaultSpec("fail-invoke")])
        with pytest.raises(P.chaos.ChaosInvokeError):
            P.plan.apply_invoke_fault(q, "m")

    def test_queue_stall(self, P):
        p = P.plan.FaultPlan([P.plan.FaultSpec("queue-pressure", ms=7,
                                               count=1)])
        assert p.queue_stall("b") == pytest.approx(0.007)
        assert p.queue_stall("b") == 0.0

    def test_registry_counter_exported(self, P):
        p = P.plan.FaultPlan([P.plan.FaultSpec("drop", count=1)])
        p.wire("l", "tx", b"x")
        samples = P.metrics.REGISTRY.collect()[
            "nns_chaos_injected_total"]["samples"]
        row = [s for s in samples if s["labels"].get("fault") == "drop"]
        assert row and row[0]["value"] >= 1
        assert set(row[0]["labels"]) == {"fault", "seam"}

    def test_env_install(self, P, monkeypatch):
        monkeypatch.setattr(P.hooks, "_env_checked", False)
        monkeypatch.setenv(P.env, "seed=3;drop:p=0.1")
        P.hooks.maybe_install_from_env()
        assert P.chaos.active_plan() is not None
        assert P.chaos.active_plan().seed == 3

    def test_env_malformed_is_ignored(self, P, monkeypatch):
        monkeypatch.setattr(P.hooks, "_env_checked", False)
        monkeypatch.setenv(P.env, "not-a-fault")
        P.hooks.maybe_install_from_env()
        assert P.chaos.active_plan() is None


def test_fault_tables_equal():
    assert tplan.FAULTS == jplan.FAULTS
    assert (tplan.WIRE_FAULTS, tplan.INVOKE_FAULTS, tplan.QUEUE_FAULTS) == \
        (jplan.WIRE_FAULTS, jplan.INVOKE_FAULTS, jplan.QUEUE_FAULTS)


SPECS = [
    "seed=7;slow-invoke:ms=2,p=0.05,match=pool",
    "seed=3;fail-invoke:every=2,count=1",
    "seed=11;drop:p=0.3;delay:ms=5,p=0.5;corrupt:p=0.2;duplicate:every=4",
    "seed=5;reorder:p=0.5,dir=tx;slow-invoke:ms=1,p=0.7,after=3",
    "seed=9;queue-pressure:ms=1,p=0.25;fail-invoke:p=0.1,count=3",
]


@pytest.mark.parametrize("spec", SPECS)
def test_same_decisions_as_jax(spec):
    """One spec, one sequence of events on every seam: the two plans
    make the same decisions and count the same injections."""
    pj, pt = jplan.FaultPlan.parse(spec), tplan.FaultPlan.parse(spec)
    assert [vars(s) for s in pt.specs] == [vars(s) for s in pj.specs]
    for i in range(300):
        label = ("pool:torch:m", "qcli", "net")[i % 3]
        data = bytes([i % 256]) * 8
        ops = [p.wire(label, ("tx", "rx")[i % 2], data) for p in (pj, pt)]
        assert (ops[0] is None) == (ops[1] is None)
        if ops[0] is not None:
            assert ops[0].frames == ops[1].frames
            assert ops[0].delay_s == ops[1].delay_s
            assert ops[0].disconnect == ops[1].disconnect
        assert pj.invoke_fault(label) == pt.invoke_fault(label)
        assert pj.queue_stall(label) == pt.queue_stall(label)
    assert pt.counts() == pj.counts()
    assert pt.total_injected == pj.total_injected


# -- the seams through the port's filter and pool ---------------------------

SHAPE = (4,)


def _pool_pipe(name, model, slo_ms=0.0, priority="normal", batch=4,
               timeout_ms=2.0, **kw):
    spec = TensorsSpec.from_shapes([SHAPE], np.float32)
    p = Pipeline(name=name, device="cpu")
    src = AppSrc(name="src", spec=spec, max_buffers=64)
    q = Queue(name="q", max_size_buffers=64)
    flt = TensorFilter(name="net", framework="torch-cuda", model=model,
                       batch=batch, batch_timeout_ms=timeout_ms,
                       batch_buckets=str(batch), share_model=True,
                       slo_ms=slo_ms, priority=priority, **kw)
    sink = AppSink(name="sink", max_buffers=64)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    return p, {"src": src, "q": q, "flt": flt, "sink": sink}


def _frame(n):
    return Buffer.of(np.zeros((4,), np.float32), pts=n)


def _injected(fault):
    fam = tmetrics.REGISTRY.collect().get("nns_chaos_injected_total")
    return sum(s["value"] for s in (fam or {}).get("samples", [])
               if s["labels"]["fault"] == fault)


def _errors(p):
    errs = []
    p.bus.add_watch(lambda m: errs.append(m)
                    if m.kind == MessageKind.ERROR else None)
    return errs


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


class TestPoolFaults:
    def test_fail_invoke_fans_out_to_every_sharing_bus(self):
        """ONE fail-invoke on a window holding both streams' frames errors
        on both buses.  The window is composed deterministically: the
        adaptive early flush is off and the deadline far, so the fourth
        frame fills the window and dispatches it."""
        model = register_model("tchaos_fanout", lambda x: x * 3.0,
                               in_shapes=[SHAPE], in_dtypes=np.float32)
        pa, ea = _pool_pipe("fan-a", model, timeout_ms=60000.0)
        pb, eb = _pool_pipe("fan-b", model, timeout_ms=60000.0)
        errs = {"a": _errors(pa), "b": _errors(pb)}
        pa.start()
        pb.start()
        try:
            entry = ea["flt"].pool
            entry.batcher.adaptive = False
            before = _injected("fail-invoke")
            plan = tchaos.install_plan(tplan.FaultPlan.parse(
                "seed=1;fail-invoke:count=1,match=pool:"))
            for n in range(2):
                ea["src"].push_buffer(_frame(n))
                eb["src"].push_buffer(_frame(n))
            assert _wait(lambda: errs["a"] and errs["b"]), errs
            assert isinstance(errs["a"][0].error, tchaos.ChaosInvokeError)
            assert isinstance(errs["b"][0].error, tchaos.ChaosInvokeError)
            assert plan.counts() == {"fail-invoke": 1}
            assert _injected("fail-invoke") - before == 1
        finally:
            tchaos.uninstall_plan()
            pa.stop()
            pb.stop()
            unregister_model(model)

    def test_per_owner_error_routing_keeps_other_stream_alive(self):
        model = register_model("tchaos_routing", lambda x: x - 1.0,
                               in_shapes=[SHAPE], in_dtypes=np.float32)
        pa, ea = _pool_pipe("route-a", model)
        pb, eb = _pool_pipe("route-b", model)
        errs = {"a": _errors(pa), "b": _errors(pb)}
        pa.start()
        pb.start()
        try:
            def boom(buf):
                raise RuntimeError("sink down")

            ea["sink"].render = boom
            for n in range(2):
                ea["src"].push_buffer(_frame(n))
                eb["src"].push_buffer(_frame(n))
            got_b = 0
            deadline = time.monotonic() + 10
            while got_b < 2 and time.monotonic() < deadline:
                if eb["sink"].pull(timeout=0.2) is not None:
                    got_b += 1
            assert got_b == 2
            assert errs["a"] and not errs["b"]
        finally:
            pa.stop()
            pb.stop()
            unregister_model(model)

    def test_slow_invoke_loses_nothing_and_is_accounted(self):
        model = register_model("tchaos_slow", lambda x: x * 5.0,
                               in_shapes=[SHAPE], in_dtypes=np.float32)
        p, e = _pool_pipe("slow-a", model)
        p.start()
        try:
            before = _injected("slow-invoke")
            plan = tchaos.install_plan(tplan.FaultPlan.parse(
                "seed=2;slow-invoke:ms=15,p=0.5,match=pool:"))
            for n in range(12):
                e["src"].push_buffer(_frame(n))
            got = 0
            deadline = time.monotonic() + 15
            while got < 12 and time.monotonic() < deadline:
                if e["sink"].pull(timeout=0.2) is not None:
                    got += 1
            assert got == 12
            k = plan.counts().get("slow-invoke", 0)
            assert k > 0
            assert _injected("slow-invoke") - before == k
            assert e["flt"].pool.chaos_sleep_s == pytest.approx(k * 0.015)
        finally:
            tchaos.uninstall_plan()
            p.stop()
            unregister_model(model)

    def test_filter_chaos_property_on_chain_path(self):
        """``chaos=`` scopes a plan to one filter: its unbatched dispatch
        raises the injected error onto the pipeline's bus."""
        model = register_model("tchaos_prop", lambda x: x + 2.0,
                               in_shapes=[SHAPE], in_dtypes=np.float32)
        spec = TensorsSpec.from_shapes([SHAPE], np.float32)
        p = Pipeline(name="chaos-prop", device="cpu")
        src = AppSrc(name="src", spec=spec, max_buffers=8)
        flt = TensorFilter(name="net", framework="torch-cuda", model=model,
                           chaos="seed=3;fail-invoke:every=2,count=1")
        sink = AppSink(name="sink", max_buffers=8)
        p.add(src, flt, sink).link(src, flt, sink)
        errs = _errors(p)
        with p:
            for n in range(4):
                src.push_buffer(_frame(n))
            got = [sink.pull(timeout=10) for _ in range(3)]
        assert [b.pts for b in got] == [0, 2, 3]
        assert len(errs) == 1
        assert isinstance(errs[0].error, tchaos.ChaosInvokeError)
        assert flt._chaos_plan.counts() == {"fail-invoke": 1}
        unregister_model(model)

    def test_queue_pressure_stalls_a_microbatch_window(self):
        model = register_model("tchaos_q", lambda x: x,
                               in_shapes=[SHAPE], in_dtypes=np.float32)
        spec = TensorsSpec.from_shapes([SHAPE], np.float32)
        p = Pipeline(name="chaos-q", device="cpu")
        src = AppSrc(name="src", spec=spec, max_buffers=16)
        flt = TensorFilter(name="netq", framework="torch-cuda", model=model,
                           batch=4, batch_timeout_ms=2.0, batch_buckets="4")
        sink = AppSink(name="sink", max_buffers=16)
        p.add(src, flt, sink).link(src, flt, sink)
        before = _injected("queue-pressure")
        plan = tchaos.install_plan(tplan.FaultPlan.parse(
            "seed=4;queue-pressure:ms=20,count=2,match=netq"))
        t0 = time.monotonic()
        with p:
            for n in range(8):
                src.push_buffer(_frame(n))
            src.end_of_stream()
            assert p.wait_eos(timeout=10)
        assert time.monotonic() - t0 >= 0.04
        assert [sink.pull(timeout=1).pts for _ in range(8)] == \
            list(range(8))
        assert plan.counts() == {"queue-pressure": 2}
        assert _injected("queue-pressure") - before == 2
        unregister_model(model)


def test_env_plan_installed_at_first_pipeline_start():
    """``NNS_TPU_TORCH_CHAOS`` installs the port's plan when the first
    pipeline starts; the JAX package's key installs nothing."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from nnstreamer_tpu_torch import chaos\n"
        "from nnstreamer_tpu_torch.runtime import parse_launch\n"
        "p = parse_launch('appsrc name=src caps=other/tensors,"
        "format=static,num_tensors=1,dimensions=4,types=float32,"
        "framerate=0/1 ! appsink', device='cpu')\n"
        "p.start(); p.stop()\n"
        "plan = chaos.active_plan()\n"
        "print(None if plan is None else plan.seed)\n")
    for key, want in (("NNS_TPU_TORCH_CHAOS", "5"), ("NNS_TPU_CHAOS", "None")):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("NNS_TPU_")}
        env[key] = "seed=5;drop:p=0.5"
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120,
                             cwd=REPO, env=env)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == [want]


# -- admission ----------------------------------------------------------------


class TestAdmission:
    def test_parse_priority(self, P):
        assert P.adm.parse_priority("high") == 0
        assert P.adm.parse_priority("normal") == 1
        assert P.adm.parse_priority("LOW") == 2
        assert P.adm.parse_priority(2) == 2
        assert P.adm.priority_name(0) == "high"
        with pytest.raises(ValueError):
            P.adm.parse_priority("urgent")

    def test_ramp_and_at_risk(self, P):
        adm = P.adm.AdmissionController(slo_s=0.1, window=64)
        for _ in range(32):
            adm.observe(0.01)
        assert not adm.at_risk and adm.shed_probability == 0.0
        for _ in range(64):
            adm.observe(0.5)
        assert adm.at_risk
        assert adm.shed_probability == 1.0
        assert adm.risk_episodes == 1

    def test_admit_protects_high_sheds_low(self, P):
        adm = P.adm.AdmissionController(slo_s=0.05)
        for _ in range(64):
            adm.observe(1.0)
        assert adm.admit(P.adm.parse_priority("high"))
        assert not adm.admit(P.adm.parse_priority("low"))
        snap = adm.snapshot()
        assert snap["shed"]["low"] == 1
        assert snap["submitted"]["high"] == 1
        assert adm.total_shed == 1

    def test_shared_batcher_edf_formation(self, P):
        flushed = []
        sb = P.serving.SharedBatcher(max_batch=2, timeout_s=1000.0,
                                     flush_fn=flushed.extend,
                                     adaptive=False)
        sb.edf = True
        now = time.monotonic()
        with sb._cv:
            sb._pending.extend([
                ("A", 1, now + 50.0, now), ("A", 2, now + 50.0, now),
                ("B", 3, now + 1.0, now), ("B", 4, now + 1.0, now)])
        sb._drain()
        assert [it[:2] for it in flushed] == [("B", 3), ("B", 4)]
        sb._drain()
        assert [it[:2] for it in flushed[2:]] == [("A", 1), ("A", 2)]

    def test_wait_below_backpressure_and_timeout(self, P):
        sb = P.serving.SharedBatcher(max_batch=64, timeout_s=1000.0,
                                     flush_fn=lambda items: None,
                                     adaptive=False)
        for i in range(4):
            sb.submit_from("A", i)
        assert sb.wait_below("B", 4, timeout_s=0.1)
        t0 = time.monotonic()
        assert not sb.wait_below("A", 4, timeout_s=0.2)
        assert 0.15 <= time.monotonic() - t0 <= 2.0

    def test_p99_reads_exported_histogram(self, P):
        reg = P.metrics.MetricsRegistry()
        hist = reg.histogram(
            "nns_admission_latency_seconds", "t", labelnames=("pool",),
            buckets=P.metrics.ADMISSION_LATENCY_BUCKETS).labels(pool="t")
        adm = P.adm.AdmissionController(slo_s=0.03, hist=hist)
        for _ in range(64):
            adm.observe(0.012)
        assert 0.010 <= adm.p99_s <= 0.015
        assert not adm.at_risk
        expo = reg.exposition()
        assert "nns_admission_latency_seconds_bucket" in expo
        assert 'pool="t"' in expo
        adm.reset_signal()
        for _ in range(64):
            adm.observe(0.028)
        assert adm.at_risk and adm.shed_probability > 0.5

    def test_fallbacks(self, P):
        adm = P.adm.AdmissionController(slo_s=0.1)
        for _ in range(64):
            adm.observe(0.5)
        assert adm.p99_s == 0.5
        reg = P.metrics.MetricsRegistry()
        hist = reg.histogram(
            "nns_admission_latency_seconds", "t", labelnames=("pool",),
            buckets=P.metrics.ADMISSION_LATENCY_BUCKETS).labels(pool="x")
        adm2 = P.adm.AdmissionController(slo_s=0.05, hist=hist)
        for _ in range(64):
            adm2.observe(10.0)
        assert adm2.p99_s == 10.0
        assert adm2.shed_probability == 1.0


def test_admission_p99_same_as_jax_over_one_latency_sequence():
    """The same latencies into both controllers wired to their
    registries' histograms: the same p99 at every recompute."""
    rng = np.random.default_rng(3)
    lats = rng.gamma(2.0, 0.006, 640)
    ctl = []
    for P in PKGS.values():
        reg = P.metrics.MetricsRegistry()
        hist = reg.histogram(
            "nns_admission_latency_seconds", "t", labelnames=("pool",),
            buckets=P.metrics.ADMISSION_LATENCY_BUCKETS).labels(pool="s")
        ctl.append(P.adm.AdmissionController(slo_s=0.03, hist=hist))
    for i, lat in enumerate(lats):
        for c in ctl:
            c.observe(float(lat))
        if i % 16 == 15:
            assert ctl[0].p99_s == ctl[1].p99_s
            assert ctl[0].shed_probability == ctl[1].shed_probability


def test_pool_admission_feeds_registry_histogram():
    model = register_model("tchaos_adm", lambda x: x + 1.0,
                           in_shapes=[SHAPE], in_dtypes=np.float32)
    p, e = _pool_pipe("adm-hist", model, batch=2, slo_ms=500.0)
    with p:
        for n in range(8):
            e["src"].push_buffer(_frame(n))
        for _ in range(8):
            assert e["sink"].pull(timeout=10) is not None
        entry = e["flt"].pool
        assert entry.admission._hist is not None
        fam = tmetrics.REGISTRY.collect()["nns_admission_latency_seconds"]
        counts = [s["value"] for s in fam["samples"]
                  if s.get("name", "").endswith("_count")
                  and s["labels"]["pool"] == entry.label()]
    assert counts and max(counts) >= 8
    unregister_model(model)
