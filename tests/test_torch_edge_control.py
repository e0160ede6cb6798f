"""The control plane on a real edge link of the port: the ``breaker``
actuator of an ``edgesrc``'s retry policy, and the ``redial-link`` playbook
of the JAX package's ``breaker-stuck`` recovery script (``bench.py``
``_mttr_breaker_stuck``) with shorter windows: the publisher's pipeline
dies, the subscriber's re-dial loop fails until its breaker opens, the
publisher is back at +0.5 s, and the ``breaker-open`` rule's playbook
forces the half-open probe before the open window ends."""

import gc
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.chaos.retrypolicy import CLOSED, HALF_OPEN, OPEN
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.elements.basic import AppSink, AppSrc
from nnstreamer_tpu_torch.obs.control import Controller, parse_playbooks
from nnstreamer_tpu_torch.obs.metrics import LinkMetrics
from nnstreamer_tpu_torch.obs.watch import Watch, parse_rules
from nnstreamer_tpu_torch.runtime import Pipeline
from nnstreamer_tpu_torch.runtime.actuators import find_actuators
from nnstreamer_tpu_torch.runtime.registry import make

SPEC = TensorsSpec.parse("4:1", "float32")
CAPS = "other/tensors,format=static,num_tensors=1,dimensions=4:1,types=float32"
OPEN_S = 4.0        # the breaker's open window (the script's is 8 s)
BACK_AFTER_S = 0.5  # the publisher returns (the script's is 1 s)


@pytest.fixture(autouse=True)
def _clean():
    # a stopped edgesrc of an earlier test in this process keeps its
    # retry policy (the registry holds them weakly) until the cyclic
    # collector frees its pipeline: collect, so only this test's links
    # are live
    gc.collect()
    LinkMetrics.clear_all()
    yield
    LinkMetrics.clear_all()


def _publisher(port, name):
    p = Pipeline(name=name, device="cpu")
    src = AppSrc(name="src", spec=SPEC, max_buffers=64)
    sink = make("edgesink", el_name="esink", host="127.0.0.1", port=port,
                topic="mttr")
    p.add(src, sink).link(src, sink)
    p.start()
    return p, src, sink


def _subscriber(port, name):
    p = Pipeline(name=name, device="cpu")
    esrc = make("edgesrc", el_name="esrc", dest_host="127.0.0.1",
                dest_port=port, topic="mttr", caps=CAPS,
                reconnect_timeout_s=60.0)
    outs = AppSink(name="out", max_buffers=256)
    p.add(esrc, outs).link(esrc, outs)
    p.start()
    return p, esrc, outs


def test_breaker_actuator_on_a_live_edgesrc_link():
    pub, _src, esink = _publisher(0, "brk-pub")
    sub, esrc, _outs = _subscriber(esink.port, "brk-sub")
    try:
        (act,) = find_actuators("link", "esrc", "breaker")
        act.cooldown_s = 0.0
        link = LinkMetrics.get("esrc", f"127.0.0.1:{esink.port}",
                               kind="edge-sub")
        esrc._retry.force_open()
        assert esrc._retry.state == OPEN
        assert link.snapshot()["breaker_state"] == OPEN
        assert act.actuate(1.0)["applied"] == 1.0
        assert esrc._retry.state == HALF_OPEN
        assert link.snapshot()["breaker_state"] == HALF_OPEN
        assert act.actuate(0.0)["applied"] == 0.0
        assert esrc._retry.state == CLOSED
        assert link.snapshot()["breaker_state"] == CLOSED
    finally:
        sub.stop()
        pub.stop()


def test_redial_link_playbook_recovers_a_stuck_breaker():
    pub, psrc, esink = _publisher(0, "mttr-pub")
    port = esink.port
    sub, esrc, outs = _subscriber(port, "mttr-sub")
    pol = esrc._retry
    pol.base_s, pol.max_s, pol.fail_threshold, pol.open_s = \
        0.05, 0.2, 3, OPEN_S
    state = {"stop": False, "pub": (pub, psrc), "got": 0}
    lock = threading.Lock()

    def pump():
        n = 0
        while not state["stop"]:
            with lock:
                src = state["pub"][1]
            try:
                src.push_buffer(Buffer.of(
                    np.full((1, 4), 1.0, np.float32), pts=n), timeout=0.2)
                n += 1
            except Exception:  # noqa: BLE001 - publisher down: keep trying
                pass
            while outs.pull(timeout=0) is not None:
                state["got"] += 1
            time.sleep(0.005)

    pump_t = threading.Thread(target=pump, daemon=True)
    pump_t.start()
    w = Watch(rules=parse_rules({"rule": [{
        "name": "breaker-open", "kind": "threshold",
        "metric": "nns_edge_breaker_state", "op": ">=", "value": "open",
        "severity": "critical"}]}), interval_s=0.05)
    ctl = Controller(playbooks=parse_playbooks({"playbook": [{
        "name": "redial-link", "rule": "breaker-open", "kind": "link",
        "actuator": "breaker", "action": "set", "value": 1.0,
        "cooldown": "0.3s"}]}), watch=w, interval_s=0.05)
    w.start()
    ctl.start()
    try:
        time.sleep(0.5)
        assert state["got"] > 0 and not w.alert_log  # a clean baseline
        got_at_fault = state["got"]
        t_fault = time.monotonic()
        pub.stop()

        def restart():
            time.sleep(BACK_AFTER_S)
            with lock:
                state["pub"] = _publisher(port, "mttr-pub2")[:2]

        threading.Thread(target=restart, daemon=True).start()
        recovered_at = None
        while time.monotonic() - t_fault < OPEN_S:
            if pol.state == CLOSED and state["got"] > got_at_fault \
                    and any(ev["rule"] == "breaker-open"
                            for ev in w.alert_log):
                recovered_at = time.monotonic() - t_fault
                break
            time.sleep(0.02)
        assert pol.breaker_opens >= 1
        assert [d["playbook"] for d in ctl.audit
                if d["outcome"] == "applied"][:1] == ["redial-link"]
        assert recovered_at is not None and recovered_at < OPEN_S, \
            f"no recovery within the {OPEN_S} s open window"
    finally:
        ctl.stop()
        w.stop()
        sub.stop()
        state["stop"] = True
        pump_t.join(timeout=5)
        with lock:
            state["pub"][0].stop()
