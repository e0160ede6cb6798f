"""``tests/test_profile_hw.py`` replayed on the port, whose spans open
while any ``torch.profiler`` session records (the process-wide flag
stands for the JAX package's ``trace_active()``; ``span`` for its
``annotate``), then the port's own gate tests."""

from torch_replay import replay

replay("test_profile_hw.py", globals(), subs=(
    ("from nnstreamer_tpu.utils.profile import (\n    annotate,\n"
     "    pipeline_trace,\n    trace_active,\n)",
     "from torch.autograd import profiler as _tap\n\n"
     "from nnstreamer_tpu.utils.profile import pipeline_trace, span\n\n\n"
     "def trace_active():\n    return _tap._is_profiler_enabled\n\n\n"
     "def annotate(name):\n    return span(\"chain\", name)"),
))


# -- the port alone: trace start and stop behind the gate --------------------

import threading as _threading  # noqa: E402
import time as _time  # noqa: E402

from nnstreamer_tpu_torch.utils import profile as _uprofile  # noqa: E402


def test_pipeline_trace_waits_for_the_gate_to_empty(tmp_path):
    """A trace opened while another thread is inside the gate starts
    only once that thread has left it; the trace is still written."""
    inside, left = _threading.Event(), []

    def busy():
        with _uprofile.GATE.inside():
            inside.set()
            _time.sleep(0.2)
            left.append(_time.monotonic())

    t = _threading.Thread(target=busy)
    t.start()
    inside.wait(5)
    holds = _uprofile.GATE.holds
    with _uprofile.pipeline_trace(str(tmp_path)):
        started = _time.monotonic()
    t.join(5)
    assert left and started >= left[0]
    assert _uprofile.GATE.holds == holds + 2
    assert (tmp_path / _uprofile.TRACE_FILE).exists()


def test_gate_hold_from_inside_and_outside_waits():
    """A hold from a thread inside the gate waits only for the others;
    a thread stepped outside for a wait does not hold it up, and comes
    back only once the hold is over."""
    gate = _uprofile.OpGate()
    order = []
    outside, release = _threading.Event(), _threading.Event()

    def waiter():
        with gate.inside():
            with gate.outside():
                outside.set()
                release.wait(5)
            order.append("back")

    t = _threading.Thread(target=waiter)
    t.start()
    outside.wait(5)
    with gate.inside():
        def fn():
            release.set()
            _time.sleep(0.05)
            order.append("held")
        gate.hold(fn, 1.0)
    t.join(5)
    assert order == ["held", "back"]
    assert gate.holds == 1
