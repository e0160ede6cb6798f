"""Profiling hooks: ``torch.profiler`` traces with per-element annotation.

Counterpart of the JAX package's ``utils/profile.py``.  The reference
defers profiling to GStreamer ecosystem tooling (gst-instruments,
gst-top, NNShark) plus its per-filter latency props; here the substitute
is ``torch.profiler``: :func:`pipeline_trace` captures a Chrome trace of
everything the pipeline runs (CPU ops and, on a card, the CUDA kernels
and copies), and every element's chain runs under a ``record_function``
span carrying the element name, so per-element time shows on the
timeline the way gst-top attributes time per GstElement.

Usage::

    from nnstreamer_tpu_torch.utils.profile import pipeline_trace

    with pipeline_trace("/tmp/nns-trace"):
        with pipeline:
            ... stream ...
    # chrome://tracing or ui.perfetto.dev: /tmp/nns-trace/trace.json

Annotations are near-free when no trace is active; ``annotate`` is used
by the runtime automatically.

Which thread may open a trace: ``torch.profiler`` starts and stops on
the calling thread while the other threads keep running ops, and starting
or stopping it while another thread is inside a torch op can corrupt the
allocator's state (``double free or corruption``, seen with the
streaming thread in ``torch.cat``).  So every start and stop in the port
goes through :data:`GATE`: the threads that run torch ops for a
pipeline enter it (each element loop's iteration, each window drain,
``Pipeline.start``'s element starts, each actuation), and step out of it
for their blocking waits (a full queue, a parked window's backpressure,
another thread's window flush, an empty ``appsrc`` or repo slot, a full
``appsink`` or repo slot, a source's pacing); a session starts or stops
inside :meth:`OpGate.hold`, which closes the gate, waits until no other
thread is inside, runs the call and reopens.  Threads the gate does not
cover are the application's own: run no torch op on them while a trace
opens or closes.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

_active = threading.Event()

#: the file a trace is written to inside ``log_dir``
TRACE_FILE = "trace.json"


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class OpGate:
    """The gate between the threads that run torch ops and a
    ``torch.profiler`` session's start or stop.

    A counter of the threads inside, under one condition.
    :meth:`enter`/:meth:`exit` bracket a stretch of torch work (re-entrant
    on a thread: a producer's inline window drain runs inside its
    loop's stretch); :meth:`outside` steps a thread out for a blocking
    wait, so a thread parked on another never holds the gate; and
    :meth:`hold`, with one owner at a time, closes the gate, waits for
    the count to reach zero, runs its call and reopens.  While the gate
    is closed, a thread that would enter, or come back from a wait,
    blocks: frames are delayed by the hold, never lost."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._inside = 0
        self._closed = False
        self._tls = threading.local()
        #: completed holds, and the last one's seconds from closing to
        #: reopening (how long gated threads were held up)
        self.holds = 0
        self.last_hold_s = 0.0

    def enter(self) -> None:
        tls = self._tls
        depth = getattr(tls, "depth", 0)
        if depth == 0:
            with self._cond:
                while self._closed:
                    self._cond.wait()
                self._inside += 1
        tls.depth = depth + 1

    def exit(self) -> None:
        tls = self._tls
        tls.depth -= 1
        if tls.depth == 0:
            with self._cond:
                self._inside -= 1
                if self._closed:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def inside(self):
        self.enter()
        try:
            yield
        finally:
            self.exit()

    @contextlib.contextmanager
    def outside(self):
        """Leave the gate for a blocking wait (no torch op inside), and
        come back once it is open."""
        tls = self._tls
        depth = getattr(tls, "depth", 0)
        if depth == 0:
            yield
            return
        tls.depth = 0
        with self._cond:
            self._inside -= 1
            if self._closed:
                self._cond.notify_all()
        try:
            yield
        finally:
            with self._cond:
                while self._closed:
                    self._cond.wait()
                self._inside += 1
            tls.depth = depth

    def hold(self, fn, timeout_s: float):
        """``fn()`` with no other thread inside the gate; its result.
        The calling thread may itself be inside (a sink callback).
        Holds take turns.  Raises TimeoutError, with the gate reopened
        and ``fn`` not run, when the others have not left within
        ``timeout_s``."""
        own = 1 if getattr(self._tls, "depth", 0) else 0
        with self._cond:
            deadline = time.monotonic() + timeout_s
            while self._closed:
                if not self._cond.wait(deadline - time.monotonic()):
                    raise TimeoutError(
                        f"another start/stop held the gate for "
                        f"{timeout_s:g} s")
            self._closed = True
            t_closed = time.monotonic()
            while self._inside > own:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    busy = self._inside - own
                    self._closed = False
                    self._cond.notify_all()
                    raise TimeoutError(
                        f"no quiescent point within {timeout_s:g} s "
                        f"({busy} thread(s) still running torch work)")
                self._cond.wait(remain)
        try:
            return fn()
        finally:
            with self._cond:
                self._closed = False
                self._cond.notify_all()
                self.holds += 1
                self.last_hold_s = time.monotonic() - t_closed


#: the process's one gate (module docstring)
GATE = OpGate()

#: seconds :func:`pipeline_trace` waits for the gate to empty
TRACE_QUIESCE_S = 60.0


@contextlib.contextmanager
def pipeline_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of everything run inside and
    write it as ``<log_dir>/trace.json`` (Chrome trace format).  The
    session starts and stops inside :meth:`OpGate.hold`, so it may open
    while pipelines run."""
    import torch.profiler

    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    GATE.hold(prof.start, TRACE_QUIESCE_S)
    _active.set()
    try:
        yield log_dir
    finally:
        _active.clear()
        stop_when_quiescent(prof.stop, TRACE_QUIESCE_S)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def stop_when_quiescent(stop, timeout_s: float, on_timeout=None) -> None:
    """``GATE.hold(stop, timeout_s)`` until it runs: a session that
    started must stop, and stopping it outside the gate could corrupt
    the process, so each timeout is reported to ``on_timeout`` (when
    given) and the hold tried again."""
    while True:
        try:
            GATE.hold(stop, timeout_s)
            return
        except TimeoutError as e:
            if on_timeout is not None:
                on_timeout(e)


def trace_active() -> bool:
    return _active.is_set()


@contextlib.contextmanager
def annotate(name: str):
    """Per-element trace span; no-op unless a trace is being captured."""
    if not _active.is_set():
        yield
        return
    import torch.profiler

    with torch.profiler.record_function(name):
        yield


def step_marker(name: str, step: int) -> "contextlib.AbstractContextManager":
    """A ``<name>#<step>`` span for training loops (a no-op outside a
    trace)."""
    if not _active.is_set():
        return contextlib.nullcontext()
    import torch.profiler

    return torch.profiler.record_function(f"{name}#{step}")


def frame_annotation(trace_ids) -> "contextlib.AbstractContextManager":
    """A span naming the obs trace ids riding a dispatch.

    The join key between the two trace worlds: the host-side latency
    tracer (obs/tracer.py, Chrome trace) stamps each sampled frame with
    a process-unique id, and wrapping the dispatch in
    ``nns:frames:<ids>`` makes the same ids searchable on the
    ``torch.profiler`` timeline, so a slow frame found in one trace can
    be located in the other.  No-op (and near-free) unless a
    :func:`pipeline_trace` capture is active AND the dispatch carries at
    least one sampled frame."""
    if not _active.is_set() or not trace_ids:
        return contextlib.nullcontext()
    import torch.profiler

    return torch.profiler.record_function(
        "nns:frames:" + ",".join(str(i) for i in trace_ids))
