"""Profiling hooks: ``torch.profiler`` traces with the port's spans.

Counterpart of the JAX package's ``utils/profile.py``.  The reference
defers profiling to GStreamer ecosystem tooling (gst-instruments,
gst-top, NNShark) plus its per-filter latency props; here the substitute
is ``torch.profiler``: :func:`pipeline_trace` captures a Chrome trace of
what every thread of the process runs (CPU ops and, on a card, the CUDA
runtime calls, kernels and copies), and the port's code runs under
``nns:<kind>:<name>`` spans (``record_function``) that name where the
work comes from, the way gst-top attributes time per GstElement:

- ``nns:chain:<element>``: an element's chain (a container);
- ``nns:create:<element>``: a source's ``create()``;
- ``nns:invoke:<element>``: a filter's dispatch, per frame or a window
  (a container), with ``nns:frames:<ids>`` inside it when sampled obs
  frames ride it (:func:`frame_annotation`);
- ``nns:prologue:<element>``: the fused transform chain inside the
  filter's program;
- ``nns:stats_sync:<element>``: the blocking waits of a stats sample
  (``utils/stats.py`` ``DispatchSampler``);
- ``nns:fence:<element>``: a sink's wait for the window before;
- ``nns:vit:*`` and ``nns:dense:*``: the ViT's layers and its dense
  products' weight casts, products and bias adds (``models/vit.py``).

A span opens whenever a ``torch.profiler`` session records in the
process, whoever opened it (the process-wide flag
``torch.autograd.profiler._is_profiler_enabled``); with no session a
span site is one attribute read and a branch, and returns
:data:`NULL_SPAN`.  Which threads' spans land in the trace is the
session's choice: :func:`profile_all_threads` (the session of
:func:`pipeline_trace` and of ``obs/prof.py``'s deep capture) records
every thread; a session opened by plain ``torch.profiler.profile``
records only the thread that opened it, so the spans of the element
threads are not in its trace.  Spans recorded in the session share the
clock of its kernel records: a kernel joins its runtime launch by
``correlation``, and the launch the innermost span open on its thread.

Usage::

    from nnstreamer_tpu_torch.utils.profile import pipeline_trace

    with pipeline_trace("/tmp/nns-trace"):
        with pipeline:
            ... stream ...
    # chrome://tracing or ui.perfetto.dev: /tmp/nns-trace/trace.json

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
opens or closes.  The port's sessions start through
:func:`start_session`, which refuses to start one while another records:
two sessions that record every thread and overlap can crash the process.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from torch.autograd import profiler as _tap

#: the file a trace is written to inside ``log_dir``
TRACE_FILE = "trace.json"

#: what a span site returns while no session records: one shared
#: context that does nothing
NULL_SPAN = contextlib.nullcontext()


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def profile_all_threads():
    """A ``torch.profiler`` session (not started) of CPU and, with a
    card, CUDA activity that records the ops and spans of every thread
    of the process, not only of the one that starts it."""
    import torch.profiler

    return torch.profiler.profile(
        activities=_activities(),
        experimental_config=torch.profiler._ExperimentalConfig(
            profile_all_threads=True))


def start_session(session, timeout_s: float) -> None:
    """Start ``session`` inside :meth:`OpGate.hold`; refused
    (RuntimeError, nothing started) while another session records in the
    process: two sessions that overlap can crash it.  Holds take turns,
    so two starts cannot both pass the check."""
    def start():
        if _tap._is_profiler_enabled:
            raise RuntimeError("a torch.profiler session is already "
                               "recording in this process")
        session.start()

    GATE.hold(start, timeout_s)


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
    """Capture a ``torch.profiler`` trace of everything every thread
    runs inside and write it as ``<log_dir>/trace.json`` (Chrome trace
    format).  The session starts and stops inside :meth:`OpGate.hold`,
    so it may open while pipelines run."""
    os.makedirs(log_dir, exist_ok=True)
    prof = profile_all_threads()
    start_session(prof, TRACE_QUIESCE_S)
    try:
        yield log_dir
    finally:
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


def span(kind: str, name: str, frames=None):
    """The ``nns:<kind>:<name>`` span while a ``torch.profiler`` session
    records in the process, else :data:`NULL_SPAN`.  ``frames``: the
    buffer, or the list of buffers, a dispatch carries; those an obs
    tracer sampled put an ``nns:frames:<ids>`` span inside this one
    (:func:`frame_annotation`)."""
    if not _tap._is_profiler_enabled:
        return NULL_SPAN
    name = f"nns:{kind}:{name}"
    ids = () if frames is None else _trace_ids(
        [frames] if hasattr(frames, "meta") else frames)
    if not ids:
        return _record(name)
    stack = contextlib.ExitStack()
    stack.enter_context(_record(name))
    stack.enter_context(frame_annotation(ids))
    return stack


def _record(name: str):
    import torch.profiler

    return torch.profiler.record_function(name)


def _trace_ids(bufs):
    """Obs trace ids riding ``bufs`` (only 1-in-N sampled frames carry
    one)."""
    from ..obs.tracer import TRACE_META_KEY

    out = []
    for b in bufs:
        tr = b.meta.get(TRACE_META_KEY)
        if tr is not None and tr.get("id"):
            out.append(str(tr["id"]))
    return out


def step_marker(name: str, step: int) -> "contextlib.AbstractContextManager":
    """A ``<name>#<step>`` span for training loops (:data:`NULL_SPAN`
    while no session records)."""
    if not _tap._is_profiler_enabled:
        return NULL_SPAN
    return _record(f"{name}#{step}")


def frame_annotation(trace_ids) -> "contextlib.AbstractContextManager":
    """A span naming the obs trace ids riding a dispatch.

    The join key between the two trace worlds: the host-side latency
    tracer (obs/tracer.py, Chrome trace) stamps each sampled frame with
    a process-unique id, and wrapping the dispatch in
    ``nns:frames:<ids>`` makes the same ids searchable on the
    ``torch.profiler`` timeline, so a slow frame found in one trace can
    be located in the other.  :data:`NULL_SPAN` unless a session records
    AND the dispatch carries at least one sampled frame."""
    if not _tap._is_profiler_enabled or not trace_ids:
        return NULL_SPAN
    return _record("nns:frames:" + ",".join(str(i) for i in trace_ids))
