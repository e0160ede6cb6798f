"""Host-execution profiler: where the HOST CPU goes (``nns-prof``).

Counterpart of the JAX package's ``obs/prof.py``, with the same thread
names, metric families, ``profile`` table and ``/prof`` export.  The
tracer/metrics stack accounts for where a *buffer* spends time; this
module accounts for where the *host CPU* spends time, per element, split
run-vs-wait.

Three cooperating pieces:

**Thread registry + deterministic names.**  Every runtime thread is
spawned through :func:`named_thread` (or :func:`element_thread`), which
names it ``nns:<role>:<owner>`` — element loops get
``nns:<pipeline>:<element>`` — and registers the ident → (pipeline,
element, role, owner) mapping in :data:`THREADS`.  The name is the join
key: the sampling profiler, lockdep site labels and external ``py-spy``
output all attribute samples to the same strings.

**Sampling profiler** (:data:`PROFILER`).  A daemon thread walks
``sys._current_frames()`` at ``NNS_TPU_TORCH_PROF=<hz>`` (default off,
strictly inert under ``NNS_TPU_TORCH_OBS_DISABLE``), attributes each sampled
stack to its thread's registry entry, and aggregates collapsed stacks
into a bounded table (lowest-count eviction) plus a bounded ring of
recent samples — the ring is what a flight-recorder dump embeds
(``host_stacks``) and what the Perfetto export renders.  The sampler's
own ticks double as a GIL-pressure proxy: threads whose leaf frame is
not a known wait are *runnable*; ``runnable - 1`` of them are waiting
for the GIL (``nns_gil_waiters``).

**Card waits.**  A thread blocked on the card sits in C code
(``Event.synchronize``, ``.cpu()``, ``.item()``) with a Python frame of
the port's own on top, which no wait list could name.  So every card
wait on the port's paths goes through one small function,
``utils/device.py`` ``card_wait`` (the sink's fence, the transfer
ledger's drains, the sampled dispatch's synchronize): the sampler sees
``card_wait`` on top and counts a wait, and the element loops move the
card-wait clock's delta from their run side to their wait side.

**Exact run/wait accounting** (:data:`ACCOUNTS`).  Element loops
(``Queue._loop``, ``SourceElement._loop``) bracket the queue-pop (wait)
vs chain (run) boundary with ``time.monotonic()`` + ``time.thread_time()``
reads and feed per-element accumulators, exported as
``nns_element_cpu_seconds_total`` / ``nns_element_run_seconds_total`` /
``nns_element_wait_seconds_total`` and the snapshot-v10 ``profile``
table.  Unlike sampling this is exact: per-element cpu_seconds sum to
no more than the process CPU delta (the attribution-exactness gate).
The pool's window dispatch keeps an account of its own
(:func:`dispatch_account`, :func:`dispatch_rows`): wall, CPU and card
wait of each dispatch cycle, whichever thread ran it.

**Deep profiles** (:data:`DEEP`).  ``NNS_TPU_TORCH_PROF_DEEP_DIR`` arms
alert-triggered capture episodes: on a watch rule's rising edge
(``obs/watch.py`` ``_act_fire``) a short-lived thread samples densely
for ``NNS_TPU_TORCH_PROF_DEEP_SECONDS`` and writes a collapsed-stack file
next to the flight-recorder dump, optionally (``_PROF_DEEP_DEVICE=1``)
wrapping the episode in one ``torch.profiler`` session whose Chrome
trace holds the card's kernel rows.  Same discipline as the flight
recorder: rising-edge only (once per alert episode), internally
rate-limited, never on the sampler thread.

The device session starts and stops only at a quiescent point: starting
or stopping ``torch.profiler`` while another thread is inside a torch op
can corrupt the process.  Both go through ``utils/profile.py``'s gate
(``GATE.hold``): it closes, waits until no element loop, window drain,
pipeline start or actuation is inside, runs the call and reopens, so
frames are delayed by the hold, never lost.  A start that cannot reach
that point, or a session that fails, is counted
(``deep_device_failures`` in ``/healthz``) and logged, never hidden; a
stop that cannot is counted and tried again, since a session that
started must stop.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils import profile as _uprofile
from ..utils.device import card_wait_cpu_seconds, card_wait_seconds
from . import hooks as _hooks

# -- thread registry ----------------------------------------------------------


class ThreadRegistry:
    """ident → {role, owner, pipeline, element, name}: who each runtime
    thread belongs to.  Populated at thread spawn (inside the
    :func:`named_thread` wrapper, so registration and the thread's own
    lifetime coincide exactly); the profiler joins samples against it.
    Inert under ``NNS_TPU_TORCH_OBS_DISABLE`` (nothing registers)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_ident: Dict[int, Dict[str, str]] = {}

    def register(self, role: str, owner: str, pipeline: str = "",
                 element: str = "",
                 ident: Optional[int] = None) -> None:
        if _hooks.DISABLED:
            return
        if ident is None:
            ident = threading.get_ident()
            name = threading.current_thread().name
        else:
            name = ""
        with self._lock:
            self._by_ident[ident] = {
                "role": role, "owner": owner, "pipeline": pipeline,
                "element": element, "name": name,
            }

    def unregister(self, ident: Optional[int] = None) -> None:
        ident = threading.get_ident() if ident is None else ident
        with self._lock:
            self._by_ident.pop(ident, None)

    def lookup(self, ident: int) -> Optional[Dict[str, str]]:
        with self._lock:
            info = self._by_ident.get(ident)
            return dict(info) if info is not None else None

    def snapshot(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(v) for v in self._by_ident.values()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_ident)

    def clear(self) -> None:
        """Tests only."""
        with self._lock:
            self._by_ident.clear()


THREADS = ThreadRegistry()


def _label(info: Optional[Dict[str, str]], fallback: str) -> str:
    """One attribution string per thread — ``pipeline:element`` for
    element loops, ``role:owner`` for infrastructure threads, the raw
    thread name for anything unregistered."""
    if info is None:
        return fallback
    if info.get("pipeline") and info.get("element"):
        return f"{info['pipeline']}:{info['element']}"
    if info.get("owner"):
        return f"{info['role']}:{info['owner']}"
    return info.get("role") or fallback


def thread_name(role: str, owner: str = "", pipeline: str = "",
                element: str = "") -> str:
    """The deterministic name scheme: ``nns:<pipeline>:<element>`` for
    element loops, ``nns:<role>:<owner>`` (owner optional) otherwise."""
    if pipeline and element:
        return f"nns:{pipeline}:{element}"
    return f"nns:{role}:{owner}" if owner else f"nns:{role}"


def named_thread(role: str, owner: str, target, *, pipeline: str = "",
                 element: str = "", daemon: bool = True,
                 args: tuple = (), kwargs: Optional[dict] = None
                 ) -> threading.Thread:
    """A ``threading.Thread`` with the deterministic ``nns:`` name AND
    registry coverage: the wrapper registers the ident on entry and
    unregisters on exit, so the registry never holds a dead thread.
    The NAME is always applied (py-spy reads it regardless of obs
    state); the REGISTRATION no-ops under ``NNS_TPU_TORCH_OBS_DISABLE``."""
    name = thread_name(role, owner, pipeline, element)

    def _run(*a, **kw):
        THREADS.register(role, owner, pipeline=pipeline, element=element)
        try:
            target(*a, **kw)
        finally:
            THREADS.unregister()

    return threading.Thread(target=_run, name=name, daemon=daemon,
                            args=args, kwargs=kwargs or {})


def element_thread(element: Any, target, role: str) -> threading.Thread:
    """The element-loop spawn helper: derives the pipeline name from
    the element's back-reference (set by ``Pipeline.add``; ``-`` for a
    bare element in tests) so the thread is ``nns:<pipeline>:<element>``."""
    pipe = getattr(element, "pipeline", None)
    pname = getattr(pipe, "name", "") or "-"
    return named_thread(role, element.name, target,
                        pipeline=pname, element=element.name)


# -- exact per-element run/wait/CPU accounting --------------------------------


class ElementAccount:
    """Per-element accumulator, fed by exactly ONE loop thread (writes
    are unsynchronized by design — single writer, racy readers see an
    at-most-one-iteration-stale float)."""

    __slots__ = ("pipeline", "element", "cpu_s", "run_s", "wait_s",
                 "card_wait_s", "iters")

    def __init__(self, pipeline: str, element: str):
        self.pipeline = pipeline
        self.element = element
        self.cpu_s = 0.0
        self.run_s = 0.0
        self.wait_s = 0.0
        #: the part of wait_s spent blocked on the card inside the chain
        self.card_wait_s = 0.0
        self.iters = 0

    def add(self, wait_s: float, run_s: float, cpu_s: float) -> None:
        if wait_s > 0:
            self.wait_s += wait_s
        if run_s > 0:
            self.run_s += run_s
        if cpu_s > 0:
            self.cpu_s += cpu_s
        self.iters += 1

    def run_chain(self, push, buf, t0: float, c0: float) -> None:
        """The loop's run side: ``push(buf)`` (the whole downstream
        chain runs in this thread), accounted with the wait side that
        started at wall ``t0`` / thread CPU ``c0``.  Card waits inside
        the chain (``utils/device.py`` ``card_wait``) count as wait."""
        t1 = time.monotonic()
        w0 = card_wait_seconds()
        try:
            push(buf)
        finally:
            card = card_wait_seconds() - w0
            self.card_wait_s += card
            self.add(t1 - t0 + card, time.monotonic() - t1 - card,
                     time.thread_time() - c0)


_accounts_lock = threading.Lock()
ACCOUNTS: Dict[Tuple[str, str], ElementAccount] = {}


def element_account(pipeline: str, element: str
                    ) -> Optional[ElementAccount]:
    """The element loop's handle, fetched once at loop start.  Returns
    None under ``NNS_TPU_TORCH_OBS_DISABLE`` — the loop then skips its clock
    reads entirely (the whole accounting path costs nothing)."""
    if _hooks.DISABLED:
        return None
    key = (pipeline, element)
    with _accounts_lock:
        acct = ACCOUNTS.get(key)
        if acct is None:
            acct = ACCOUNTS[key] = ElementAccount(pipeline, element)
        return acct


def account_rows() -> List[dict]:
    """The accounting table as export rows (registry ``profile`` table
    + ``nns_element_*_seconds_total`` families)."""
    with _accounts_lock:
        accts = list(ACCOUNTS.values())
    return [{
        "pipeline": a.pipeline, "element": a.element,
        "cpu_s": round(a.cpu_s, 6), "run_s": round(a.run_s, 6),
        "wait_s": round(a.wait_s, 6),
        "card_wait_s": round(a.card_wait_s, 6), "iters": a.iters,
    } for a in sorted(accts, key=lambda a: (a.pipeline, a.element))]


class DispatchAccount:
    """One pool's window-dispatch cycle, split: wall seconds, the
    thread's CPU seconds outside card waits, and card-wait seconds of
    every dispatch (the window's invoke, demux, decoders and sinks, on
    whichever thread closed the window); the rest of the wall time is
    neither (waiting for the interpreter lock or another lock).
    Dispatches are serialized by the pool's flush lock: one writer at a
    time."""

    __slots__ = ("pool", "dispatches", "wall_s", "cpu_s", "card_wait_s",
                 "card_wait_cpu_s")

    def __init__(self, pool: str):
        self.pool = pool
        self.dispatches = 0
        self.wall_s = 0.0
        self.cpu_s = 0.0
        self.card_wait_s = 0.0
        self.card_wait_cpu_s = 0.0

    @staticmethod
    def begin() -> Tuple[float, float, float, float]:
        return (time.monotonic(), time.thread_time(), card_wait_seconds(),
                card_wait_cpu_seconds())

    def end(self, start: Tuple[float, float, float, float]) -> None:
        t0, c0, w0, wc0 = start
        wc = card_wait_cpu_seconds() - wc0
        self.wall_s += time.monotonic() - t0
        self.cpu_s += time.thread_time() - c0 - wc
        self.card_wait_s += card_wait_seconds() - w0
        self.card_wait_cpu_s += wc
        self.dispatches += 1


DISPATCHES: Dict[str, DispatchAccount] = {}


def dispatch_account(pool: str) -> Optional[DispatchAccount]:
    """The pool's dispatch account; None under the kill switch."""
    if _hooks.DISABLED:
        return None
    with _accounts_lock:
        acct = DISPATCHES.get(pool)
        if acct is None:
            acct = DISPATCHES[pool] = DispatchAccount(pool)
        return acct


def dispatch_rows() -> List[dict]:
    """Each pool's dispatch cycle: totals, and per dispatch in ms."""
    with _accounts_lock:
        accts = sorted(DISPATCHES.values(), key=lambda a: a.pool)
    rows = []
    for a in accts:
        n = max(a.dispatches, 1)
        rows.append({
            "pool": a.pool, "dispatches": a.dispatches,
            "wall_s": round(a.wall_s, 6), "cpu_s": round(a.cpu_s, 6),
            "card_wait_s": round(a.card_wait_s, 6),
            "card_wait_cpu_s": round(a.card_wait_cpu_s, 6),
            "wall_ms": a.wall_s / n * 1e3, "cpu_ms": a.cpu_s / n * 1e3,
            "card_wait_ms": a.card_wait_s / n * 1e3,
            "other_ms": (a.wall_s - a.cpu_s - a.card_wait_s) / n * 1e3,
        })
    return rows


def _reset_accounts() -> None:
    """Tests only."""
    with _accounts_lock:
        ACCOUNTS.clear()
        DISPATCHES.clear()


# -- stack collapse + wait classification -------------------------------------

#: leaf co_names that mean "this thread is blocked, not contending for
#: the GIL" — the sampler's runnable/waiting split (the GIL proxy) and
#: nothing else; attribution does not depend on this list being complete
_WAIT_LEAVES = frozenset({
    "wait", "sleep", "select", "poll", "epoll", "kqueue", "accept",
    "recv", "recvfrom", "recv_into", "read", "readinto", "readline",
    "acquire", "get", "join", "pull", "park", "_wait_for_tstate_lock",
    "wait_for", "settle", "card_wait",
})

#: leaf files that mean the same (stdlib blocking primitives)
_WAIT_FILES = frozenset({
    "threading.py", "selectors.py", "socket.py", "queue.py", "ssl.py",
    "connection.py", "subprocess.py",
})


#: per-code-object frame-string memo: code objects are module-level
#: and long-lived, so the basename split + format runs once per code
#: object instead of once per frame per tick — the difference between
#: a ~250us and a ~100us sampling pass.  Bounded by a dump-and-restart
#: (id() reuse after a code object dies can mislabel one line of one
#: sample; a profiler tolerates that, a leak it would not)
_CODE_STRS: Dict[int, str] = {}


def _frame_str(code) -> str:
    s = _CODE_STRS.get(id(code))
    if s is None:
        if len(_CODE_STRS) > 8192:
            _CODE_STRS.clear()
        s = f"{os.path.basename(code.co_filename)}:{code.co_name}"
        _CODE_STRS[id(code)] = s
    return s


def _collapse(frame, limit: int = 48) -> str:
    """One sampled stack as collapsed text, root first, leaf last:
    ``file.py:func;file.py:func;...`` — the flamegraph.pl input format
    (prefixed with the thread label by the exporters)."""
    parts: List[str] = []
    f = frame
    while f is not None and len(parts) < limit:
        parts.append(_frame_str(f.f_code))
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


def _is_waiting(frame) -> bool:
    code = frame.f_code
    return (code.co_name in _WAIT_LEAVES
            or os.path.basename(code.co_filename) in _WAIT_FILES)


# -- the sampling profiler ----------------------------------------------------


class SamplingProfiler:
    """Continuous low-overhead wall-clock sampler over
    ``sys._current_frames()``.

    One daemon thread (``nns:prof:sampler``), one bounded collapsed-
    stack table (lowest-count eviction when full — heavy stacks are by
    construction the high-count ones, so eviction loses tail noise),
    one bounded ring of recent samples for the flight-recorder embed
    and the Perfetto export.  Everything here tolerates being read
    while ticking; exports copy under the lock and render outside it."""

    def __init__(self, hz: float = 0.0, max_stacks: int = 512,
                 ring_len: int = 4096, ring_s: float = 30.0):
        self.hz = float(hz)
        self.max_stacks = int(max_stacks)
        self.ring_s = float(ring_s)
        self._lock = threading.Lock()
        self._table: Dict[Tuple[str, str], int] = {}
        self._ring: deque = deque(maxlen=int(ring_len))
        self._element_samples: Dict[Tuple[str, str], int] = {}
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.ticks_total = 0
        self.samples_total = 0
        self.evicted_total = 0
        self.errors_total = 0
        self.runnable_last = 0
        self.gil_waiters = 0
        #: the sampler's OWN cpu time — the deterministic overhead
        #: bound a host-profiler A/B reports beside its overhead
        self.self_cpu_s = 0.0

    # -- lifecycle -----------------------------------------------------------

    def configure(self, hz: float) -> "SamplingProfiler":
        self.hz = float(hz)
        return self

    @property
    def running(self) -> bool:
        return self._running

    def start(self) -> bool:
        """Start the sampler thread.  Refuses (returns False) when
        already running, unconfigured (hz <= 0), or the obs kill
        switch is set — under ``NNS_TPU_TORCH_OBS_DISABLE`` the profiler is
        fully inert: no thread, no registry, no export."""
        if self._running or self.hz <= 0 or _hooks.obs_disabled():
            return False
        self._running = True
        self._thread = named_thread("prof", "sampler", self._run)
        self._thread.start()
        return True

    def stop(self) -> None:
        self._running = False
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while self._running:
            c0 = time.thread_time()
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - a sampler hiccup must
                # never take the process down; it is counted instead
                self.errors_total += 1
            self.self_cpu_s += time.thread_time() - c0
            time.sleep(interval)

    # -- sampling ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        """One sampling pass over every live thread (public so tests —
        and the deep profiler — can drive it without the thread).
        Returns the number of threads sampled."""
        now = time.monotonic() if now is None else now
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        runnable = 0
        sampled = 0
        for ident, frame in frames.items():
            if ident == me:
                continue
            info = THREADS.lookup(ident)
            label = _label(info, names.get(ident, f"tid-{ident}"))
            ekey = None
            if info and info.get("pipeline") and info.get("element"):
                ekey = (info["pipeline"], info["element"])
            self._record(label, _collapse(frame), now, ekey)
            if not _is_waiting(frame):
                runnable += 1
            sampled += 1
        self.runnable_last = runnable
        # of the threads that could run, at most one holds the GIL;
        # the rest are (to first order) waiting for it
        self.gil_waiters = max(0, runnable - 1)
        self.ticks_total += 1
        return sampled

    def _record(self, label: str, stack: str, ts: float = 0.0,
                ekey: Optional[Tuple[str, str]] = None) -> None:
        with self._lock:
            key = (label, stack)
            self._table[key] = self._table.get(key, 0) + 1
            if len(self._table) > self.max_stacks:
                victim = min(self._table, key=self._table.get)
                del self._table[victim]
                self.evicted_total += 1
            self._ring.append((ts, label, stack))
            if ekey is not None:
                self._element_samples[ekey] = \
                    self._element_samples.get(ekey, 0) + 1
            self.samples_total += 1

    # -- exports -------------------------------------------------------------

    def collapsed(self) -> str:
        """The whole aggregate table as flamegraph-ready collapsed
        text: one ``label;frame;frame count`` line per distinct stack."""
        with self._lock:
            items = sorted(self._table.items())
        return "\n".join(f"{label};{stack} {n}"
                         for (label, stack), n in items)

    def ring_collapsed(self, last_s: Optional[float] = None,
                       now: Optional[float] = None) -> str:
        """Collapsed text of the last ``last_s`` (default ring_s)
        seconds only — what a flight-recorder dump embeds."""
        now = time.monotonic() if now is None else now
        cutoff = now - (self.ring_s if last_s is None else last_s)
        agg: Dict[Tuple[str, str], int] = {}
        with self._lock:
            for ts, label, stack in self._ring:
                if ts >= cutoff:
                    key = (label, stack)
                    agg[key] = agg.get(key, 0) + 1
        return "\n".join(f"{label};{stack} {n}"
                         for (label, stack), n in sorted(agg.items()))

    def chrome_trace(self) -> dict:
        """The ring as Perfetto/Chrome trace events: one lane per
        thread label (metadata-named), consecutive identical samples
        merged into one ``X`` slice of ``n / hz`` duration."""
        with self._lock:
            samples = list(self._ring)
        interval = 1.0 / self.hz if self.hz > 0 else 0.01
        by_label: Dict[str, List[Tuple[float, str]]] = {}
        for ts, label, stack in samples:
            by_label.setdefault(label, []).append((ts, stack))
        events: List[dict] = []
        for tid, label in enumerate(sorted(by_label), start=1):
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": label}})
            run_start, run_stack, run_n = None, None, 0
            for ts, stack in sorted(by_label[label]):
                if stack == run_stack:
                    run_n += 1
                    continue
                if run_stack is not None:
                    events.append(self._slice(tid, run_start, run_n,
                                              run_stack, interval))
                run_start, run_stack, run_n = ts, stack, 1
            if run_stack is not None:
                events.append(self._slice(tid, run_start, run_n,
                                          run_stack, interval))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    @staticmethod
    def _slice(tid: int, ts: float, n: int, stack: str,
               interval: float) -> dict:
        leaf = stack.rsplit(";", 1)[-1]
        return {"name": leaf, "cat": "hostprof", "ph": "X", "pid": 1,
                "tid": tid, "ts": round(ts * 1e6, 1),
                "dur": round(n * interval * 1e6, 1),
                "args": {"stack": stack, "samples": n}}

    def element_samples(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._element_samples)

    def top_stacks(self, n: int = 20) -> List[dict]:
        with self._lock:
            items = sorted(self._table.items(),
                           key=lambda kv: (-kv[1], kv[0]))[:n]
        return [{"label": label, "stack": stack, "count": cnt}
                for (label, stack), cnt in items]

    def summary(self) -> dict:
        """Cheap (no table walk) — the ``/healthz`` ``prof`` block."""
        with self._lock:
            stacks = len(self._table)
        return {
            "running": self._running, "hz": self.hz,
            "ticks": self.ticks_total, "samples": self.samples_total,
            "stacks": stacks, "evicted": self.evicted_total,
            "errors": self.errors_total,
            "gil_waiters": self.gil_waiters,
            "runnable": self.runnable_last,
            "self_cpu_s": round(self.self_cpu_s, 4),
        }

    def clear(self) -> None:
        """Tests only."""
        with self._lock:
            self._table.clear()
            self._ring.clear()
            self._element_samples.clear()
            self.ticks_total = self.samples_total = 0
            self.evicted_total = self.errors_total = 0
            self.gil_waiters = self.runnable_last = 0
            self.self_cpu_s = 0.0


PROFILER = SamplingProfiler()


# -- alert-triggered deep profiles --------------------------------------------


class DeepProfiler:
    """Bounded dense-capture episodes, triggered from watch-rule rising
    edges (``obs/watch.py`` ``_act_fire``) — the flight recorder's
    once-per-episode + rate-limit discipline, applied to profiling:
    the rising edge gives once-per-alert-episode for free, the internal
    ``min_interval_s`` bounds an alert storm, and the capture runs on
    its own short-lived thread, never the watch sampler's."""

    def __init__(self):
        self._dir: Optional[str] = None
        self.seconds = 2.0
        self.hz = 200.0
        self.min_interval_s = 30.0
        #: wrap the host episode in a ``torch.profiler`` session whose
        #: Chrome trace holds the card's kernel rows — OPT-IN
        #: (``NNS_TPU_TORCH_PROF_DEEP_DEVICE=1``): the session starts and
        #: stops inside ``utils/profile.py``'s gate, which holds every
        #: pipeline thread back for a moment, so an alert must not pay
        #: that by default
        self.device = False
        #: seconds a start or stop waits for the gate to empty
        self.quiesce_s = 5.0
        #: device sessions that could not start, stop or export, each
        #: logged; the last one's error text
        self.device_failures = 0
        self.last_device_error = ""
        #: paths of written device traces
        self.device_traces: List[str] = []
        #: seconds the gate was closed for each device start and stop
        #: (the delay a capture adds to frames in flight)
        self.gate_holds_s: List[float] = []
        self._lock = threading.Lock()
        #: the last episode's start; None before the first (a monotonic
        #: clock can read less than min_interval_s on a fresh machine)
        self._last_ts: Optional[float] = None
        self._seq = 0
        self._capturing = False
        self.episodes = 0
        self.skipped = 0
        #: paths of written collapsed-stack files (tests / tooling)
        self.captures: List[str] = []

    def arm(self, directory: str, seconds: Optional[float] = None,
            hz: Optional[float] = None,
            min_interval_s: Optional[float] = None,
            device: Optional[bool] = None) -> None:
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        if seconds is not None:
            self.seconds = float(seconds)
        if hz is not None:
            self.hz = float(hz)
        if min_interval_s is not None:
            self.min_interval_s = float(min_interval_s)
        if device is not None:
            self.device = bool(device)

    def disarm(self) -> None:
        self._dir = None

    @property
    def armed(self) -> bool:
        return self._dir is not None

    def trigger(self, reason: str) -> bool:
        """Rate-limited episode start.  Returns True when a capture
        thread was launched.  One capture at a time: a trigger while
        one runs is skipped (two ``torch.profiler`` sessions cannot
        overlap)."""
        if self._dir is None or _hooks.obs_disabled():
            return False
        with self._lock:
            now = time.monotonic()
            if self._capturing or (self._last_ts is not None and
                                   now - self._last_ts < self.min_interval_s):
                self.skipped += 1
                return False
            self._capturing = True
            self._last_ts = now
            self._seq += 1
            seq = self._seq
        self.episodes += 1
        named_thread("prof", "deep", self._capture,
                     args=(reason, seq)).start()
        return True

    def _capture(self, reason: str, seq: int) -> None:
        try:
            self._capture_episode(reason, seq)
        finally:
            with self._lock:
                self._capturing = False

    def _capture_episode(self, reason: str, seq: int) -> None:
        directory = self._dir
        if directory is None:
            return
        interval = 1.0 / max(self.hz, 1.0)
        me = threading.get_ident()
        agg: Dict[Tuple[str, str], int] = {}
        ticks = 0
        session = self._start_device_trace() if self.device else None
        t0 = time.monotonic()
        deadline = t0 + self.seconds
        while time.monotonic() < deadline:
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                info = THREADS.lookup(ident)
                key = (_label(info, f"tid-{ident}"), _collapse(frame))
                agg[key] = agg.get(key, 0) + 1
            ticks += 1
            time.sleep(interval)
        device = session is not None and self._stop_device_trace(
            session, os.path.join(directory,
                                  f"device-{seq:03d}-{reason}.json"))
        path = os.path.join(directory,
                            f"deepprof-{seq:03d}-{reason}.txt")
        lines = [f"# nns-prof deep capture: reason={reason} "
                 f"seconds={self.seconds:g} hz={self.hz:g} "
                 f"ticks={ticks} device_trace={int(device)}"]
        lines += [f"{label};{stack} {n}"
                  for (label, stack), n in sorted(agg.items())]
        try:
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            return
        with self._lock:
            self.captures.append(path)

    def _device_failed(self, what: str, err: BaseException) -> None:
        from ..utils.log import logw

        self.device_failures += 1
        self.last_device_error = f"{what}: {type(err).__name__}: {err}"
        logw("deep profiler: device trace %s", self.last_device_error)

    def _start_device_trace(self):
        """One ``torch.profiler`` session (CPU and, with a card, CUDA
        activity), started at a quiescent point; None (counted) when it
        cannot start."""
        try:
            import torch.profiler

            session = torch.profiler.profile(
                activities=_uprofile._activities())
            _uprofile.GATE.hold(session.start, self.quiesce_s)
            self.gate_holds_s.append(_uprofile.GATE.last_hold_s)
            return session
        except Exception as e:  # noqa: BLE001 - counted and logged
            self._device_failed("start", e)
            return None

    def _stop_device_trace(self, session, path: str) -> bool:
        """Stop ``session`` at a quiescent point and write its Chrome
        trace to ``path``; False (counted) on failure.  A session that
        started is always stopped: each hold that times out is counted
        and the stop tried again."""
        try:
            _uprofile.stop_when_quiescent(
                session.stop, self.quiesce_s,
                on_timeout=lambda e: self._device_failed("stop", e))
            self.gate_holds_s.append(_uprofile.GATE.last_hold_s)
            session.export_chrome_trace(path)
        except Exception as e:  # noqa: BLE001 - counted and logged
            self._device_failed("stop/export", e)
            return False
        with self._lock:
            self.device_traces.append(path)
        return True

    def clear(self) -> None:
        """Tests only."""
        with self._lock:
            self._last_ts = None
            self._seq = 0
            self.captures.clear()
            self.device_traces.clear()
            self.gate_holds_s.clear()
        self.episodes = self.skipped = 0
        self.device_failures = 0
        self.last_device_error = ""


DEEP = DeepProfiler()


def deep_trigger(reason: str) -> bool:
    """The watch-action entry point: no-op unless armed."""
    return DEEP.trigger(reason)


# -- registry / health export -------------------------------------------------


def profile_table() -> dict:
    """The snapshot-v10 ``profile`` table: exact per-element accounting
    rows (cpu/run/wait seconds + sample shares joined from the
    profiler), the top sampled stacks, and the profiler's own state."""
    rows = account_rows()
    samples = PROFILER.element_samples()
    total_samples = sum(samples.values())
    for row in rows:
        n = samples.get((row["pipeline"], row["element"]), 0)
        row["samples"] = n
        row["sample_share"] = round(n / total_samples, 4) \
            if total_samples else 0.0
        busy = row["run_s"] + row["wait_s"]
        row["wait_share"] = round(row["wait_s"] / busy, 4) if busy \
            else 0.0
    return {
        "elements": rows,
        "stacks": PROFILER.top_stacks(),
        "gil_waiters": PROFILER.gil_waiters,
        "profiler": PROFILER.summary(),
    }


def prof_health() -> dict:
    """The ``/healthz`` summary: cheap profiler + deep-capture state."""
    s = PROFILER.summary()
    s["deep_armed"] = DEEP.armed
    s["deep_episodes"] = DEEP.episodes
    s["deep_device_failures"] = DEEP.device_failures
    s["deep_gate_max_hold_s"] = round(max(DEEP.gate_holds_s, default=0.0), 6)
    return s


# -- env activation -----------------------------------------------------------

_env_checked = False


def maybe_start_from_env() -> None:
    """``NNS_TPU_TORCH_PROF=<hz>`` starts the sampler on first pipeline start
    (same activation hook as the flight recorder / watchdog);
    ``NNS_TPU_TORCH_PROF_DEEP_DIR`` arms alert-triggered deep captures
    (``NNS_TPU_TORCH_PROF_DEEP_SECONDS`` / ``_HZ`` / ``_INTERVAL`` tune the
    episode; ``NNS_TPU_TORCH_PROF_DEEP_DEVICE=1`` opts into the
    ``torch.profiler`` device trace around it).  Both strictly inert
    under ``NNS_TPU_TORCH_OBS_DISABLE``."""
    global _env_checked
    if _env_checked:
        return
    _env_checked = True
    if _hooks.obs_disabled():
        return
    from ..utils.log import logw

    hz_raw = os.environ.get("NNS_TPU_TORCH_PROF", "").strip()
    if hz_raw:
        try:
            hz = float(hz_raw)
        except ValueError:
            logw("NNS_TPU_TORCH_PROF=%r is not a sample rate (hz); profiler "
                 "not started", hz_raw)
            hz = 0.0
        if hz > 0:
            PROFILER.configure(hz).start()
    directory = os.environ.get("NNS_TPU_TORCH_PROF_DEEP_DIR", "").strip()
    if directory:
        try:
            DEEP.arm(
                directory,
                seconds=_env_float("NNS_TPU_TORCH_PROF_DEEP_SECONDS"),
                hz=_env_float("NNS_TPU_TORCH_PROF_DEEP_HZ"),
                min_interval_s=_env_float("NNS_TPU_TORCH_PROF_DEEP_INTERVAL"),
                device=os.environ.get(
                    "NNS_TPU_TORCH_PROF_DEEP_DEVICE", "").strip() == "1")
        except OSError as e:
            logw("cannot arm deep profiler on NNS_TPU_TORCH_PROF_DEEP_DIR=%s:"
                 " %s", directory, e)


def _env_float(var: str) -> Optional[float]:
    raw = os.environ.get(var, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


# -- the nns-prof CLI ---------------------------------------------------------


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="nns-torch-prof",
        description="Fetch host-execution profiles from a running "
                    "nnstreamer_tpu_torch process (the metrics server's "
                    "/prof endpoint) as flamegraph-ready collapsed "
                    "stacks or a Perfetto-loadable trace.")
    p.add_argument("--connect", metavar="HOST:PORT", default=None,
                   help="metrics endpoint to scrape; defaults to "
                        "127.0.0.1:$NNS_TPU_TORCH_METRICS_PORT, else the "
                        "in-process profiler")
    p.add_argument("--format", choices=("collapsed", "trace"),
                   default="collapsed",
                   help="collapsed-stack text (flamegraph.pl) or "
                        "Chrome/Perfetto trace JSON")
    p.add_argument("--last", type=float, default=None, metavar="S",
                   help="only the last S seconds (the profiler ring) "
                        "instead of the whole aggregate table")
    p.add_argument("--out", default=None,
                   help="write to this file instead of stdout")
    return p


def fetch_prof(connect: str, fmt: str = "collapsed",
               last_s: Optional[float] = None) -> str:
    import urllib.request

    qs = []
    if fmt == "trace":
        qs.append("format=trace")
    if last_s is not None:
        qs.append(f"last={last_s:g}")
    url = f"http://{connect}/prof" + ("?" + "&".join(qs) if qs else "")
    with urllib.request.urlopen(url, timeout=5.0) as resp:
        return resp.read().decode()


def main(argv=None, out=None) -> int:
    import json as _json

    args = build_parser().parse_args(argv)
    out = out or sys.stdout
    connect = args.connect
    if connect is None:
        port = os.environ.get("NNS_TPU_TORCH_METRICS_PORT", "").strip()
        if port:
            connect = f"127.0.0.1:{port}"
    if connect:
        try:
            text = fetch_prof(connect, args.format, args.last)
        except OSError as e:
            print(f"nns-torch-prof: cannot scrape {connect}: {e}",
                  file=sys.stderr)
            return 1
    elif args.format == "trace":
        text = _json.dumps(PROFILER.chrome_trace(), indent=1)
    elif args.last is not None:
        text = PROFILER.ring_collapsed(args.last)
    else:
        text = PROFILER.collapsed()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + ("\n" if text and not text.endswith("\n")
                            else ""))
    else:
        print(text, file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
