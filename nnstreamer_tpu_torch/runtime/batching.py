"""Dynamic micro-batching: coalesce in-flight buffers into one dispatch.

Counterpart of the JAX package's ``runtime/batching.py`` (Clipper NSDI'17,
TensorFlow Serving's batching layer): whatever requests are in flight
when the window closes are stacked along a leading batch axis and run as
ONE program call.  The window closes when

- ``max_batch`` buffers are pending (full flush, on the producer thread
  — the producer blocks for the dispatch, which is exactly the
  backpressure that keeps an upstream ``queue`` from being drained
  unboundedly ahead of the device), or
- ``timeout_s`` elapsed since the first buffer entered an empty window
  (deadline flush, on the coalescer's timer thread — bounds the latency
  a lone frame can pay for batching), or
- the element flushes explicitly (EOS/stop: partial batches drain with
  no frame loss).

Bucketed padding keeps the set of window shapes small: a partial window
of ``n`` buffers is padded up to the smallest configured bucket ``>= n``,
so the card only ever runs the model at bucket sizes.

Ordering: arrival order is preserved end to end.  Producers append
under the window condition; a flush takes the *serialization lock
first*, then the pending prefix, so two overlapping flushes (full +
deadline) emit downstream in take order even when their device work
completes out of order.

Async dispatch: ``flush_fn`` may queue device work and return with the
window's outputs still computing — elements/filter.py pushes them
downstream and fences only at sinks.  Per-stream FIFO survives
unchanged: emission order is fixed by flush-lock acquisition order at
enqueue time, and an explicit ``flush()`` (EOS/stop) still returns only
after every pending window's ``flush_fn`` call issued its work
downstream.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..chaos import hooks as _chaos
from ..obs import hooks as _hooks
from ..utils.profile import GATE


def parse_buckets(spec: str, max_batch: int) -> Tuple[int, ...]:
    """Resolve the ``batch-buckets`` property into the sorted tuple of
    padded batch sizes.  Empty spec: powers of two up to ``max_batch``.
    ``max_batch`` is always a bucket (a full window never pads); buckets
    above ``max_batch`` are rejected (they could never fill)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if str(spec or "").strip():
        out = set()
        for tok in str(spec).split(","):
            tok = tok.strip()
            if not tok:
                continue
            b = int(tok)
            if b < 1:
                raise ValueError(f"bucket {b} must be >= 1")
            if b > max_batch:
                raise ValueError(
                    f"bucket {b} exceeds batch={max_batch} (a window "
                    f"never holds more than batch buffers)")
            out.add(b)
    else:
        out = set()
        b = 1
        while b < max_batch:
            out.add(b)
            b *= 2
    out.add(max_batch)
    return tuple(sorted(out))


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` frames (buckets sorted
    ascending)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} frames exceed the largest bucket "
                     f"{buckets[-1]}")


class MicroBatcher:
    """Deadline + max-batch request coalescer.

    ``flush_fn(items)`` is invoked with 1..max_batch items, serialized
    (never concurrently) and in arrival order.  Exceptions from a
    producer-triggered (full-window) flush propagate to the producer —
    the element's ``_chain_guarded`` turns them into bus errors;
    exceptions from the timer thread go to ``error_fn``.

    ``adaptive=True`` turns on the idle-flush window (the serving-pool
    policy, runtime/serving.py): when frames are pending and NO flush is
    in flight, the timer dispatches after at most ``settle_s`` instead
    of waiting out the deadline — an idle device never sits out
    ``timeout_s``, while a busy one keeps coalescing until full/deadline
    exactly as before.  The settle interval exists so near-simultaneous
    arrivals from concurrent streams land in ONE window rather than the
    first frame stealing a dispatch all to itself; it bounds the latency
    adaptivity can add to well under the deadline.
    """

    #: adaptive idle-flush settle: how long past a window's first frame
    #: (or the previous flush completing) the timer lets concurrent
    #: arrivals pile in before an idle-device flush (never later than
    #: the deadline).  Too short and N closed-loop streams decay into
    #: stable sub-groups that each steal a dispatch; 1 ms measured best
    #: on the serve bench (both occupancy AND frames/s peak there).
    ADAPTIVE_SETTLE_S = 0.001

    def __init__(self, max_batch: int, timeout_s: float,
                 flush_fn: Callable[[List[Any]], None],
                 error_fn: Optional[Callable[[BaseException], None]] = None,
                 adaptive: bool = False, name: str = ""):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.name = name  # thread and trace label (owning element / pool)
        self.max_batch = int(max_batch)
        self.timeout_s = float(timeout_s)
        self.adaptive = bool(adaptive)
        self.settle_s = min(self.ADAPTIVE_SETTLE_S, self.timeout_s)
        self._flush_fn = flush_fn
        self._error_fn = error_fn or (lambda e: None)
        self._pending: List[Any] = []
        self._cv = threading.Condition()
        # taken BEFORE the pending prefix: flush-lock acquisition order
        # IS downstream emission order.  Also the adaptive window's
        # "device busy" signal: held exactly while a flush is in flight.
        # this lock IS the window-flush serialization; holding it
        # across the device invoke is the design (utils/lockdep.py
        # exempts the marked line at the dispatch fence)
        self._flush_serial_lock = threading.Lock()  # nns-lock: dispatch-ok
        self._deadline: Optional[float] = None
        self._last_flush_done = 0.0  # adaptive settle anchor (see below)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # introspection (tests / stats): window-close reasons
        self.flushes_full = 0
        self.flushes_deadline = 0
        self.flushes_forced = 0
        self.flushes_adaptive = 0
        # actuator seam (runtime/actuators.py "coalescing"): while
        # paused, submits park without dispatching — no inline
        # full-window flush, no timer flush.  Explicit flush()/
        # flush_stream() (EOS/stop) IGNORE the pause: frames are never
        # lost to a paused window, only delayed by one.
        self.paused = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
        # deterministic name (nns:batch:<owner>) + thread-registry
        # coverage for profiler attribution (obs/prof.py)
        from ..obs import prof as _prof

        self._thread = _prof.named_thread(
            "batch", self.name or "-", self._timer_loop)
        self._thread.start()

    def stop(self) -> None:
        """Stop the timer thread.  Does NOT flush — callers flush first
        (EOS/stop) so pending frames drain in order."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # -- producer side -------------------------------------------------------

    def submit(self, item: Any) -> None:
        """Enqueue one item; dispatches inline when the window fills."""
        tracer = _hooks.tracer
        if tracer is not None:
            tracer.batch_parked(self, item)
        with self._cv:
            self._pending.append(item)
            full = len(self._pending) >= self.max_batch \
                and not self.paused
            if self._deadline is None:
                self._deadline = time.monotonic() + self.timeout_s
                self._cv.notify_all()
        if full:
            self.flushes_full += 1
            self._drain()

    def flush(self) -> None:
        """Drain every pending item (partial batches included) — the
        EOS/stop path.  Returns once the window is empty and all
        flush_fn calls issued here completed."""
        while True:
            if self._drain() == 0:
                return
            self.flushes_forced += 1

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._pending)

    # -- actuator seam (runtime/actuators.py) --------------------------------

    def pause(self) -> None:
        """Park-only mode: submits queue, nothing dispatches until
        :meth:`resume` (or an explicit EOS/stop flush, which always
        drains).  The steering use: freeze the window while re-tuning,
        or deliberately compose a cross-stream window in tests."""
        with self._cv:
            self.paused = True

    def resume(self) -> None:
        """Leave park-only mode.  The backlog drains on the TIMER
        thread (the parked window's deadline is long expired, so it
        fires immediately; the adaptive settle paces the rest) and on
        producers' inline full-window flushes — deliberately NOT here:
        resume() is an actuation-plane call, and running dispatch +
        demux inline would let a blocked downstream wedge the caller
        (a controller tick) against the very contract the actuator
        API exists to uphold."""
        with self._cv:
            self.paused = False
            self._cv.notify_all()

    # -- flush machinery -----------------------------------------------------

    def _take_batch_locked(self) -> List[Any]:
        """Select (and remove) the next window's items from the pending
        list — FIFO prefix by default; SharedBatcher overrides this
        with earliest-deadline formation while admission control is
        armed.  Caller holds ``_cv``."""
        batch = self._pending[:self.max_batch]
        del self._pending[:len(batch)]
        return batch

    def _drain(self) -> int:
        """Take up to max_batch pending items (serialized, FIFO) and run
        flush_fn on them.  Returns the number of items flushed.  Runs
        inside the profiler's gate (``utils/profile.py``), re-entrant
        for a producer's inline drain; waiting for another thread's
        flush, or an injected stall, waits outside it."""
        GATE.enter()
        try:
            if not self._flush_serial_lock.acquire(blocking=False):
                with GATE.outside():
                    self._flush_serial_lock.acquire()
            try:
                n = self._drain_locked()
            finally:
                self._flush_serial_lock.release()
        finally:
            GATE.exit()
        if n:
            with self._cv:
                # wake the timer: the dispatch is done, so an adaptive
                # window holding frames that piled up meanwhile can
                # flush now instead of waiting out its deadline
                self._last_flush_done = time.monotonic()
                self._cv.notify_all()
        return n

    def _drain_locked(self) -> int:
        with self._cv:
            batch = self._take_batch_locked()
            self._deadline = None if not self._pending \
                else time.monotonic() + self.timeout_s
        if not batch:
            return 0
        tracer = _hooks.tracer
        if tracer is not None:
            tracer.batch_dispatch(self, batch)
        ch = _chaos.plan
        if ch is not None:
            # queue-pressure seam: an injected dispatch stall backs
            # the window up as a slow device would (it holds the
            # flush lock as a real dispatch does)
            stall = ch.queue_stall(self.name or "batch")
            if stall > 0:
                with GATE.outside():
                    time.sleep(stall)
        self._flush_fn(batch)
        return len(batch)

    def _timer_loop(self) -> None:
        while True:
            adaptive_fire = False
            with self._cv:
                while self._running:
                    if self._deadline is not None and self._pending \
                            and not self.paused:
                        target = self._deadline
                        idle = self.adaptive and \
                            not self._flush_serial_lock.locked()
                        if idle:
                            # device idle: flush after `settle_s` of
                            # gathering concurrent arrivals.  Anchored
                            # to whichever is later of the window's
                            # first frame (deadline - timeout) and the
                            # last flush completing — results demuxed
                            # at the END of a dispatch trigger the next
                            # round of closed-loop submissions, and
                            # those need the settle window to coalesce
                            # rather than the first one back stealing a
                            # dispatch to itself
                            target = min(target, max(
                                self._deadline - self.timeout_s,
                                self._last_flush_done) + self.settle_s)
                        wait = target - time.monotonic()
                        if wait <= 0:
                            adaptive_fire = idle and \
                                target < self._deadline
                            break
                        self._cv.wait(wait)
                    else:
                        self._cv.wait()
                if not self._running:
                    return
            if adaptive_fire:
                self.flushes_adaptive += 1
            else:
                self.flushes_deadline += 1
            try:
                self._drain()
            except Exception as e:  # noqa: BLE001 - timer thread has no
                # guarded caller; surface via the element's bus
                self._error_fn(e)
