"""Shared-model serving runtime: cross-pipeline batch coalescing.

Counterpart of the JAX package's ``runtime/serving.py``.  The
:class:`~nnstreamer_tpu_torch.runtime.batching.MicroBatcher` coalesces
the in-flight buffers of ONE ``tensor_filter``.  At serving scale that is
the wrong granularity: N camera streams running the same model would
mean N weight copies on the card and N windows that each dispatch
nearly-empty buckets.  Continuous-batching servers (Orca, OSDI '22) and
prediction-serving systems that share one model replica across request
streams (Clipper, NSDI '17) coalesce at the MODEL, not the element:

- :class:`ModelPool` — a process-wide table of opened sub-plugin
  instances, ref-counted and keyed by ``(framework, model, device,
  custom, forced specs, shared key)``.  N filters with
  ``share-model=true`` on the same model share ONE instance (one weight
  copy), opened by the framework's ``open_shared`` when the first
  sharer acquires the key and closed by ``close_shared`` when the last
  one releases it.
- :class:`PoolEntry` — one pooled model plus its cross-stream batcher
  and :class:`~nnstreamer_tpu_torch.utils.stats.InvokeStats`
  (dispatches, frames, and *distinct streams per dispatch*).
- :class:`SharedBatcher` — a MicroBatcher over ``(stream, buffer)``
  pairs from MANY pipelines.  Per-stream FIFO order is preserved (one
  FIFO window, serialized flushes); results are demuxed back to each
  owning filter's downstream pad on that filter's flush context (a
  broken downstream in pipeline A errors on A's bus without killing
  B's demux); per-stream EOS flushes only that stream's parked frames;
  and the **adaptive window** flushes early whenever the device is idle.

The window dispatch runs on whichever producer or timer thread closed
the window.  Every thread of the port queues its work on the default
CUDA stream, so a frame the transform made on one thread is ready for
the pool's dispatch on another without an event between them.

Frameworks without ``SUPPORTS_BATCH`` still share the instance; their
streams dispatch per frame through the element's chain.

Not in this slice: model lifecycle (hot swap, canary), the actuator
API, tenant attribution, placement over a mesh, and the tracer, chaos,
transfer-ledger and lockdep seams of the JAX package.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.device import device_key
from ..utils.stats import STAT_SAMPLE_INTERVAL, DispatchSampler, InvokeStats
from .admission import (
    AdmissionController,
    StreamPolicy,
    parse_priority,
    priority_name,
)
from .batching import MicroBatcher, parse_buckets, pick_bucket
from .events import Message, MessageKind

_log = logging.getLogger("nnstreamer_tpu_torch")

class PoolConflictError(ValueError):
    """Sharers of one pool entry disagree on pool-level settings
    (``batch`` / ``batch-timeout-ms`` / ``batch-buckets`` / ``slo-ms``
    are properties of the SHARED window, not of one element)."""


class SharedBatcher(MicroBatcher):
    """Deadline + max-batch coalescer over ``(stream, item, deadline,
    enqueue-ts)`` tuples.

    Inherits the MicroBatcher contract — serialized FIFO flushes,
    full/deadline/forced window closes — and adds per-stream draining:
    :meth:`flush_stream` dispatches windows from the head of the FIFO
    until none of one stream's frames are parked, leaving frames other
    streams parked *after* that point untouched.  Runs with the adaptive
    window on by default.

    With :attr:`edf` armed (the pool's admission controller is on),
    window formation turns earliest-deadline-first; the selection sort
    is stable and per-stream deadlines are monotonic, so per-stream FIFO
    order is preserved.
    """

    def __init__(self, max_batch: int, timeout_s: float,
                 flush_fn: Callable[[List[Any]], None],
                 error_fn: Optional[Callable[[BaseException], None]] = None,
                 adaptive: bool = True, name: str = ""):
        super().__init__(max_batch, timeout_s, flush_fn, error_fn,
                         adaptive=adaptive, name=name)
        self.edf = False  # armed by PoolEntry when admission is on

    def submit_from(self, stream: Any, item: Any,
                    deadline_s: float = 0.0,
                    enq: Optional[float] = None) -> None:
        """Enqueue one frame of ``stream``; dispatches inline when the
        cross-stream window fills.  ``deadline_s`` (relative, 0 = none)
        drives EDF formation when armed; ``enq`` (the admission entry
        time — BEFORE any backpressure wait) anchors the latency signal
        and the deadline."""
        if enq is None:
            enq = time.monotonic()
        dl = enq + deadline_s if deadline_s > 0 else float("inf")
        self.submit((stream, item, dl, enq))

    def pending_of(self, stream: Any) -> int:
        with self._cv:
            return sum(1 for it in self._pending if it[0] is stream)

    def wait_below(self, stream: Any, limit: int,
                   timeout_s: float) -> bool:
        """Block (backpressure) until ``stream`` parks fewer than
        ``limit`` frames.  False when the window never drained within
        ``timeout_s`` — a wedged device must not wedge the producer
        forever; the caller sheds visibly instead."""
        if limit <= 0:
            return True
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while sum(1 for it in self._pending
                      if it[0] is stream) >= limit:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
                self._cv.wait(min(remain, 0.05))
        return True

    def _take_batch_locked(self) -> List[Any]:
        if not self.edf or len(self._pending) <= self.max_batch:
            return super()._take_batch_locked()
        # earliest-deadline-first: pick (and order) the window by
        # (deadline, arrival index) — stable, so per-stream FIFO holds;
        # the un-picked remainder keeps its arrival order
        sel = sorted(range(len(self._pending)),
                     key=lambda i: (self._pending[i][2], i)
                     )[:self.max_batch]
        batch = [self._pending[i] for i in sel]
        chosen = set(sel)
        self._pending = [it for i, it in enumerate(self._pending)
                         if i not in chosen]
        return batch

    def flush_stream(self, stream: Any) -> None:
        """Drain windows (FIFO from the head) until no frame of
        ``stream`` is parked — the per-stream EOS/stop path.  Frames of
        other streams that arrived before this stream's last frame ride
        along (order is preserved); frames parked after it stay for
        their own window.  Returns only after any in-flight window that
        may carry this stream's frames completed."""
        while True:
            with self._cv:
                mine = any(it[0] is stream for it in self._pending)
            if not mine:
                break
            if self._drain() == 0:
                break
            self.flushes_forced += 1
        with self._flush_serial_lock:
            pass  # barrier: flushes are FIFO-serialized, so once this
            # lock is free every window taken before now has demuxed


class PoolEntry:
    """One pooled model: the shared sub-plugin instance, the attached
    streams, the cross-stream batcher, and pool-level stats."""

    def __init__(self, key: Tuple, subplugin: Any,
                 close_fn: Callable[[Any], None]):
        self.key = key
        self.subplugin = subplugin
        self._close_fn = close_fn
        self.refcount = 0  # managed by ModelPool under the pool lock
        self.stats = InvokeStats()
        self._lock = threading.Lock()
        self._streams: Dict[int, Any] = {}  # id(owner) -> owner element
        self.batcher: Optional[SharedBatcher] = None
        self.buckets: Tuple[int, ...] = (1,)
        self._batch_cfg: Optional[Tuple] = None
        # SLO-aware admission (runtime/admission.py): armed when any
        # sharer sets slo-ms > 0 (pool-level, conflict-checked like the
        # batch settings); per-stream policies keyed like _streams
        self.admission: Optional[AdmissionController] = None
        self._policies: Dict[int, StreamPolicy] = {}
        self._shed_warn_ts: Dict[int, float] = {}
        # blocking stats samples (dispatches are serialized by the
        # batcher's flush lock); the cadence is the default, tightened by
        # any attached filter's stat-sample-interval-ms (the minimum)
        self._sampler = DispatchSampler(self.stats)
        self.sample_interval = STAT_SAMPLE_INTERVAL

    # -- streams -------------------------------------------------------------

    @property
    def attached_streams(self) -> int:
        with self._lock:
            return len(self._streams)

    def attach(self, owner: Any, batch: int, timeout_ms: float,
               buckets_spec: str, slo_ms: float = 0.0,
               priority: Any = "normal", deadline_ms: float = 0.0,
               queue_limit: int = 0) -> bool:
        """Register ``owner`` as a live stream of this entry.  The first
        attach fixes the pool-level window settings (``batch*`` and
        ``slo-ms``); later attaches with different settings raise
        :class:`PoolConflictError`.  ``priority`` / ``deadline-ms`` /
        ``queue-limit`` are PER-STREAM (runtime/admission.py).  Returns
        True when the owner must submit through the shared batcher,
        False for shared-instance/per-frame dispatch (``batch<=1`` or a
        framework without ``SUPPORTS_BATCH``)."""
        batch = int(batch or 1)
        batched = batch > 1 and bool(
            getattr(self.subplugin, "SUPPORTS_BATCH", False))
        slo_ms = float(slo_ms or 0.0)
        cfg = (batch, float(timeout_ms), str(buckets_spec or "").strip(),
               slo_ms)
        policy = StreamPolicy(
            priority=parse_priority(priority),
            # EDF deadline: explicit per-stream deadline, else the pool
            # SLO (a frame older than the SLO is the one to save first)
            deadline_s=(float(deadline_ms) if float(deadline_ms or 0.0) > 0
                        else slo_ms) / 1e3,
            # bounded per-stream queue: explicit, else 16 windows' worth
            queue_limit=int(queue_limit) if int(queue_limit or 0) > 0
            else (16 * batch if slo_ms > 0 else 0))
        owner_ms = getattr(owner, "stat_sample_interval_ms", None)
        start = None
        with self._lock:
            if owner_ms is not None:
                self.sample_interval = min(self.sample_interval,
                                           float(owner_ms) / 1e3)
            if self._streams and self._batch_cfg is not None \
                    and cfg != self._batch_cfg:
                raise PoolConflictError(
                    f"{getattr(owner, 'name', owner)}: batch settings "
                    f"{cfg} conflict with the pool's {self._batch_cfg} — "
                    f"batch/batch-timeout-ms/batch-buckets/slo-ms are "
                    f"pool-level for share-model filters and must agree "
                    f"across all {len(self._streams)} sharer(s)")
            self._streams[id(owner)] = owner
            self._policies[id(owner)] = policy
            self._batch_cfg = cfg
            if slo_ms > 0 and self.admission is None:
                self.admission = AdmissionController(slo_ms / 1e3)
            if batched and self.batcher is None:
                self.buckets = parse_buckets(cfg[2], batch)
                self.batcher = SharedBatcher(
                    max_batch=batch, timeout_s=cfg[1] / 1e3,
                    flush_fn=self._dispatch, error_fn=self._error_all,
                    name=f"pool:{self.key[0]}")
                self.batcher.edf = slo_ms > 0
                start = self.batcher
            n = len(self._streams)
        self.stats.attached_streams = n
        if start is not None:
            start.start()
        return batched

    def detach(self, owner: Any) -> None:
        """Unregister one stream: flush ITS parked frames first (no
        frame loss on a mid-stream stop), then — if it was the last
        stream out — drain and tear the batcher down so a later
        attach can bring new window settings."""
        with self._lock:
            present = self._streams.pop(id(owner), None) is not None
            self._policies.pop(id(owner), None)
            self._shed_warn_ts.pop(id(owner), None)
            batcher = self.batcher
            n = len(self._streams)
            last = not self._streams
            if last:
                self.batcher = None
                self._batch_cfg = None
                self.admission = None
        self.stats.attached_streams = n
        if batcher is None:
            return
        if present and not last:
            batcher.flush_stream(owner)
        elif last:
            batcher.flush()  # nothing can be parked but a survivor's
            # tail; drain everything before the timer dies
            batcher.stop()

    def flush_stream(self, owner: Any) -> None:
        """Per-stream EOS: dispatch this stream's parked frames (other
        streams' windows are untouched past that point)."""
        with self._lock:
            batcher = self.batcher
        if batcher is not None:
            batcher.flush_stream(owner)

    def submit(self, owner: Any, buf: Any) -> None:
        with self._lock:
            batcher = self.batcher
            adm = self.admission
            pol = self._policies.get(id(owner))
        if batcher is None:
            raise RuntimeError(
                f"{getattr(owner, 'name', owner)}: stream is not "
                f"attached to a shared batcher (start() not run?)")
        enq = time.monotonic()
        if adm is not None and pol is not None:
            if not adm.admit(pol.priority):
                # p99 over SLO and this stream is sheddable: dropped at
                # the cheapest point — before any queueing — and LOUDLY
                self._warn_shed(owner, pol, adm, reason="slo")
                return
            if pol.queue_limit > 0 and not batcher.wait_below(
                    owner, pol.queue_limit,
                    timeout_s=max(1.0, 8 * batcher.timeout_s)):
                # bounded queue never drained (wedged device): shed
                # rather than wedge the producer thread forever
                adm.count_queue_full(pol.priority)
                self._warn_shed(owner, pol, adm, reason="queue-full")
                return
        batcher.submit_from(owner, buf,
                            deadline_s=pol.deadline_s if pol else 0.0,
                            enq=enq)

    def _warn_shed(self, owner: Any, pol: StreamPolicy,
                   adm: AdmissionController, reason: str) -> None:
        """Every shed is counted; the bus warning is rate-limited to
        one per stream per second (it carries the cumulative count, so
        nothing is lost — the bus just isn't flooded under overload)."""
        now = time.monotonic()
        with self._lock:
            last = self._shed_warn_ts.get(id(owner), 0.0)
            if now - last < 1.0:
                return
            self._shed_warn_ts[id(owner)] = now
        total = adm.total_shed
        owner.post_message(Message(
            MessageKind.WARNING, getattr(owner, "name", str(owner)),
            data={"shed": True, "reason": reason,
                  "priority": priority_name(pol.priority),
                  "pool": f"{self.key[0]}", "total_shed": total}))
        _log.warning("%s: load-shedding %s-priority frames (%s; %d shed so "
                     "far on this pool)", getattr(owner, "name", owner),
                     priority_name(pol.priority), reason, total)

    # -- the cross-stream dispatch -------------------------------------------

    def _dispatch(self, items: List[Tuple[Any, Any, float, float]]
                  ) -> None:
        """Window flush: ONE invoke for frames from every attached
        stream, then demux each result back to its owner's downstream
        pad.  Serialized by the batcher (never concurrent); items are
        ``(owner, buf, deadline, enqueue-ts)`` in window order (arrival
        order, or EDF order under admission control)."""
        sp = self.subplugin
        owners: Dict[int, List[Any]] = {}
        for owner, _buf, _dl, _enq in items:
            owners.setdefault(id(owner), [owner, 0])[1] += 1
        sample, t0 = self._sampler.begin(self.sample_interval)
        bucket = len(items)
        try:
            # frame prep inside the guard: items already left the
            # pending queue, so ANY failure from here on loses the
            # window and must surface on every owner's bus
            frames = [owner._pool_frame_inputs(buf)
                      for owner, buf, _dl, _enq in items]
            t1 = time.monotonic()  # host-prep done, device phase begins
            if getattr(sp, "SUPPORTS_BATCH", False):
                bucket = pick_bucket(len(frames), self.buckets)
                outs = sp.invoke_batched(frames, bucket)
            else:
                outs = [sp.invoke(list(f)) for f in frames]
        except Exception as e:  # noqa: BLE001 - a failed shared window
            # affects EVERY stream that parked a frame in it: the error
            # must land on each owner's bus, not only on whichever
            # producer happened to trigger the flush
            for owner, _n in owners.values():
                owner.post_error(e)
            return
        t2 = self._sampler.end([o for out in outs for o in out], t0, sample,
                               frames=len(items), streams=len(owners))
        for owner, n in owners.values():
            owner.invoke_stats.count(frames=n)
        adm = self.admission
        done = time.monotonic()
        for (owner, buf, _dl, enq), out in zip(items, outs):
            if adm is not None:
                # the admission controller's latency signal: window
                # park → results demuxed
                adm.observe(done - enq)
            try:
                # the owner's flush context: push through ITS pads, so
                # a broken downstream errors on ITS bus only
                owner._pool_emit(buf, out)
            except Exception as e:  # noqa: BLE001 - keep demuxing the
                # other streams' frames of this window
                owner.post_error(e)
        if sample:
            # cost attribution: host-prep (t0→t1) / device (t1→t2) /
            # host-drain (t2→now: per-owner demux)
            self.stats.record_phases(t1 - t0, t2 - t1,
                                     time.monotonic() - t2)

    def _error_all(self, err: BaseException) -> None:
        with self._lock:
            owners = list(self._streams.values())
        for o in owners:  # post outside the lock: bus handlers reenter
            o.post_error(err)

    # -- teardown (pool-internal) --------------------------------------------

    def _close(self) -> None:
        batcher, self.batcher = self.batcher, None
        self.admission = None
        if batcher is not None:
            batcher.flush()
            batcher.stop()
        self._close_fn(self.subplugin)


class ModelPool:
    """Process-wide ref-counted table of opened sub-plugin instances.

    ``acquire`` returns the existing entry for a key (refcount+1) or
    opens a new one via ``open_fn``; ``release`` closes the instance
    when the last reference drops.  Keys must carry everything that
    makes two opens non-interchangeable — :func:`pool_key` builds them
    from FilterProps.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple, PoolEntry] = {}

    def acquire(self, key: Tuple, open_fn: Callable[[], Any],
                close_fn: Callable[[Any], None]) -> PoolEntry:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = PoolEntry(key, open_fn(), close_fn)
                self._entries[key] = entry
            entry.refcount += 1
            return entry

    def release(self, entry: PoolEntry) -> None:
        close = False
        with self._lock:
            entry.refcount -= 1
            if entry.refcount <= 0:
                self._entries.pop(entry.key, None)
                close = True
        if close:
            entry._close()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        """Drop every entry regardless of refcount (test teardown)."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e._close()


def pool_key(framework: str, props: Any) -> Tuple:
    """Build the ModelPool key from a framework name + FilterProps:
    everything that makes two opens non-interchangeable (model identity,
    device, custom options, forced I/O specs, shared key).  Non-string
    models (callables, ModelDef) key by object identity — two filters
    share only when handed the very same object."""
    model = props.model
    mkey = model if isinstance(model, str) else f"obj:{id(model)}"
    return (str(framework), mkey,
            device_key(props.accelerator, props.device),
            str(props.custom or ""),
            str(props.input_spec or ""), str(props.output_spec or ""),
            str(props.shared_key or ""))


#: the process-wide pool `tensor_filter share-model=true` attaches to
MODEL_POOL = ModelPool()
