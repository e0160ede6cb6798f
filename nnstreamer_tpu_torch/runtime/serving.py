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
  instances, ref-counted and keyed by ``(framework, model, placement,
  custom, forced specs, shared key)``; the placement is the CANONICAL
  key of ``parallel.Placement`` (``mesh=data:-1`` and ``mesh=data:8`` on
  8 devices join one pool), and one model opened under two provably
  different mesh placements raises :class:`PoolConflictError` (disjoint
  ``devices=`` stage subsets may coexist).  N filters with
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

Model lifecycle (``runtime/lifecycle.py``): :attr:`PoolEntry.lifecycle`
is built on first use; :meth:`PoolEntry.reload_model` stages a new
version off the dispatch path and flips it in at a window boundary, or
canaries it on 1-in-N streams when the pool declares ``canary=``.  A
window then partitions by version and each part dispatches through its
own instance at its own bucket.

Observability and faults (``obs/``, ``chaos/``): a window dispatch runs
under the transfer ledger's pool label; the process-wide chaos plan's
invoke faults apply inside the window's error guard (a ``fail-invoke``
reaches every owner's bus); a sampled dispatch feeds its host-prep /
device / host-drain split to the registry's ``nns_invoke_*`` histograms
and the tracer, and its device time to the per-tenant split
(``obs/tenantstat.py``, the ``tenant=`` stream property); the admission
controller reads its p99 from the registry's histogram; a hard shed
triggers the flight recorder.

Control (``runtime/actuators.py``, ``utils/lockdep.py``,
``obs/prof.py``): :meth:`PoolEntry.actuators` gives the pool's named,
bounded, reversible knobs (a ``max-batch`` actuation checks the fold of
every bucket the new window can reach before the window may grow onto
it); a window flush is the lock witness's dispatch fence; and each
dispatch cycle is split into CPU, card wait and neither for the host
profiler.

Mesh-native pools: :attr:`PoolEntry.placement` is the pooled instance's
resolved placement — the window divisibility rule, the shard count the
obs layer attributes against and the multi-process fan-out all read it;
the window stacks once and dispatches sharded (filters/torch_cuda.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..chaos import hooks as _chaos
from ..obs import hooks as _obs_hooks
from ..obs import prof as _prof
from ..obs import tenantstat as _tenantstat
from ..obs import transfer as _xfer
from ..obs.tracer import TRACE_META_KEY
from ..utils import lockdep as _lockdep
from ..utils.device import device_key, parse_accel_kind
from ..utils.profile import GATE
from ..utils.stats import STAT_SAMPLE_INTERVAL, DispatchSampler, InvokeStats
from .admission import (
    INGRESS_TS_META,
    AdmissionController,
    StreamPolicy,
    _controller_armed,
    _controller_disarmed,
    parse_priority,
    priority_name,
)
from .batching import MicroBatcher, parse_buckets, pick_bucket
from .events import Message, MessageKind
from .lifecycle import parse_canary

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
            if sum(1 for it in self._pending if it[0] is stream) < limit:
                return True
        # the window drains on another thread: wait outside the
        # profiler's gate (utils/profile.py)
        with GATE.outside(), self._cv:
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

    #: the host profiler's account of this pool's dispatch cycles
    #: (``obs/prof.py``); None under the obs kill switch
    _dispatch_acct = None

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
        # id(owner) -> tenant, read lock-free on the dispatch path
        # (rebuilt only under self._lock)
        self._tenants: Dict[int, str] = {}
        self._shed_warn_ts: Dict[int, float] = {}
        #: seconds of sleep the chaos plan's slow-invoke faults injected
        self.chaos_sleep_s = 0.0
        # blocking stats samples (dispatches are serialized by the
        # batcher's flush lock); the cadence is the default, tightened by
        # any attached filter's stat-sample-interval-ms (the minimum)
        self._sampler = DispatchSampler(self.stats, self.label())
        self.sample_interval = STAT_SAMPLE_INTERVAL
        # model lifecycle (runtime/lifecycle.py), built on first use: a
        # pool that never swaps pays nothing for it
        self._lifecycle = None
        # actuator set (runtime/actuators.py), built lazily and kept
        # (cooldown and revert state persist across discoveries)
        self._actuators: Dict[str, Any] = {}
        self._dispatch_acct = _prof.dispatch_account(self.label())

    # -- streams -------------------------------------------------------------

    @property
    def attached_streams(self) -> int:
        with self._lock:
            return len(self._streams)

    def stream_ids(self) -> List[int]:
        with self._lock:
            return list(self._streams)

    @property
    def placement(self):
        """The resolved placement (``parallel.ResolvedPlacement``) the
        pooled sub-plugin runs over; None on a single-device pool."""
        return getattr(self.subplugin, "_placement", None)

    def label(self) -> str:
        """Short pool label: ``framework:model-tail``."""
        model = str(self.key[1])
        return f"{self.key[0]}:{model.rsplit('/', 1)[-1]}"

    # -- model lifecycle (runtime/lifecycle.py) ------------------------------

    @property
    def lifecycle(self):
        """The entry's version registry and swap/canary state machine."""
        with self._lock:
            if self._lifecycle is None:
                from .lifecycle import VersionManager

                self._lifecycle = VersionManager(self)
            return self._lifecycle

    def subplugin_for(self, owner: Any) -> Any:
        """The instance serving ``owner``'s per-frame dispatches: the
        canary shadow for a canary-routed stream, else the shared one
        (a batched window partitions instead, see :meth:`_dispatch`)."""
        lc = self._lifecycle
        if lc is not None and lc.canary_active:
            return lc.subplugin_for(owner)
        return self.subplugin

    def reload_model(self, model: Any, version: str = "") -> dict:
        """RELOAD_MODEL on a share-model pool: stage the replacement off
        the dispatch path, then start the declared canary (``canary=``)
        or swap at the next window boundary.  A concrete declared tag
        (``canary=v7:1/N``) canaries only that version; ``next`` canaries
        whatever is staged."""
        lc = self.lifecycle
        ver = lc.stage(model, version=version)
        tag, n = lc.default_canary
        if n >= 2 and (tag in ("", "next") or ver.tag == tag):
            return lc.start_canary(n, ver)
        return lc.swap(ver)

    def _serve_hist(self):
        """The registry's per-pool serve-latency histogram the admission
        controller feeds AND reads its p99 from."""
        from ..obs.metrics import admission_latency_hist

        return admission_latency_hist(self.label())

    def attach(self, owner: Any, batch: int, timeout_ms: float,
               buckets_spec: str, slo_ms: float = 0.0,
               priority: Any = "normal", deadline_ms: float = 0.0,
               queue_limit: int = 0, canary: str = "",
               tenant: str = "") -> bool:
        """Register ``owner`` as a live stream of this entry.  The first
        attach fixes the pool-level window settings (``batch*``,
        ``slo-ms`` and the ``canary=`` declaration, validated by
        ``lifecycle.parse_canary``); later attaches with different
        settings raise
        :class:`PoolConflictError`.  ``priority`` / ``deadline-ms`` /
        ``queue-limit`` / ``tenant`` are PER-STREAM (runtime/admission.py;
        the tenant names who the stream's frames are billed to,
        obs/tenantstat.py).  Returns
        True when the owner must submit through the shared batcher,
        False for shared-instance/per-frame dispatch (``batch<=1`` or a
        framework without ``SUPPORTS_BATCH``)."""
        batch = int(batch or 1)
        batched = batch > 1 and bool(
            getattr(self.subplugin, "SUPPORTS_BATCH", False))
        slo_ms = float(slo_ms or 0.0)
        canary = str(canary or "").strip()
        canary_cfg = parse_canary(canary)  # validates the grammar
        cfg = (batch, float(timeout_ms), str(buckets_spec or "").strip(),
               slo_ms, canary)
        policy = StreamPolicy(
            tenant=str(tenant or "").strip() or _tenantstat.DEFAULT_TENANT,
            priority=parse_priority(priority),
            # EDF deadline: explicit per-stream deadline, else the pool
            # SLO (a frame older than the SLO is the one to save first)
            deadline_s=(float(deadline_ms) if float(deadline_ms or 0.0) > 0
                        else slo_ms) / 1e3,
            # bounded per-stream queue: explicit, else 16 windows' worth
            queue_limit=int(queue_limit) if int(queue_limit or 0) > 0
            else (16 * batch if slo_ms > 0 else 0))
        owner_ms = getattr(owner, "stat_sample_interval_ms", None)
        mn = getattr(self.subplugin, "model_name", None)
        if callable(mn):
            # obs join key: the pool's nns_invoke_device_seconds series
            # measures this model's programs (obs/xlacost.py)
            from ..obs import xlacost as _xlacost

            _xlacost.map_source(self.label(), mn())
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
                    f"batch/batch-timeout-ms/batch-buckets/slo-ms/canary "
                    f"are "
                    f"pool-level for share-model filters and must agree "
                    f"across all {len(self._streams)} sharer(s)")
            self._streams[id(owner)] = owner
            self._policies[id(owner)] = policy
            self._tenants = {**self._tenants, id(owner): policy.tenant}
            self._batch_cfg = cfg
            if slo_ms > 0 and self.admission is None:
                self.admission = AdmissionController(
                    slo_ms / 1e3, hist=self._serve_hist())
                _controller_armed()  # sources start stamping ingress
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
        if canary_cfg[1] >= 2:
            # reloads stage and canary at this split instead of cutting
            # the whole pool over
            self.lifecycle.default_canary = canary_cfg
        lc = self._lifecycle
        if lc is not None:
            lc.on_attach(owner)
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
            self._tenants = {k: v for k, v in self._tenants.items()
                             if k != id(owner)}
            self._shed_warn_ts.pop(id(owner), None)
            batcher = self.batcher
            n = len(self._streams)
            last = not self._streams
            if last:
                self.batcher = None
                self._batch_cfg = None
                if self.admission is not None:
                    self.admission = None
                    _controller_disarmed()
        self.stats.attached_streams = n
        lc = self._lifecycle
        if lc is not None:
            lc.on_detach(owner)
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
        # deadline and latency anchor: the buffer's pipeline-ingress stamp
        # when present (an overload backlog waits upstream of this call,
        # in the queue elements), else now (a buffer pushed before the
        # controller armed)
        enq = time.monotonic()
        if adm is not None and pol is not None:
            t_in = buf.meta.get(INGRESS_TS_META)
            if t_in is not None:
                enq = t_in
            if not adm.admit(pol.priority):
                # p99 over SLO and this stream is sheddable: dropped at
                # the cheapest point — before any queueing — and LOUDLY
                _tenantstat.record_shed(self.label(), pol.tenant, "slo")
                self._warn_shed(owner, pol, adm, reason="slo")
                return
            if pol.queue_limit > 0 and not batcher.wait_below(
                    owner, pol.queue_limit,
                    timeout_s=max(1.0, 8 * batcher.timeout_s)):
                # bounded queue never drained (wedged device): shed
                # rather than wedge the producer thread forever
                adm.count_queue_full(pol.priority)
                _tenantstat.record_shed(self.label(), pol.tenant,
                                        "queue-full")
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
        # black box: every (rate-limited) shed episode is noted; the shed
        # ramp saturating at 1.0 is the hard-shed trigger of a dump
        from ..obs.flightrec import FLIGHT

        FLIGHT.shed(self.label(), priority_name(pol.priority), reason,
                    total, hard=adm.shed_probability >= 1.0)

    # -- the actuator API (runtime/actuators.py) ------------------------------

    def _live_batcher(self) -> SharedBatcher:
        from .actuators import ActuationError

        b = self.batcher
        if b is None:
            raise ActuationError(
                f"{self.label()}: no live cross-stream window "
                f"(no batched stream attached, or the pool is "
                f"tearing down)")
        return b

    def _live_admission(self) -> Any:
        from .actuators import ActuationError

        adm = self.admission
        if adm is None:
            raise ActuationError(
                f"{self.label()}: no admission controller armed "
                f"(no sharer set slo-ms)")
        return adm

    def actuators(self) -> Dict[str, Any]:
        """The pool's named, bounded, reversible knobs: window
        deadline, window size, coalescing pause, admission shed ramp,
        per-stream queue limits.  Built once per entry (cooldown and
        revert state persist); every knob reads its target through the
        entry, so an actuation racing ``Pipeline.stop()`` raises a
        clean ``ActuationError`` instead of steering a dead window."""
        with self._lock:
            acts = self._actuators
        if acts:
            # the window bound follows the live bucket set (a pool
            # re-attached with new settings keeps its knobs' cooldown/
            # revert state but must clamp against the NEW ceiling)
            acts["max-batch"].hi = float(self.buckets[-1])
            return acts
        from .actuators import Actuator

        label = self.label()

        def _set_window_ms(v: float) -> None:
            b = self._live_batcher()
            b.timeout_s = v / 1e3
            b.settle_s = min(b.settle_s, b.timeout_s)

        def _window_cfg():
            # snapshot BOTH knobs the setter touches: settle_s only
            # ever shrinks under _set_window_ms, so a scalar prior
            # could not restore it and "revert restores the exact
            # prior config" would silently lie
            b = self._live_batcher()
            return (b.timeout_s, b.settle_s)

        def _restore_window(prior) -> None:
            b = self._live_batcher()
            b.timeout_s, b.settle_s = prior

        def _set_max_batch(v: float) -> None:
            b = self._live_batcher()
            n = int(round(v))
            # every bucket a window of <= n frames can land on gets its
            # fold checked HERE, on the actuating thread, before the
            # window may grow onto it: a dispatch never runs an
            # unchecked fold, and never pays for a check
            self._check_buckets(
                [k for k in self.buckets if k <= pick_bucket(n, self.buckets)])
            b.max_batch = n

        def _set_coalescing(v: float) -> None:
            b = self._live_batcher()
            if v >= 0.5:
                b.resume()
            else:
                b.pause()

        def _queue_limits() -> Dict[int, int]:
            with self._lock:
                return {sid: pol.queue_limit
                        for sid, pol in self._policies.items()}

        def _set_queue_limit(v: float) -> None:
            self._live_admission()  # queue limits are an admission knob
            with self._lock:
                for pol in self._policies.values():
                    pol.queue_limit = int(round(v))

        def _restore_queue_limits(prior: Dict[int, int]) -> None:
            # exact per-stream restore; streams that detached since the
            # snapshot are simply gone (their policy died with them)
            with self._lock:
                for sid, pol in self._policies.items():
                    if sid in prior:
                        pol.queue_limit = prior[sid]

        # max-batch upper bound: the LARGEST configured bucket — every
        # window size up to it pads onto a configured bucket; growing
        # past it would need a bucket the pool never declared
        built = {
            "window-ms": Actuator(
                "window-ms", "pool", label,
                get_fn=lambda: self._live_batcher().timeout_s * 1e3,
                set_fn=_set_window_ms, lo=0.1, hi=1000.0, unit="ms",
                snapshot_fn=_window_cfg, restore_fn=_restore_window),
            "max-batch": Actuator(
                "max-batch", "pool", label,
                get_fn=lambda: float(self._live_batcher().max_batch),
                set_fn=_set_max_batch, lo=1.0,
                hi=float(self.buckets[-1]), unit="frames"),
            "coalescing": Actuator(
                "coalescing", "pool", label,
                get_fn=lambda: 0.0 if self._live_batcher().paused
                else 1.0,
                set_fn=_set_coalescing, lo=0.0, hi=1.0, unit="on"),
            "ramp-start": Actuator(
                "ramp-start", "pool", label,
                get_fn=lambda: self._live_admission().ramp_start,
                set_fn=lambda v: self._live_admission()
                .set_ramp_start(v),
                lo=0.3, hi=0.99, unit="xSLO"),
            "queue-limit": Actuator(
                "queue-limit", "pool", label,
                get_fn=lambda: float(max(
                    _queue_limits().values(), default=0)),
                set_fn=_set_queue_limit, lo=1.0, hi=65536.0,
                unit="frames", snapshot_fn=_queue_limits,
                restore_fn=_restore_queue_limits),
        }
        with self._lock:
            # two concurrent first builds must converge on ONE set —
            # split sets would split the cooldown/revert state the
            # module promises to persist
            if not self._actuators:
                self._actuators = built
            return self._actuators

    def _check_buckets(self, buckets: List[int]) -> None:
        """Take the fold verdict of every bucket in ``buckets`` that has
        none yet, off the dispatch path (the serving instance and a
        canary's shadow both): seeded frames of the serving schema run
        once a window at each such bucket (``TorchCudaFilter``
        ``check_buckets``).  A framework that keeps no verdicts has
        nothing to check."""
        from ..filters.api import FilterError
        from .actuators import ActuationError

        instances = [self.subplugin]
        lc = self._lifecycle
        if lc is not None and lc.canary_active:
            instances.append(lc._canary.subplugin)
        for sp in instances:
            check = getattr(sp, "check_buckets", None)
            if check is not None:
                try:
                    check(buckets)
                except FilterError as e:
                    # the instance closed under the actuation: stop()
                    # won the race, a clean actuation failure
                    raise ActuationError(f"{self.label()}: {e}") from e

    # -- the cross-stream dispatch -------------------------------------------

    def _dispatch(self, items: List[Tuple[Any, Any, float, float]]
                  ) -> None:
        """Window flush: frames from every attached stream, then each
        result demuxed back to its owner's downstream pad.  Serialized by
        the batcher (never concurrent); items are ``(owner, buf, deadline,
        enqueue-ts)`` in window order (arrival order, or EDF order under
        admission control).  Once the lifecycle is engaged the window
        partitions by version (every stream maps to one version, so
        per-stream FIFO survives) and each part dispatches through its
        version's instance."""
        # lockdep fence: a window flush is a device-dispatch point — a
        # thread that reaches it holding any witnessed lock stalls
        # every pooled stream for the invoke (utils/lockdep.py)
        if _lockdep.ENABLED:
            _lockdep.check_dispatch(f"pool:{self.label()}")
        # the dispatch cycle's CPU / card-wait split (obs/prof.py)
        acct = self._dispatch_acct
        clocks = acct.begin() if acct is not None else None
        # transfer-label context: the dispatch runs on whichever producer
        # or timer thread closed the window; its crossings belong to the
        # POOL, not to that thread's element
        xctx = None
        pushed = _xfer.ACTIVE
        if pushed:
            traces = tuple(
                tr for tr in (buf.meta.get(TRACE_META_KEY)
                              for _o, buf, _dl, _enq in items)
                if tr is not None) or None
            xctx = _xfer.push_context("", self.label(), traces)
        try:
            self._dispatch_inner(items)
        finally:
            if pushed:
                _xfer.pop_context(xctx)
            if clocks is not None:
                acct.end(clocks)

    def _dispatch_inner(self, items: List[Tuple[Any, Any, float, float]]
                        ) -> None:
        lc = self._lifecycle
        if lc is None:
            self._dispatch_group(items, self.subplugin, None)
            return
        for ver, sp, part in lc.partition(items):
            self._dispatch_group(part, sp, ver)

    def _dispatch_group(self, items: List[Tuple[Any, Any, float, float]],
                        sp: Any, version: Any) -> None:
        """Dispatch one version-homogeneous group through ``sp`` at the
        smallest bucket that holds it: invoke, donation marks, per-owner
        demux, stats.  A failure errors this group's owners only and
        counts against ``version`` (a ``lifecycle.ModelVersion``)."""
        owners: Dict[int, List[Any]] = {}
        for owner, _buf, _dl, _enq in items:
            owners.setdefault(id(owner), [owner, 0])[1] += 1
        sample, t0 = self._sampler.begin(self.sample_interval)
        bucket = len(items)
        tracer = _obs_hooks.tracer
        try:
            ch = _chaos.plan
            if ch is not None:
                # model-path fault seam: slow-invoke sleeps here (the
                # whole window pays, like a device stall); fail-invoke
                # raises into this guard, so every owner's bus gets it
                self._chaos_invoke(ch)
            # frame prep inside the guard: items already left the
            # pending queue, so ANY failure from here on loses the
            # window and must surface on every owner's bus
            frames = [owner._pool_frame_inputs(buf)
                      for owner, buf, _dl, _enq in items]
            t1 = time.monotonic()  # host-prep done, device phase begins
            ev = self._window_start(tracer, items, sp)
            if getattr(sp, "SUPPORTS_BATCH", False):
                bucket = pick_bucket(len(frames), self.buckets)
                outs = sp.invoke_batched(frames, bucket)
            else:
                outs = [sp.invoke(list(f)) for f in frames]
            if ev is not None:
                self._window_end(tracer, items, ev)
        except Exception as e:  # noqa: BLE001 - a failed shared window
            # affects EVERY stream that parked a frame in it: the error
            # must land on each owner's bus, not only on whichever
            # producer happened to trigger the flush
            if version is not None:
                self._lifecycle.record_error(version)
            for owner, _n in owners.values():
                owner.post_error(e)
            return
        if getattr(sp, "_donate", False):
            # custom=donate: the dispatch consumed the tensors it was
            # handed — exactly the input-combination subset of each frame
            for owner, buf, _dl, _enq in items:
                owner._mark_donated(buf)
        t2 = self._sampler.end([o for out in outs for o in out], t0, sample,
                               frames=len(items), streams=len(owners))
        if version is not None:
            self._lifecycle.record(version, (t2 - t0) if sample else None,
                                   frames=len(items), streams=len(owners),
                                   bucket=bucket)
        for owner, n in owners.values():
            owner.invoke_stats.count(frames=n)
        if sample and tracer is not None:
            # marks BEFORE the demux (a sink reached inline closes the
            # record); each buffer's demux mark closes its drain span
            tracer.invoke_split(
                [(getattr(owner, "name", str(owner)), buf)
                 for owner, buf, _dl, _enq in items], t0, t1, t2)
        adm = self.admission
        done = time.monotonic()
        tstats = _tenantstat.ACTIVE
        label = self.label()
        tenants = self._tenants
        for (owner, buf, _dl, enq), out in zip(items, outs):
            if adm is not None:
                # the admission controller's latency signal: window
                # park → results demuxed
                lat = done - enq
                adm.observe(lat)
                if tstats:
                    # per-tenant SLO attainment, graded on the SAME
                    # per-frame latency the shed decision reads
                    _tenantstat.record_latency(
                        label, tenants.get(id(owner), "default"), lat,
                        adm.slo_s)
            try:
                # the owner's flush context: push through ITS pads, so
                # a broken downstream errors on ITS bus only
                owner._pool_emit(buf, out)
            except Exception as e:  # noqa: BLE001 - keep demuxing the
                # other streams' frames of this window
                owner.post_error(e)
        if sample:
            # cost attribution: host-prep (t0→t1) / device (t1→t2) /
            # host-drain (t2→t3: per-owner demux) into the pool stats and
            # the registry's nns_invoke_* histograms
            from ..obs.metrics import observe_invoke_phases

            t3 = time.monotonic()
            self.stats.record_phases(t1 - t0, t2 - t1, t3 - t2)
            observe_invoke_phases("pool", label, bucket, t1 - t0, t2 - t1,
                                  t3 - t2)
        if tstats:
            # tenant attribution: this window's device phase split by
            # useful-frame occupancy, from the SAME t1/t2 clock reads the
            # histogram observed; an unsampled dispatch counts frames only
            tenant_frames: Dict[str, int] = {}
            for owner, n in owners.values():
                t = tenants.get(id(owner), "default")
                tenant_frames[t] = tenant_frames.get(t, 0) + n
            _tenantstat.record_window(
                label, tenant_frames,
                round((t2 - t1) * 1e9) if sample else None)

    def _chaos_invoke(self, plan: Any) -> None:
        """Apply the plan's invoke fault for this pool; a slow-invoke's
        sleep is added to :attr:`chaos_sleep_s`."""
        from ..chaos.plan import apply_invoke_fault

        fault = apply_invoke_fault(plan, f"pool:{self.key[0]}:{self.key[1]}")
        if fault is not None:
            self.chaos_sleep_s += fault[1]

    @staticmethod
    def _window_start(tracer: Any, items: List[Any], sp: Any):
        """With a tracer attached and a traced frame in a window on the
        card: a CUDA event recorded ahead of the window's device work."""
        if tracer is None or not any(
                TRACE_META_KEY in buf.meta for _o, buf, _dl, _enq in items):
            return None
        dev = getattr(sp, "device", None)
        if dev is None or getattr(dev, "type", "") != "cuda":
            return None
        import torch

        with torch.cuda.device(dev):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return ev, dev

    @staticmethod
    def _window_end(tracer: Any, items: List[Any], start) -> None:
        import torch

        ev, dev = start
        with torch.cuda.device(dev):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        tracer.device_window([buf for _o, buf, _dl, _enq in items], ev,
                             end)

    def _error_all(self, err: BaseException) -> None:
        with self._lock:
            owners = list(self._streams.values())
        for o in owners:  # post outside the lock: bus handlers reenter
            o.post_error(err)

    # -- teardown (pool-internal) --------------------------------------------

    def _close(self) -> None:
        batcher, self.batcher = self.batcher, None
        if self.admission is not None:
            # torn down without a last detach
            self.admission = None
            _controller_disarmed()
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
                self._check_placement(key)
                entry = PoolEntry(key, open_fn(), close_fn)
                self._entries[key] = entry
            entry.refcount += 1
            return entry

    def _check_placement(self, key: Tuple) -> None:
        """Same model, DIFFERENT mesh placement: a second pool would
        silently defeat the sharing the filter asked for (two weight
        copies, two windows) — the pool-level conflict it is.  Only
        mesh-keyed placements conflict: a ``raw`` key is an unresolvable
        spec whose own configure error must surface, two ``device`` keys
        differ legitimately, and disjoint ``devices=`` subsets are the
        pipeline split (one pool per stage).  Equivalent spellings never
        get here: they share one canonical key.  Caller holds the lock."""
        base, pk = _key_base(key), _key_placement(key)
        for other in self._entries.values():
            ok = _key_placement(other.key)
            kinds = {p[0] if isinstance(p, tuple) and p else "?"
                     for p in (pk, ok)}
            if "raw" in kinds or "mesh" not in kinds:
                continue
            if len(other.key) == len(key) and _key_base(other.key) == base \
                    and ok != pk and not _disjoint_mesh_subsets(pk, ok):
                raise PoolConflictError(
                    f"share-model filters disagree on placement for "
                    f"{key[0]}:{key[1]}: this open resolves to {pk!r} but "
                    f"a live pool of the same model runs {ok!r} — "
                    f"placement (mesh/sharding/devices/accelerator) is "
                    f"pool-level for sharing filters; align the "
                    f"properties, or stop the other sharers before "
                    f"re-placing the model")

    def get(self, key: Tuple) -> Optional[PoolEntry]:
        with self._lock:
            return self._entries.get(key)

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

    def entries(self) -> List[PoolEntry]:
        """The live entries, a copy taken under the pool lock."""
        with self._lock:
            return list(self._entries.values())

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
    placement, custom options, forced I/O specs, shared key).  Non-string
    models (callables, ModelDef) key by object identity — two filters
    share only when handed the very same object.

    The placement is ``("device", <device>)`` without ``mesh=``, else the
    CANONICAL key of ``parallel.Placement``: equivalent spellings
    (``mesh=data:-1`` vs ``mesh=data:8`` on 8 devices, ``sharding=dp``
    vs ``replicated``, ``accelerator=gpu`` vs ``true:cuda``) join ONE
    pool."""
    from ..parallel import Placement

    model = props.model
    mkey = model if isinstance(model, str) else f"obj:{id(model)}"
    pl = Placement.from_props(props)
    if pl.is_null:
        where = ("device", device_key(props.accelerator, props.device))
    else:
        kind = parse_accel_kind(props.accelerator) or (
            props.device.type if props.device is not None else "cuda")
        where = pl.key(kind)
    return (str(framework), mkey, where,
            str(props.custom or ""),
            str(props.input_spec or ""), str(props.output_spec or ""),
            str(props.shared_key or ""))


def _disjoint_mesh_subsets(a, b) -> bool:
    """Two canonical mesh keys (``("mesh", platform, axes, device-ids,
    rules)``) name non-overlapping device subsets — the coexistence the
    pipeline split runs on.  False for any shared device (or malformed
    keys), which keeps the conflict error."""
    try:
        ida, idb = set(a[3]), set(b[3])
    except Exception:  # noqa: BLE001 - malformed/foreign key: conflict
        return False
    return bool(ida) and bool(idb) and not (ida & idb)


def _key_placement(key: Tuple):
    """The placement component of a :func:`pool_key` tuple."""
    return key[2] if len(key) > 2 else None


def _key_base(key: Tuple) -> Tuple:
    """A :func:`pool_key` tuple with the placement removed — the model
    identity two conflicting placements collide on."""
    return key[:2] + key[3:]


#: the process-wide pool `tensor_filter share-model=true` attaches to
MODEL_POOL = ModelPool()
