"""Per-buffer latency tracer + Chrome trace-event exporter.

Counterpart of the JAX package's ``obs/tracer.py`` (the GstTracer
latency-tracer analog): hook points compiled into the runtime
(``runtime/element.py`` pre/post chain, ``elements/basic.py`` queue in/out,
``runtime/batching.py`` park/dispatch, the filter's and the pool's invoke
split and demux) feed a :class:`LatencyTracer` attached through
``obs.hooks.attach``.  Each *sampled* buffer (1-in-N, decided once at the
source) carries a small trace dict in ``Buffer.meta`` that collects
``(timestamp, element, phase)`` marks as the buffer flows; elements that
copy ``meta`` forward keep the trace alive across buffer rewrites.  When
the buffer is done at a sink the tracer folds the marks into one record:

- **end-to-end latency** — source timestamp to sink completion;
- **per-element residency** — the end-to-end interval partitioned at the
  ``chain-in`` marks, so residencies sum exactly to the end-to-end
  latency: an element's residency covers its own chain *plus* any time
  the buffer sat parked behind it before the next element touched it.

**Completion on the card.**  PyTorch launches CUDA work asynchronously, so
a buffer reaches a sink while its kernels may still be queued.  The sink
records a CUDA event behind each buffer and fences depth-1
(``runtime/element.py`` ``SinkElement``).  A sampled buffer that carries
such an event is therefore NOT closed when the sink's chain returns: its
record closes when the sink's fence on that event returns (the next
buffer, or EOS), with a ``device-done`` mark taken on the host after the
event fired.  The mark is the record's end, so the sink's residency
covers the wait and the partition stays exact, and the end-to-end
latency is never shorter than the device work of the frame's window.
A window dispatch that recorded CUDA events around its work
(:meth:`LatencyTracer.device_window`) leaves its device time, read from
those events, in the record as ``device_window_s``.  Buffers without a
card event (host or CPU tensors) close at the sink's chain-out, as in
the JAX package.

Export: :meth:`LatencyTracer.chrome_trace` renders the records as Chrome
trace-event JSON (``{"traceEvents": [...]}``, Perfetto loadable): one
lane per sampled frame, the frame span with the element residency spans
and the finer queue/batch sub-phase spans nested inside it.

Overhead: with no tracer attached every hook site is one module-global
read and an ``is None`` branch.  With a tracer attached, unsampled
buffers pay one dict lookup per hook site.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List

#: Buffer.meta key carrying a sampled buffer's trace state.  The dict is
#: shared by reference across buffer rewrites that copy ``meta``.
TRACE_META_KEY = "_nns_trace"

#: mark phases (the hook vocabulary)
PH_SOURCE = "source"        # buffer created at a source element
PH_CHAIN_IN = "chain-in"    # entering an element's chain()
PH_CHAIN_OUT = "chain-out"  # chain() returned
PH_QUEUE_IN = "queue-in"    # parked in a queue (thread boundary)
PH_QUEUE_OUT = "queue-out"  # taken by the queue's streaming thread
PH_PARK = "park"            # parked in a coalescing batch window
PH_DISPATCH = "dispatch"    # the window holding this buffer flushed
PH_DEMUX = "demux"          # dispatch result pushed back downstream
#: dispatch cost-attribution sub-phases (sampled dispatches only):
#: prep -> dev -> drain are consecutive block_until_ready-fenced
#: boundaries of ONE invoke; `done` closes the drain span on the
#: single-frame chain path (batched paths close it at PH_DEMUX)
PH_INV_PREP = "invoke-prep"    # host-prep began (input gather/place)
PH_INV_DEV = "invoke-device"   # dispatch issued (device phase began)
PH_INV_DRAIN = "invoke-drain"  # device done (host-drain began)
PH_INV_DONE = "invoke-done"    # outputs wrapped (chain path only)
#: the sink's fence on the buffer's CUDA completion event returned
PH_DEVICE_DONE = "device-done"
#: trace-dict key set by a sink that defers the record to its fence
FENCE_PENDING = "fence_pending"


def _item_buf(batcher, item):
    """A MicroBatcher item is the buffer itself; a SharedBatcher item
    is ``(owner-element, buffer, deadline, enqueue-ts)``.  Returns
    ``(element-name, buffer)``."""
    if isinstance(item, tuple) and len(item) >= 2:
        owner, buf = item[0], item[1]
        return getattr(owner, "name", str(owner)), buf
    return getattr(batcher, "name", "") or "batch", item


class LatencyTracer:
    """Collects per-buffer latency records from the runtime hooks.

    ``sample_every=N`` traces one in every N source buffers (per
    process, across all sources) — tracing every buffer is fine for
    tests and short diagnostics, 1-in-100 keeps a hot pipeline honest.
    Records are kept up to ``max_records`` (further samples count into
    :attr:`dropped` instead of growing without bound).

    Use as a context manager, or call :meth:`install` /
    :meth:`uninstall` explicitly::

        with LatencyTracer(sample_every=10) as tr:
            run_pipeline()
        tr.save_chrome_trace("trace.json")
    """

    def __init__(self, sample_every: int = 1, max_records: int = 4096):
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = int(sample_every)
        self.max_records = int(max_records)
        self.dropped = 0
        self._lock = threading.Lock()
        self._seen = 0       # source buffers observed (sampling counter)
        self._sampled = 0    # trace ids handed out
        self._records: List[dict] = []
        # sink-side depth-1 fence accounting (runtime/element.py
        # SinkElement): how often a sink had to WAIT on the previous
        # window's device work, and for how long.  An annotation, not a
        # residency phase — the fence belongs to the NEXT buffer's
        # chain span, so the residency-sum==e2e partition is untouched.
        self._fence_waits = 0
        self._fence_wait_s = 0.0
        # process-unique prefix so trace ids stay distinct across the
        # hosts of a distributed pipeline (and across tracer restarts)
        self._id_prefix = os.urandom(4).hex()

    # -- attach/detach -------------------------------------------------------

    def install(self) -> "LatencyTracer":
        from . import hooks

        hooks.attach(self)
        return self

    def uninstall(self) -> None:
        from . import hooks

        if hooks.tracer is self:
            hooks.detach()

    def __enter__(self) -> "LatencyTracer":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- hook API (called from the runtime when attached) --------------------

    def source_created(self, element, buf) -> None:
        """Sampling decision: 1-in-N buffers get a trace dict planted in
        ``meta``; the rest flow untouched (every later hook is then a
        single failed dict lookup for them).  A buffer that already
        carries a trace (a remote-origin one planted by
        tensor_query_serversrc / edgesrc from a propagated context,
        ``obs.tracectx``) keeps it — it neither re-samples nor counts
        against the local sampling budget."""
        if TRACE_META_KEY in buf.meta:
            return
        with self._lock:
            self._seen += 1
            if (self._seen - 1) % self.sample_every:
                return
            self._sampled += 1
            idx = self._sampled
        buf.meta[TRACE_META_KEY] = {
            "frame": idx,
            "id": f"{self._id_prefix}-{idx}",
            "pts": buf.pts,
            "marks": [(time.monotonic(), element.name, PH_SOURCE)],
        }

    def pre_chain(self, element, buf) -> None:
        tr = buf.meta.get(TRACE_META_KEY)
        if tr is None:
            return
        now = time.monotonic()
        tr["marks"].append((now, element.name, PH_CHAIN_IN))
        # payload-residency tagging at the element boundary: every
        # host<->device flip counts as one crossing, the per-frame
        # figure the transfer ledger's per-pipeline rates aggregate
        # (Buffer.residency, obs/transfer.py)
        res = getattr(buf, "residency", None)
        if res is None:
            return
        last = tr.get("res")
        if last is not None and res != last:
            tr["crossings"] = tr.get("crossings", 0) + 1
            tr.setdefault("res_marks", []).append(
                (now, element.name, f"{last}->{res}"))
        tr["res"] = res

    def post_chain(self, element, buf) -> None:
        tr = buf.meta.get(TRACE_META_KEY)
        if tr is None:
            return
        tr["marks"].append((time.monotonic(), element.name, PH_CHAIN_OUT))
        if element.sinkpads and not element.srcpads \
                and not tr.get(FENCE_PENDING):
            self._finalize(tr)

    def queue_enqueued(self, element, buf) -> None:
        self._mark(buf, element.name, PH_QUEUE_IN)

    def queue_dequeued(self, element, buf) -> None:
        self._mark(buf, element.name, PH_QUEUE_OUT)

    def batch_parked(self, batcher, item) -> None:
        name, buf = _item_buf(batcher, item)
        self._mark(buf, name, PH_PARK)

    def batch_dispatch(self, batcher, items) -> None:
        now = time.monotonic()
        for item in items:
            name, buf = _item_buf(batcher, item)
            tr = buf.meta.get(TRACE_META_KEY)
            if tr is not None:
                tr["marks"].append((now, name, PH_DISPATCH))

    def batch_demuxed(self, element, buf) -> None:
        self._mark(buf, element.name, PH_DEMUX)

    def sink_fenced(self, element, waited_s: float, traces=()) -> None:
        """A sink's depth-1 fence blocked ``waited_s`` on the previous
        buffer's CUDA event (0 when the card had already finished — the
        steady state whenever the host is the bottleneck).  ``traces``
        are the trace dicts that buffer's record was deferred for: each
        gets its ``device-done`` mark now, after the event fired, and
        closes."""
        with self._lock:
            self._fence_waits += 1
            self._fence_wait_s += float(waited_s)
        if not traces:
            return
        now = time.monotonic()
        for tr in traces:
            tr["marks"].append((now, element.name, PH_DEVICE_DONE))
            self._finalize(tr)

    def device_window(self, bufs, start, end) -> None:
        """A window dispatch recorded CUDA events ``start``/``end`` around
        its device work: each traced buffer it carried keeps them, and its
        record reads the window's device time from them when it closes
        (by then the sink's fence has passed a later event, so both have
        fired)."""
        for buf in bufs:
            tr = buf.meta.get(TRACE_META_KEY)
            if tr is not None:
                tr["window_events"] = (start, end)

    def invoke_split(self, name_bufs, t0: float, t1: float, t2: float,
                     t3: float = None) -> None:
        """One sampled dispatch's host/device phase boundaries, fanned
        onto every traced buffer it carried.  ``name_bufs`` is an
        iterable of ``(element-name, buffer)``; t0/t1/t2 are the
        prep-start / device-start / drain-start fences and the optional
        ``t3`` closes the drain span (single-frame chain — batched
        paths leave it to each buffer's own demux mark, so the drain
        span ends when THAT buffer was demuxed).  Called BEFORE the
        results push downstream: a sink reached inline during the push
        finalizes the record, and marks appended after that are
        lost."""
        for name, buf in name_bufs:
            tr = buf.meta.get(TRACE_META_KEY)
            if tr is None:
                continue
            marks = tr["marks"]
            marks.append((t0, name, PH_INV_PREP))
            marks.append((t1, name, PH_INV_DEV))
            marks.append((t2, name, PH_INV_DRAIN))
            if t3 is not None:
                marks.append((t3, name, PH_INV_DONE))

    def _mark(self, buf, name: str, phase: str) -> None:
        tr = buf.meta.get(TRACE_META_KEY)
        if tr is not None:
            tr["marks"].append((time.monotonic(), name, phase))

    # -- record assembly -----------------------------------------------------

    def _finalize(self, tr: dict) -> None:
        # fan-out pipelines (tee) push ONE buffer object into several
        # branches that share this trace dict: only the first sink to
        # complete closes the record (later branches' marks are a
        # best-effort tail the record no longer includes).  The
        # check-then-set runs under the tracer lock — two branch
        # streaming threads reaching their sinks concurrently must not
        # both see "not done"
        with self._lock:
            if tr.get("done"):
                return
            tr["done"] = True
        marks = tr["marks"]
        t0 = marks[0][0]
        t_end = marks[-1][0]
        # Partition [t0, t_end] at the element entry marks: an element
        # owns the buffer from the moment it (or the source that made
        # it) first touched it until the NEXT element first touches it.
        # The pieces cover the interval exactly, so residencies sum to
        # the end-to-end latency by construction.
        entries = [(t, name) for t, name, phase in marks
                   if phase in (PH_SOURCE, PH_CHAIN_IN)]
        residency: Dict[str, float] = {}
        for i, (t, name) in enumerate(entries):
            nxt = entries[i + 1][0] if i + 1 < len(entries) else t_end
            residency[name] = residency.get(name, 0.0) + (nxt - t)
        record = {
            "frame": tr["frame"],
            "id": tr.get("id"),
            "pts": tr.get("pts"),
            "t0": t0,
            "end": t_end,
            "e2e_s": t_end - t0,
            "residency_s": residency,
            "marks": list(marks),
            # data-movement view (obs/transfer.py): host<->device
            # residency flips this frame paid, and the ledger-recorded
            # crossings that happened while it was sampled
            "crossings": tr.get("crossings", 0),
            "res_marks": list(tr.get("res_marks", ())),
            "xfers": list(tr.get("xfers", ())),
        }
        if tr.get("origin"):
            record["origin"] = tr["origin"]
        if tr.get("remote"):
            # cross-device hops absorbed into this trace (obs.tracectx):
            # remote marks are already mapped onto the local timeline
            record["remote"] = [dict(e) for e in tr["remote"]]
        ev = tr.get("window_events")
        if ev is not None:
            try:
                record["device_window_s"] = ev[0].elapsed_time(ev[1]) / 1e3
            except RuntimeError:
                pass  # an event not yet fired: the figure is left out
        with self._lock:
            if len(self._records) >= self.max_records:
                self.dropped += 1
            else:
                self._records.append(record)

    # -- results -------------------------------------------------------------

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def summary(self) -> dict:
        """Aggregate view: count + e2e latency distribution (seconds).

        ``started`` counts traces planted at sources; ``started`` well
        above ``count`` (+ in-flight frames) means traces are being
        LOST mid-pipeline — an element on the path rebuilds buffers
        without forwarding ``meta`` (e.g. tensor_converter's raw-media
        path, mux/aggregate), so the trace never reaches a sink."""
        recs = self.records()
        with self._lock:
            started = self._sampled
            fences = self._fence_waits
            fence_s = self._fence_wait_s
        if not recs:
            return {"count": 0, "started": started,
                    "dropped": self.dropped,
                    "sink_fence_waits": fences,
                    "sink_fence_wait_s": fence_s}
        lats = sorted(r["e2e_s"] for r in recs)
        n = len(lats)
        return {
            "count": n,
            "started": started,
            "dropped": self.dropped,
            "e2e_mean_s": sum(lats) / n,
            "e2e_p50_s": lats[n // 2],
            "e2e_p99_s": lats[min(n - 1, (n * 99) // 100)],
            # mean host<->device residency flips per sampled frame
            "crossings_per_frame":
                sum(r.get("crossings", 0) for r in recs) / n,
            # sink-side async-fence pressure: waits > 0 with meaningful
            # wait time means the device, not the host, paces the
            # pipeline (the depth-1 fence is providing backpressure)
            "sink_fence_waits": fences,
            "sink_fence_wait_s": fence_s,
        }

    # -- Chrome trace export -------------------------------------------------

    def chrome_trace(self, include_remote_origin: bool = False) -> dict:
        """The records as Chrome trace-event JSON: one ``tid`` lane per
        sampled frame, the frame span outermost, element residency spans
        and queue/batch sub-phase spans nested inside it.  Loadable by
        Perfetto / ``chrome://tracing``; complements (does not replace)
        ``torch.profiler`` device traces, which cannot see this host-side
        time.

        Traces that crossed a device boundary render as ONE merged
        timeline: each absorbed remote hop contributes a network span
        (``<link>:net``, send → receipt on the local clock) with the
        remote host's element spans nested inside it, placed via the
        per-exchange clock offset (``obs.tracectx``) — so the requesting
        element's residency = remote residency + true network RTT, on
        one clock.  ``include_remote_origin=True`` additionally renders
        records this process finalized *on behalf of a remote
        requester* (a query server's own view); they are excluded by
        default since the requester's merged trace already nests them."""
        events: List[dict] = []
        for rec in self.records():
            if rec.get("origin") == "remote" and not include_remote_origin:
                continue
            tid = rec["frame"]
            t0 = rec["t0"]
            events.append({
                "name": f"frame {rec['frame']}",
                "cat": "frame", "ph": "X", "pid": 1, "tid": tid,
                "ts": t0 * 1e6, "dur": rec["e2e_s"] * 1e6,
                "args": {"pts": rec["pts"], "id": rec.get("id"),
                         "e2e_ms": rec["e2e_s"] * 1e3},
            })
            marks = rec["marks"]
            entries = [(t, name) for t, name, phase in marks
                       if phase in (PH_SOURCE, PH_CHAIN_IN)]
            for i, (t, name) in enumerate(entries):
                nxt = entries[i + 1][0] if i + 1 < len(entries) \
                    else rec["end"]
                events.append({
                    "name": name, "cat": "element", "ph": "X",
                    "pid": 1, "tid": tid,
                    "ts": t * 1e6, "dur": (nxt - t) * 1e6,
                })
            events.extend(self._subphase_events(marks, tid))
            events.extend(self._xfer_events(rec, tid))
            for hop in rec.get("remote", ()):
                events.extend(self._remote_events(hop, tid))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    @staticmethod
    def _xfer_events(rec: dict, tid) -> List[dict]:
        """Data-movement sub-spans: every ledger-recorded crossing this
        sampled frame's context saw (``<source>:<h2d|d2h>:<reason>``
        spans nested inside the owning element's residency span) and an
        instant mark per residency flip at an element boundary."""
        events: List[dict] = []
        for t0x, dur, source, direction, reason, nbytes in \
                rec.get("xfers", ()):
            events.append({
                "name": f"{source}:{direction}:{reason}", "cat": "xfer",
                "ph": "X", "pid": 1, "tid": tid,
                "ts": t0x * 1e6, "dur": max(dur, 0.0) * 1e6,
                "args": {"bytes": nbytes},
            })
        for t, name, flip in rec.get("res_marks", ()):
            events.append({
                "name": f"{name}:residency {flip}", "cat": "xfer",
                "ph": "i", "s": "t", "pid": 1, "tid": tid,
                "ts": t * 1e6,
            })
        return events

    @staticmethod
    def _remote_events(hop: dict, tid) -> List[dict]:
        """One absorbed hop: the network span on the local clock, the
        remote host's element residency spans (offset-mapped marks,
        bounded by the remote send time ``t3``) and its sub-phases,
        names prefixed with the remote host tag."""
        events: List[dict] = []
        host = hop.get("host", "?")
        t_out, t_in = hop["t_out"], hop["t_in"]
        events.append({
            "name": f"{hop.get('link', 'edge')}:net", "cat": "net",
            "ph": "X", "pid": 1, "tid": tid,
            "ts": t_out * 1e6, "dur": (t_in - t_out) * 1e6,
            "args": {"host": host,
                     "rtt_ms": hop["rtt_s"] * 1e3
                     if hop.get("rtt_s") is not None else None,
                     "offset_ms": hop.get("offset_s", 0.0) * 1e3},
        })
        marks = [tuple(m) for m in hop.get("marks", ())]
        end = hop.get("t3", t_in)
        entries = [(t, name) for t, name, phase in marks
                   if phase in (PH_SOURCE, PH_CHAIN_IN)]
        for i, (t, name) in enumerate(entries):
            nxt = entries[i + 1][0] if i + 1 < len(entries) else end
            events.append({
                "name": f"{host}/{name}", "cat": "element", "ph": "X",
                "pid": 1, "tid": tid,
                "ts": t * 1e6, "dur": (nxt - t) * 1e6,
            })
        for ev in LatencyTracer._subphase_events(marks, tid):
            ev["name"] = f"{host}/{ev['name']}"
            events.append(ev)
        return events

    #: sub-phase span grammar: phases that OPEN a span, and for each
    #: closing phase the (opener, span label) pairs it closes.  A phase
    #: may both close one span and open the next (PH_DISPATCH,
    #: PH_INV_DEV); PH_DEMUX closes both the dispatch span and — for
    #: batched paths, where the drain runs per-buffer — the invoke
    #: drain span (the chain path closes it with PH_INV_DONE instead).
    _SPAN_OPENERS = (PH_QUEUE_IN, PH_PARK, PH_DISPATCH,
                     PH_INV_PREP, PH_INV_DEV, PH_INV_DRAIN)
    _SPAN_CLOSERS = {
        PH_QUEUE_OUT: ((PH_QUEUE_IN, "queued"),),
        PH_DISPATCH: ((PH_PARK, "parked"),),
        PH_DEMUX: ((PH_DISPATCH, "dispatch"),
                   (PH_INV_DRAIN, "host-drain")),
        PH_INV_DEV: ((PH_INV_PREP, "host-prep"),),
        PH_INV_DRAIN: ((PH_INV_DEV, "device"),),
        PH_INV_DONE: ((PH_INV_DRAIN, "host-drain"),),
    }

    @staticmethod
    def _subphase_events(marks, tid) -> List[dict]:
        """Queue residency (queue-in → queue-out), batch-window wait
        (park → dispatch → demux) and the dispatch cost-attribution
        split (host-prep → device → host-drain) as finer spans nested
        inside the owning element's residency span."""
        events: List[dict] = []
        open_at: Dict[tuple, float] = {}
        for t, name, phase in marks:
            if phase in LatencyTracer._SPAN_OPENERS:
                open_at[(name, phase)] = t
            for opener, label in LatencyTracer._SPAN_CLOSERS.get(
                    phase, ()):
                t_open = open_at.pop((name, opener), None)
                if t_open is not None:
                    events.append({
                        "name": f"{name}:{label}", "cat": "phase",
                        "ph": "X", "pid": 1, "tid": tid,
                        "ts": t_open * 1e6, "dur": (t - t_open) * 1e6,
                    })
        return events

    def save_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    save = save_chrome_trace


def trace_pipeline(sample_every: int = 1,
                   max_records: int = 4096) -> LatencyTracer:
    """Convenience: build AND attach a tracer in one call (detach with
    ``tracer.uninstall()`` or use :class:`LatencyTracer` as a context
    manager)."""
    return LatencyTracer(sample_every=sample_every,
                         max_records=max_records).install()
