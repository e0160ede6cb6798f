"""Host↔device transfer ledger — byte-exact data-movement accounting.

Counterpart of the JAX package's ``obs/transfer.py``.  Every host→device
and device→host crossing at the port's seams records into the
process-wide :data:`LEDGER`:

- ``Tensor.torch(device)`` uploads and ``Tensor.np()`` drains
  (``core/buffer.py``), and ``Tensor.tobytes()`` of a card tensor;
- the decoders' packed drain (``decoders/__init__.py`` ``drain_once``) and
  ``image_labeling``'s per-frame (index, score) pair;
- the filter's input placement and its weights' placement at configure
  (``filters/torch_cuda.py``), and a window stacked on the host and copied
  once;
- ``tensor_if``'s scalar verdict (``.item()``).

Only crossings between the host and a CUDA device count: a CPU tensor
crosses nothing (:func:`on_card`; the tests widen :data:`CARD_TYPES` to
exercise the seams on the CPU).

Rows are keyed ``(pipeline, source, direction, reason)``, ``direction``
``h2d``/``d2h``/``d2d`` and ``reason`` one of
``input``/``weights``/``drain``/``pad``/``handoff``; the labels come from a
thread-local context the runtime pushes around each element chain,
micro-batch flush and pool dispatch.  Counts and bytes are EXACT.

**Seconds.**  A device→host copy on the card first waits for every kernel
queued before it.  The ledger times the copy ALONE: a drain records CUDA
events on either side of the copy and its row's seconds are the device
time between them; the wait for earlier work is not in the figure (the
JAX rows time the conversion, wait included).  Uploads are timed on the
host around the call that stages them.

Exported by the metrics registry at scrape time:
``nns_transfer_bytes_total`` / ``nns_transfer_count_total`` counters and
``nns_transfer_seconds`` histograms, the snapshot's ``transfers`` table,
and — for sampled buffers — Chrome-trace ``xfer`` sub-spans.  The ledger
obeys the global kill switch (``NNS_TPU_TORCH_OBS_DISABLE``) and
:func:`set_enabled`.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

from . import hooks as _hooks

#: crossing directions and reasons (the label vocabulary); ``d2d`` is
#: the cross-stage HBM handoff (never a host crossing), ``handoff``
#: its reason tag
DIRECTIONS = ("h2d", "d2h", "d2d")
REASONS = ("input", "weights", "drain", "pad", "handoff")

#: transfer duration histogram bounds (seconds): sub-µs copies up to
#: multi-second weight placements
TRANSFER_SECONDS_BUCKETS = (1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5,
                            1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                            .01, .025, .05, .1, .25, 1.0, float("inf"))

#: fast-path flag every recording site reads first (one attribute load
#: + branch, same cost class as the tracer hook); honors the global
#: obs kill switch at process start
ACTIVE = not _hooks.DISABLED


def set_enabled(flag: bool) -> None:
    """Programmatic on/off (A/B runs, tests).  The env kill switch
    (``NNS_TPU_TORCH_OBS_DISABLE``) wins: it cannot be re-enabled at
    runtime — the hot paths were told at startup the whole obs layer
    is off."""
    global ACTIVE
    ACTIVE = bool(flag) and not _hooks.DISABLED


class _Row:
    """One (pipeline, source, direction, reason) series: exact count
    and bytes plus a duration histogram (guarded by the ledger lock)."""

    __slots__ = ("count", "bytes", "seconds", "buckets")

    def __init__(self):
        self.count = 0
        self.bytes = 0
        self.seconds = 0.0
        self.buckets = [0] * len(TRANSFER_SECONDS_BUCKETS)


class TransferLedger:
    """Process-wide, thread-safe table of host↔device crossings."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[Tuple[str, str, str, str], _Row] = {}

    def record(self, direction: str, reason: str, nbytes: int,
               seconds: float = 0.0, source: Optional[str] = None,
               pipeline: Optional[str] = None) -> None:
        """Count one crossing.  ``source``/``pipeline`` default to the
        thread-local context the runtime pushed (empty outside any
        element).  ``seconds=0`` marks a transfer counted but not
        separately timed."""
        ctx = getattr(_TLS, "ctx", None)
        if pipeline is None:
            pipeline = ctx[0] if ctx is not None else ""
        if source is None:
            source = ctx[1] if ctx is not None else ""
        key = (pipeline, source, direction, reason)
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                row = self._rows[key] = _Row()
            row.count += 1
            row.bytes += nbytes
            row.seconds += seconds
            row.buckets[bisect_left(TRANSFER_SECONDS_BUCKETS,
                                    seconds)] += 1
        if ctx is not None and ctx[2]:
            # sampled buffers in flight: the crossing renders as a
            # Chrome-trace `xfer` sub-span inside the owning element's
            # residency span (obs/tracer.py chrome_trace)
            t_end = time.monotonic()
            span = (t_end - float(seconds), float(seconds), str(source),
                    direction, reason, int(nbytes))
            for tr in ctx[2]:
                tr.setdefault("xfers", []).append(span)

    # -- pull side -----------------------------------------------------------

    def snapshot(self) -> List[dict]:
        """Rows for the registry's ``transfers`` table (v4), sorted."""
        with self._lock:
            return [{"pipeline": pl, "source": src, "direction": d,
                     "reason": r, "count": row.count,
                     "bytes": row.bytes, "seconds": row.seconds,
                     "buckets": list(row.buckets)}
                    for (pl, src, d, r), row
                    in sorted(self._rows.items())]

    def totals(self, pipeline: Optional[str] = None,
               direction: Optional[str] = None,
               reason: Optional[str] = None) -> Tuple[int, int]:
        """(count, bytes) summed over rows matching the given labels —
        the bench/test accounting helper."""
        count = nbytes = 0
        with self._lock:
            for (pl, _src, d, r), row in self._rows.items():
                if pipeline is not None and pl != pipeline:
                    continue
                if direction is not None and d != direction:
                    continue
                if reason is not None and r != reason:
                    continue
                count += row.count
                nbytes += row.bytes
        return count, nbytes

    def clear(self) -> None:
        """Tests/bench only: drop every row."""
        with self._lock:
            self._rows.clear()


#: the process-wide ledger every recording seam feeds
LEDGER = TransferLedger()

_TLS = threading.local()


def push_context(pipeline: str, source: str,
                 traces: Optional[tuple] = None):
    """Install the transfer-label context for the current thread
    (returns the previous context for :func:`pop_context`).  ``traces``
    optionally carries the trace dicts of sampled buffers in flight so
    crossings render as Chrome-trace sub-spans."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (pipeline, source, traces)
    return prev


def pop_context(prev) -> None:
    _TLS.ctx = prev


def record(direction: str, reason: str, nbytes: int,
           seconds: float = 0.0, source: Optional[str] = None,
           pipeline: Optional[str] = None) -> None:
    """Module-level recording shim: no-op unless :data:`ACTIVE`."""
    if not ACTIVE:
        return
    LEDGER.record(direction, reason, nbytes, seconds,
                  source=source, pipeline=pipeline)


#: device types a crossing is counted for (the tests add "cpu" to
#: exercise the seams without a card)
CARD_TYPES = ("cuda",)


def on_card(t) -> bool:
    """Whether a ``torch.Tensor`` (or a ``torch.device``) lives on a card
    whose crossings the ledger counts."""
    dev = getattr(t, "device", t)
    kind = dev.split(":")[0] if isinstance(dev, str) \
        else getattr(dev, "type", None)
    return kind in CARD_TYPES


def _drain(t, copy, nbytes: int, reason: str):
    """Run ``copy()`` — a device→host copy of ``t`` — with the crossing
    recorded: ``nbytes`` exact, and on a CUDA tensor the copy alone timed
    between CUDA events (see the module doc)."""
    if t.is_cuda:
        import torch

        with torch.cuda.device(t.device):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = copy()
            e1.record()
            e1.synchronize()
        secs = e0.elapsed_time(e1) / 1e3
    else:
        t0 = time.perf_counter()
        out = copy()
        secs = time.perf_counter() - t0
    LEDGER.record("d2h", reason, nbytes, secs)
    return out


def to_host(t, reason: str = "drain"):
    """``t.cpu()`` with the crossing recorded when ``t`` is on a card."""
    if not ACTIVE or not on_card(t):
        return t.cpu()
    return _drain(t, t.cpu, t.numel() * t.element_size(), reason)


def item(t, reason: str = "drain"):
    """``t.item()`` of a one-element tensor, the scalar's copy recorded
    when ``t`` is on a card."""
    if not ACTIVE or not on_card(t):
        return t.item()
    return _drain(t, t.item, t.element_size(), reason)


def to_device(t, device, reason: str = "input"):
    """``t.to(device)`` for a tensor in host memory (a numpy array's
    tensor), the upload recorded when ``device`` is on a card
    (host-timed around the call that stages the copy)."""
    if not ACTIVE or not on_card(device):
        return t.to(device)
    t0 = time.perf_counter()
    out = t.to(device)
    LEDGER.record("h2d", reason, t.numel() * t.element_size(),
                  time.perf_counter() - t0)
    return out


def move(t, device, reason: str = "input"):
    """``t.to(device)`` with the host crossing it makes recorded: an
    upload (:func:`to_device`), a drain (:func:`to_host`), or none (a
    copy between cards, or on the host)."""
    if on_card(t) == on_card(device):
        return t.to(device)
    if on_card(t):
        return to_host(t, "drain").to(device)
    return to_device(t, device, reason)


def params_nbytes(params: Any) -> int:
    """Total payload bytes of a weight tree (tensors, ``nn.Module``s,
    numpy arrays, and dicts/lists/tuples of them)."""
    if hasattr(params, "parameters") and hasattr(params, "buffers"):
        return sum(int(p.numel() * p.element_size())
                   for p in list(params.parameters())
                   + list(params.buffers()))
    if isinstance(params, dict):
        return sum(params_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_nbytes(v) for v in params)
    if hasattr(params, "element_size") and hasattr(params, "numel"):
        return int(params.numel() * params.element_size())
    return int(getattr(params, "nbytes", 0) or 0)
