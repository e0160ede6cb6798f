"""Deterministic fault injection: the seeded :class:`FaultPlan`.

Counterpart of the JAX package's ``chaos/plan.py``: the same grammar, the
same seeded RNG consulted in the same event order, so one spec and one
sequence of events make the same decisions in both packages.  A plan is
a seeded RNG plus a list of :class:`FaultSpec` clauses; three seams
consult it:

- **invoke** — the model dispatch (``runtime/serving.py`` pool dispatch
  and the ``tensor_filter`` chain/micro-batch paths) asks
  :meth:`FaultPlan.invoke_fault` for ``slow-invoke`` (added latency) /
  ``fail-invoke`` (a raised :class:`ChaosInvokeError`);
- **queue** — the batching window (``runtime/batching.py``) asks
  :meth:`FaultPlan.queue_stall` for an artificial dispatch stall, which
  shows up upstream as queue pressure;
- **wire** — the edge transports (:mod:`nnstreamer_tpu_torch.edge.transport`)
  pass every framed message through :meth:`FaultPlan.wire`, which drops,
  delays, duplicates, reorders, corrupts, disconnects or partitions it
  (:func:`apply_wire_op` applies the result).

Every injected fault is counted — locally (:meth:`FaultPlan.counts`)
and in the process metrics registry (``nns_chaos_injected_total``
labeled by fault and seam) — so a soak run can assert "N faults went in
AND every one is accounted for": zero silent drops.

Spec grammar (the ``NNS_TPU_TORCH_CHAOS`` env var and the ``chaos=``
element property share it)::

    [seed=N;]fault[:key=val[,key=val...]][;fault...]

e.g. ``seed=42;drop:p=0.05;delay:ms=40,p=0.2,match=qcli`` or the
deterministic ``disconnect:every=50`` (every 50th frame).  Keys:

``p``      probability per event (default 1; ignored when ``every`` set)
``every``  deterministic cadence: fire on every Nth matching event
``after``  skip the first N matching events
``count``  stop after N injections (0 = unlimited)
``ms``     duration: delay/slow-invoke/queue-pressure sleep, or the
           partition window length (default 50)
``match``  substring of the seam label (link/element/pool name);
           empty matches everything
``dir``    wire faults only: ``tx``/``rx`` (default: both)
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: wire-seam faults (transport framing layer)
WIRE_FAULTS = ("drop", "delay", "duplicate", "reorder", "corrupt",
               "disconnect", "partition")
#: model-path faults (ModelPool / tensor_filter dispatch)
INVOKE_FAULTS = ("slow-invoke", "fail-invoke")
#: batching-window faults (queue pressure)
QUEUE_FAULTS = ("queue-pressure",)

FAULTS = WIRE_FAULTS + INVOKE_FAULTS + QUEUE_FAULTS

_SEAM_OF = {**{f: "wire" for f in WIRE_FAULTS},
            **{f: "invoke" for f in INVOKE_FAULTS},
            **{f: "queue" for f in QUEUE_FAULTS}}


class ChaosInvokeError(RuntimeError):
    """The injected ``fail-invoke`` fault: raised from the model
    dispatch so it rides the SAME error paths a real device failure
    would (the pool's every-owner fan-out, per-owner bus routing)."""


@dataclasses.dataclass
class FaultSpec:
    """One clause of a plan: what to inject, where, how often."""

    fault: str
    p: float = 1.0
    every: int = 0          # deterministic cadence (overrides p)
    after: int = 0          # skip the first N matching events
    count: int = 0          # max injections (0 = unlimited)
    ms: float = 50.0        # delay/stall/partition duration
    match: str = ""         # substring of the seam label
    direction: str = ""     # wire: "tx"/"rx"/"" (both)

    def __post_init__(self):
        if self.fault not in FAULTS:
            raise ValueError(
                f"unknown fault {self.fault!r}; one of {list(FAULTS)}")
        if not 0.0 <= float(self.p) <= 1.0:
            raise ValueError(f"{self.fault}: p={self.p} not in [0,1]")
        if self.direction not in ("", "tx", "rx"):
            raise ValueError(
                f"{self.fault}: dir={self.direction!r} not tx/rx")
        for key in ("ms", "every", "after", "count"):
            v = getattr(self, key)
            if v < 0:
                # reject at parse time: a negative ms would otherwise
                # blow up as time.sleep(-x) deep in a dispatch path
                raise ValueError(f"{self.fault}: {key}={v} must be >= 0")

    @property
    def seam(self) -> str:
        return _SEAM_OF[self.fault]

    @classmethod
    def parse(cls, clause: str) -> "FaultSpec":
        fault, _, rest = clause.strip().partition(":")
        kw: Dict[str, object] = {}
        for tok in rest.split(","):
            tok = tok.strip()
            if not tok:
                continue
            k, eq, v = tok.partition("=")
            if not eq:
                raise ValueError(f"{clause!r}: expected key=val, "
                                 f"got {tok!r}")
            k = k.strip()
            v = v.strip()
            if k in ("p", "ms"):
                kw[k] = float(v)
            elif k in ("every", "after", "count"):
                kw[k] = int(v)
            elif k == "match":
                kw[k] = v
            elif k == "dir":
                kw["direction"] = v
            else:
                raise ValueError(f"{clause!r}: unknown key {k!r}")
        return cls(fault=fault.strip(), **kw)


class _SpecState:
    """Per-spec runtime state (under the plan lock): how many events it
    saw, how many times it fired, the reorder hold slot."""

    __slots__ = ("seen", "fired")

    def __init__(self):
        self.seen = 0
        self.fired = 0


@dataclasses.dataclass
class WireOp:
    """What the transport must do with one framed message:
    ``frames`` replaces the single original frame (empty = drop/hold,
    two entries = duplicate or a released reorder pair), ``delay_s`` is
    slept before sending/delivering, ``disconnect`` closes the
    connection after the frames go out."""

    frames: List[bytes]
    delay_s: float = 0.0
    disconnect: bool = False


class FaultPlan:
    """A seeded, thread-safe fault schedule.  Install process-wide with
    :func:`nnstreamer_tpu_torch.chaos.install_plan` or attach to a single
    element via its ``chaos=`` property."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        import random

        self.specs = list(specs)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._state = [_SpecState() for _ in self.specs]
        self._counts: Dict[Tuple[str, str], int] = {}
        # reorder hold slots: (label, direction) -> held frame bytes
        self._held: Dict[Tuple[str, str], bytes] = {}
        # partition window: until this monotonic instant, every matching
        # wire frame (both directions) is dropped
        self._partition_until = 0.0
        self._partition_match = ""
        self._metric = None  # lazily bound nns_chaos_injected_total

    # -- construction ---------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from the shared grammar (see module doc)."""
        seed = 0
        clauses: List[FaultSpec] = []
        for part in str(spec).split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                seed = int(part[5:])
                continue
            clauses.append(FaultSpec.parse(part))
        if not clauses:
            raise ValueError(f"chaos spec {spec!r} names no faults")
        return cls(clauses, seed=seed)

    # -- bookkeeping ----------------------------------------------------------

    def _record(self, spec: FaultSpec) -> None:
        key = (spec.fault, spec.seam)
        self._counts[key] = self._counts.get(key, 0) + 1
        metric = self._metric
        if metric is None:
            from ..obs.metrics import REGISTRY

            metric = self._metric = REGISTRY.counter(
                "nns_chaos_injected_total",
                "faults injected by the active chaos plan",
                labelnames=("fault", "seam"))
        metric.labels(fault=spec.fault, seam=spec.seam).inc()

    def counts(self) -> Dict[str, int]:
        """``fault -> injections`` so far (all seams merged)."""
        with self._lock:
            out: Dict[str, int] = {}
            for (fault, _seam), n in self._counts.items():
                out[fault] = out.get(fault, 0) + n
            return out

    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def _fires(self, i: int, spec: FaultSpec, label: str,
               direction: str = "") -> bool:
        """Whether spec ``i`` fires for this event (caller holds the
        lock).  Deterministic under one seed: the RNG is consulted in
        event order, and ``every=`` clauses skip it entirely."""
        if spec.match and spec.match not in label:
            return False
        if spec.direction and direction and spec.direction != direction:
            return False
        st = self._state[i]
        st.seen += 1
        if st.seen <= spec.after:
            return False
        if spec.count and st.fired >= spec.count:
            return False
        if spec.every > 0:
            fire = (st.seen - spec.after) % spec.every == 0
        else:
            fire = spec.p >= 1.0 or self._rng.random() < spec.p
        if fire:
            st.fired += 1
        return fire

    # -- wire seam ------------------------------------------------------------

    def wire(self, label: str, direction: str,
             data: bytes) -> Optional[WireOp]:
        """Pass one framed message through the plan.  Returns ``None``
        when untouched (the common case — callers skip all bookkeeping),
        else a :class:`WireOp` to apply."""
        op: Optional[WireOp] = None
        with self._lock:
            now = time.monotonic()
            if self._partition_until > now and \
                    (not self._partition_match
                     or self._partition_match in label):
                # inside a partition window: everything matching is lost
                # (both directions — a real partition has no half-open
                # side at this layer)
                return WireOp(frames=[])
            for i, spec in enumerate(self.specs):
                if spec.seam != "wire":
                    continue
                if spec.fault == "corrupt" and \
                        not isinstance(data, (bytes, bytearray)):
                    continue  # inproc frames are object references:
                    # there are no wire bytes to corrupt
                if not self._fires(i, spec, label, direction):
                    continue
                self._record(spec)
                if op is None:
                    op = WireOp(frames=[data])
                if spec.fault == "drop":
                    op.frames = []
                elif spec.fault == "delay":
                    op.delay_s += spec.ms / 1e3
                elif spec.fault == "duplicate":
                    op.frames = op.frames + op.frames
                elif spec.fault == "corrupt":
                    op.frames = [self._corrupt(f) for f in op.frames]
                elif spec.fault == "disconnect":
                    op.disconnect = True
                elif spec.fault == "partition":
                    self._partition_until = now + spec.ms / 1e3
                    self._partition_match = spec.match
                    op.frames = []
                elif spec.fault == "reorder":
                    # pairwise swap-with-next: with nothing held, hold
                    # the last live frame; with a frame already held,
                    # release it AFTER the current frames.  Operates on
                    # op.frames (not the original data) so composition
                    # stays sound: a frame another clause dropped is
                    # never resurrected, and a duplicate's second copy
                    # is held, not lost.
                    key = (label, direction)
                    held = self._held.pop(key, None)
                    if held is not None:
                        op.frames = op.frames + [held]
                    elif op.frames:
                        self._held[key] = op.frames[-1]
                        op.frames = op.frames[:-1]
        return op

    def flush_held(self, label: str, direction: str) -> Optional[bytes]:
        """Release a reorder hold slot.  A hold that is never released
        (stream ended right after it) degenerates into a drop — which
        is realistic network behavior, and the RECEIVER-side accounting
        (timeouts, EOS drain) covers it exactly like a real drop; the
        injection was already counted as ``reorder``."""
        with self._lock:
            return self._held.pop((label, direction), None)

    def _corrupt(self, data: bytes) -> bytes:
        """Flip one byte at a seeded offset — enough for the wire
        codec's header/length checks to reject the frame."""
        if not data:
            return data
        buf = bytearray(data)
        i = self._rng.randrange(len(buf))
        buf[i] ^= 0xFF
        return bytes(buf)

    # -- invoke seam ----------------------------------------------------------

    def invoke_fault(self, label: str) -> Optional[Tuple[str, float]]:
        """Model-dispatch fault for one window/frame: ``("slow", s)``
        to sleep before the dispatch, or ``("fail", 0.0)`` — callers
        raise :class:`ChaosInvokeError`.  ``fail`` wins when both
        fire (the sleep would only delay the error)."""
        out: Optional[Tuple[str, float]] = None
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.seam != "invoke":
                    continue
                if not self._fires(i, spec, label):
                    continue
                self._record(spec)
                if spec.fault == "fail-invoke":
                    out = ("fail", 0.0)
                elif out is None:
                    out = ("slow", spec.ms / 1e3)
        return out

    # -- queue seam -----------------------------------------------------------

    def queue_stall(self, label: str) -> float:
        """Seconds to stall a batching-window flush (0 = none): the
        injected device slowdown that turns into upstream queue
        pressure."""
        stall = 0.0
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.seam != "queue":
                    continue
                if not self._fires(i, spec, label):
                    continue
                self._record(spec)
                stall += spec.ms / 1e3
        return stall

    def __repr__(self):
        cl = ";".join(s.fault for s in self.specs)
        return f"<FaultPlan seed={self.seed} [{cl}]>"


def apply_wire_op(op: WireOp, deliver: Callable[[Any], Any],
                  disconnect: Optional[Callable[[], None]] = None) -> bool:
    """The one implementation of applying a :class:`WireOp`: sleep the
    delay, deliver each frame, then run the disconnect action.  Every
    transport seam routes through here so the op semantics live in one
    place.  Returns False when any ``deliver`` explicitly returned False
    (tx sites report send failures; rx sites return None, which counts
    as success)."""
    if op.delay_s > 0:
        time.sleep(op.delay_s)
    ok = True
    for f in op.frames:
        ok = (deliver(f) is not False) and ok
    if op.disconnect and disconnect is not None:
        disconnect()
    return ok


def apply_invoke_fault(plan: "FaultPlan",
                       label: str) -> Optional[Tuple[str, float]]:
    """Convenience for the dispatch sites: sleep a ``slow-invoke`` /
    raise a ``fail-invoke`` (the raise rides the caller's normal error
    path — bus routing, the pool's every-owner fan-out).  Returns the
    slow fault it applied, or None."""
    fault = plan.invoke_fault(label)
    if fault is None:
        return None
    kind, s = fault
    if kind == "fail":
        raise ChaosInvokeError(f"injected fail-invoke at {label}")
    time.sleep(s)
    return fault
