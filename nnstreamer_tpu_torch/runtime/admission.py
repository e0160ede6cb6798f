"""SLO-aware admission control for the shared serving path.

Counterpart of the JAX package's ``runtime/admission.py``.  The pool wires
in its ``nns_admission_latency_seconds`` child of the metrics registry
(``hist=``): every serve latency feeds it and the p99 the shed decision
acts on is read from its buckets, so a scraper sees the signal the
shedder uses; a private window of recent latencies is the fallback
(``hist=None``, or a p99 past the last finite bucket).  Open-loop
traffic does not slow down when the server does, so the
:class:`~nnstreamer_tpu_torch.runtime.serving.SharedBatcher` gets the
classic overload-control trio:

- **priority classes** — each sharing stream (``tensor_filter
  priority=high|normal|low``) names how much it matters;
- **bounded per-stream queues with backpressure** — a stream may park
  at most ``queue-limit`` frames in the cross-stream window; past that
  its producer thread BLOCKS instead of growing the window unboundedly;
- **load shedding under SLO risk** — the controller watches the pool's
  recent serve latencies; when the p99 estimate enters the ramp below
  the pool's ``slo-ms`` it sheds sub-high-priority frames at admission.
  Every shed is counted and posts a (rate-limited) bus WARNING.

Batch formation turns earliest-deadline-first while admission is armed,
and the shed probability ramps linearly from 0 at ``RAMP_START``×SLO
(0.7) to 1 at the SLO, so the system settles at a p99 just under the SLO
instead of duty-cycling.  The verdicts draw from ``random.Random(0)``, so
one latency sequence gives the same verdicts in both packages.
"""

from __future__ import annotations

import random
import threading
from collections import deque
from typing import Deque, Dict, Optional

#: stream priority classes, best first (comparisons use the rank)
PRIORITY_CLASSES = {"high": 0, "normal": 1, "low": 2}

#: Buffer.meta key carrying the pipeline-ingress time.  A source stamps
#: it (``SourceElement._loop``) only while some admission controller is
#: armed in the process (:data:`ACTIVE`): a full window dispatches inline
#: on the producer thread, so an overload backlog waits in the UPSTREAM
#: ``queue`` elements, and only a deadline and a latency anchored at
#: ingress let the controller see that wait.
INGRESS_TS_META = "_nns_ingress_ts"

#: the flag the sources read once a frame; kept by the counter below
ACTIVE = False

_active_lock = threading.Lock()
_active_count = 0


def _controller_armed() -> None:
    global ACTIVE, _active_count
    with _active_lock:
        _active_count += 1
        ACTIVE = True


def _controller_disarmed() -> None:
    global ACTIVE, _active_count
    with _active_lock:
        _active_count = max(_active_count - 1, 0)
        ACTIVE = _active_count > 0

_PRIORITY_NAMES = {v: k for k, v in PRIORITY_CLASSES.items()}


def parse_priority(value) -> int:
    """``high``/``normal``/``low`` (or a 0-2 rank) → rank."""
    if isinstance(value, int) and value in _PRIORITY_NAMES:
        return value
    name = str(value or "normal").strip().lower()
    if name not in PRIORITY_CLASSES:
        raise ValueError(
            f"unknown priority {value!r}; one of "
            f"{list(PRIORITY_CLASSES)} (or 0-2)")
    return PRIORITY_CLASSES[name]


def priority_name(rank: int) -> str:
    return _PRIORITY_NAMES.get(int(rank), str(rank))


class StreamPolicy:
    """One stream's admission settings (derived from tensor_filter
    props at pool attach)."""

    __slots__ = ("priority", "deadline_s", "queue_limit", "tenant")

    def __init__(self, priority: int = 1, deadline_s: float = 0.0,
                 queue_limit: int = 0, tenant: str = "default"):
        self.priority = int(priority)
        self.deadline_s = float(deadline_s)
        self.queue_limit = int(queue_limit)
        # who this stream's frames are billed to: the tenant= filter
        # property, attributed per dispatch by obs/tenantstat.py
        self.tenant = str(tenant) or "default"


class AdmissionController:
    """Per-pool overload controller: latency window → p99 estimate →
    at-risk flag → shed verdicts, plus per-priority accounting."""

    #: recompute the p99 estimate every N observations (a sort of the
    #: whole window per frame would throttle the hot path)
    RECOMPUTE_EVERY = 16
    #: how many per-recompute histogram deltas the rolling distribution
    #: sums over — 32 × RECOMPUTE_EVERY ≈ the private window's 512
    HIST_WINDOW_DELTAS = 32
    #: the shed-probability ramp: 0 below RAMP_START×SLO, 1 at the SLO
    #: (a hard on/off threshold duty-cycles; the graded ramp settles)
    RAMP_START = 0.7

    def __init__(self, slo_s: float, window: int = 512, hist=None):
        if slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {slo_s}")
        self.slo_s = float(slo_s)
        # instance copy of the ramp start so an external controller can
        # retune the shed aggressiveness at runtime (the "ramp-start"
        # actuator, runtime/actuators.py); the class constant stays the
        # documented default
        self.ramp_start = float(self.RAMP_START)
        self._lat: Deque[float] = deque(maxlen=int(window))
        self._lock = threading.Lock()
        self._rng = random.Random(0)
        self._since_recompute = 0
        self._p99 = 0.0
        # the registry's exported serve-latency histogram child (with
        # hist_state()); None keeps the private window as the signal
        self._hist = hist
        self._hist_prev = None  # cumulative buckets at last recompute
        self._hist_deltas: Deque[list] = deque(
            maxlen=self.HIST_WINDOW_DELTAS)
        self.at_risk = False
        self.risk_episodes = 0  # times the at-risk flag armed
        # pre-seeded per-priority counters: the hot path only ever
        # does `d[k] += 1` under the lock (ranks are validated by
        # parse_priority before they reach here)
        zero = {p: 0 for p in PRIORITY_CLASSES.values()}
        self.submitted: Dict[int, int] = dict(zero)
        self.shed: Dict[int, int] = dict(zero)
        self.shed_queue_full: Dict[int, int] = dict(zero)

    # -- the latency signal ---------------------------------------------------

    def observe(self, lat_s: float) -> None:
        """Feed one serve latency (window park → results demuxed)."""
        hist = self._hist
        if hist is not None:
            # the exported histogram's own lock serializes this, so it
            # stays outside the controller lock
            hist.observe(float(lat_s))
        with self._lock:
            self._lat.append(float(lat_s))
            self._since_recompute += 1
            if self._since_recompute >= self.RECOMPUTE_EVERY:
                self._recompute_locked()

    def _recompute_locked(self) -> None:
        self._since_recompute = 0
        if not self._lat:
            return
        p99 = self._hist_p99_locked() if self._hist is not None else None
        if p99 is None:
            # registry detached (or the tail ran past the last finite
            # bucket): the private window is the fallback signal
            s = sorted(self._lat)
            p99 = s[min(int(0.99 * len(s)), len(s) - 1)]
        self._p99 = p99
        was = self.at_risk
        self.at_risk = self._shed_probability_locked() > 0.0
        if self.at_risk and not was:
            self.risk_episodes += 1

    def _hist_p99_locked(self) -> Optional[float]:
        """p99 from the exported histogram: the cumulative bucket counts
        diffed since the last recompute, the recent deltas summed into a
        rolling distribution, and the quantile interpolated by the
        registry's :func:`~nnstreamer_tpu_torch.obs.metrics.
        bucket_quantile`.  None when there is no recent data or the p99
        lies in the +Inf bucket."""
        from ..obs.metrics import bucket_quantile

        buckets, _sum, _count = self._hist.hist_state()
        prev = self._hist_prev
        self._hist_prev = buckets
        if prev is None or len(prev) != len(buckets):
            return None
        delta = [c - p for c, p in zip(buckets, prev)]
        if any(d < 0 for d in delta):  # histogram child was reset
            return None
        self._hist_deltas.append(delta)
        dist = [sum(col) for col in zip(*self._hist_deltas)]
        return bucket_quantile(self._hist.bucket_bounds, dist, 0.99)

    def _shed_probability_locked(self) -> float:
        """0 while the p99 sits safely under the SLO, ramping linearly
        to 1 as it reaches it."""
        start = self.ramp_start * self.slo_s
        if self._p99 <= start:
            return 0.0
        return min((self._p99 - start) / (self.slo_s - start), 1.0)

    def set_ramp_start(self, frac: float) -> None:
        """Retune the shed ramp (the external controller's knob): the
        shed probability stays 0 until the p99 crosses ``frac``×SLO and
        reaches 1 at the SLO.  Lower = shed earlier/harder.  The
        at-risk flag re-derives immediately so a retune takes effect on
        this window, not RECOMPUTE_EVERY observations later."""
        frac = float(frac)
        if not 0.0 < frac < 1.0:
            raise ValueError(f"ramp_start must be in (0, 1), got {frac}")
        with self._lock:
            self.ramp_start = frac
            was = self.at_risk
            self.at_risk = self._shed_probability_locked() > 0.0
            if self.at_risk and not was:
                self.risk_episodes += 1

    def reset_signal(self) -> None:
        """Drop the accumulated latency signal (warm-up latencies must
        not arm the controller before real traffic).  The exported
        histogram keeps its cumulative counts — resetting a Prometheus
        counter would break scrapers — but its rolling delta window
        restarts from the current state."""
        hist_state = self._hist.hist_state() if self._hist is not None \
            else None
        with self._lock:
            self._lat.clear()
            self._p99 = 0.0
            self.at_risk = False
            self._since_recompute = 0
            self._hist_deltas.clear()
            if hist_state is not None:
                self._hist_prev = hist_state[0]

    @property
    def shed_probability(self) -> float:
        with self._lock:
            return self._shed_probability_locked()

    @property
    def p99_s(self) -> float:
        with self._lock:
            return self._p99

    # -- verdicts -------------------------------------------------------------

    def admit(self, priority: int) -> bool:
        """Whether a frame of ``priority`` may enter the window now.
        False = shed (already counted).  The high class is never shed
        here (it is protected by backpressure + everyone else's
        sheds); lower classes shed with the ramp probability."""
        with self._lock:
            self.submitted[priority] += 1
            if priority <= PRIORITY_CLASSES["high"]:
                return True
            p = self._shed_probability_locked()
            if p > 0.0 and (p >= 1.0 or self._rng.random() < p):
                self.shed[priority] += 1
                return False
            return True

    def count_queue_full(self, priority: int) -> None:
        """A frame dropped because its stream's bounded queue never
        drained within the backpressure window (wedged device)."""
        with self._lock:
            self.shed_queue_full[priority] += 1

    # -- pull side ------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "slo_ms": self.slo_s * 1e3,
                "p99_ms": self._p99 * 1e3,
                "ramp_start": self.ramp_start,
                "at_risk": self.at_risk,
                "shed_probability": round(
                    self._shed_probability_locked(), 4),
                "risk_episodes": self.risk_episodes,
                "submitted": {priority_name(k): v
                              for k, v in sorted(self.submitted.items())},
                "shed": {priority_name(k): v
                         for k, v in sorted(self.shed.items())},
                "shed_queue_full": {
                    priority_name(k): v
                    for k, v in sorted(self.shed_queue_full.items())},
            }

    @property
    def total_shed(self) -> int:
        with self._lock:
            return sum(self.shed.values()) \
                + sum(self.shed_queue_full.values())
