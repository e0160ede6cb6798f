"""The ONE reconnect policy every edge transport shares: jittered
exponential backoff + a circuit breaker.

Counterpart of the JAX package's ``chaos/retrypolicy.py``, with the same
states, gauges and actuator.  Its callers are the edge elements'
reconnect loops (``edge/query.py``); the actuation plane
(``runtime/actuators.py`` kind ``link``) steers any live policy.  A fleet of clients
hammering a restarting server at a fixed interval is a thundering herd;
a loop that never gives up hides a dead dependency forever.  This policy
gives every loop the same three behaviors:

- **jittered exponential backoff** — attempt ``n`` waits
  ``min(base * multiplier^(n-1), max)`` scaled by a ±``jitter``
  fraction, so synchronized clients decorrelate;
- **circuit breaker** — after ``fail_threshold`` consecutive failures
  the breaker OPENS: attempts stop for ``open_s`` (no point dialing a
  dead peer at full cadence), then ONE probe runs half-open; its
  success closes the breaker, its failure re-opens it;
- **one-line outage logging** — the FIRST failure of an outage logs at
  WARNING, later attempts log at debug, and recovery logs one WARNING
  with the outage length — never per-attempt spam.

State (backoff level, breaker state, opens) mirrors into the link's
:class:`~nnstreamer_tpu_torch.obs.metrics.LinkMetrics`, so it exports as
``nns_edge_backoff_level`` / ``nns_edge_breaker_state`` gauges and
shows on ``nns-top`` LINK rows.
"""

from __future__ import annotations

import random
import threading
import time
import weakref
from typing import Optional

from ..utils.log import logd, logw

#: breaker states (exported as the nns_edge_breaker_state gauge)
CLOSED, HALF_OPEN, OPEN = 0, 1, 2

_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half-open", OPEN: "open"}


class BreakerOpen(Exception):
    """Raised by :meth:`RetryPolicy.check` when the breaker is open and
    the caller asked for a hard failure instead of a wait."""


class RetryPolicy:
    """Per-link reconnect policy.  Thread-safe; one instance per
    connection/loop (state is an attribute of THAT link's outage, not
    of the process).  Every instance self-registers in a process-wide
    weak registry so the actuation plane (``runtime/actuators.py`` /
    ``nns-ctl``) can find a link's breaker by name — drain it, force a
    half-open probe, or reset it — without the link having to opt in.
    """

    #: weak process registry of live policies (actuator discovery)
    _REG_LOCK = threading.Lock()
    _REG: "weakref.WeakSet[RetryPolicy]" = weakref.WeakSet()

    def __init__(self, name: str = "", base_s: float = 0.2,
                 max_s: float = 5.0, multiplier: float = 2.0,
                 jitter: float = 0.5, fail_threshold: int = 5,
                 open_s: float = 5.0, metrics=None,
                 seed: Optional[int] = None):
        self.name = name
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.fail_threshold = int(fail_threshold)
        self.open_s = float(open_s)
        self.metrics = metrics  # LinkMetrics (or None)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.consecutive_failures = 0
        self.state = CLOSED
        self._opened_at = 0.0
        self._outage_started = 0.0
        self.breaker_opens = 0
        # wakes policy-paced sleeps (wait()) when an actuator forces a
        # transition: a re-dial loop sitting out a long open window
        # probes NOW instead of when its sleep expires
        self._kick = threading.Event()
        self._actuators = None
        self._sync_metrics()
        with RetryPolicy._REG_LOCK:
            RetryPolicy._REG.add(self)

    @classmethod
    def all_policies(cls) -> "List[RetryPolicy]":
        """Live policies, stable order (actuator discovery)."""
        with cls._REG_LOCK:
            pols = list(cls._REG)
        return sorted(pols, key=lambda p: (p.name, id(p)))

    # -- state transitions ----------------------------------------------------

    def failure(self, err: BaseException = None, what: str = "") -> None:
        """Record one failed attempt.  Logs the FIRST failure of an
        outage at WARNING (one line); opens the breaker at the
        threshold."""
        with self._lock:
            self.consecutive_failures += 1
            n = self.consecutive_failures
            first = n == 1
            if first:
                self._outage_started = time.monotonic()
            opened = False
            if self.state == HALF_OPEN or \
                    (self.state == CLOSED and n >= self.fail_threshold):
                self.state = OPEN
                self._opened_at = time.monotonic()
                self.breaker_opens += 1
                opened = True
            elif self.state == OPEN:
                # a failure while already open (caller attempted
                # without consulting allow()/delay()): restart the
                # open window, same episode — no double count
                self._opened_at = time.monotonic()
            self._sync_metrics_locked()
        if first:
            logw("%s: %s failed (%s); retrying with backoff",
                 self.name or "link", what or "connect", err)
        elif opened:
            logw("%s: circuit breaker OPEN after %d consecutive "
                 "failures — next probe in %.1fs",
                 self.name or "link", n, self.open_s)
        else:
            logd("%s: attempt %d failed (%s)", self.name or "link", n, err)
        if opened:
            # black box: a breaker opening is one of the flight
            # recorder's trigger conditions (obs/flightrec.py) — the
            # ring holds the seconds that led here, the dump keeps them
            from ..obs.flightrec import FLIGHT

            FLIGHT.breaker_opened(self.name or "link", n,
                                  self.breaker_opens)

    def success(self) -> None:
        """Record a successful attempt: closes the breaker, resets the
        backoff, logs recovery (once per outage)."""
        with self._lock:
            n = self.consecutive_failures
            outage = time.monotonic() - self._outage_started if n else 0.0
            self.consecutive_failures = 0
            self.state = CLOSED
            self._sync_metrics_locked()
        if n:
            logw("%s: recovered after %d failed attempt(s) (%.1fs outage)",
                 self.name or "link", n, outage)

    # -- the caller-facing schedule -------------------------------------------

    def allow(self) -> bool:
        """Whether an attempt may run now.  While OPEN, returns False
        until ``open_s`` elapsed, then transitions to HALF_OPEN and
        admits one probe."""
        with self._lock:
            if self.state != OPEN:
                return True
            if time.monotonic() - self._opened_at < self.open_s:
                return False
            self.state = HALF_OPEN
            self._sync_metrics_locked()
            return True

    def check(self) -> None:
        """Hard variant of :meth:`allow`: raises :class:`BreakerOpen`
        instead of returning False (for callers with no loop to wait
        in, e.g. a send path that must fail fast while the peer is
        known-dead)."""
        if not self.allow():
            with self._lock:
                remain = self.open_s - (time.monotonic() - self._opened_at)
            raise BreakerOpen(
                f"{self.name or 'link'}: circuit breaker open "
                f"({self.consecutive_failures} consecutive failures; "
                f"probe in {max(remain, 0.0):.1f}s)")

    def backoff(self) -> float:
        """Jittered exponential delay before the next attempt, based on
        the current failure streak (0 after a success)."""
        with self._lock:
            n = self.consecutive_failures
            if n <= 0:
                return 0.0
            d = min(self.base_s * self.multiplier ** (n - 1), self.max_s)
            if self.jitter:
                d *= 1.0 + self.jitter * self._rng.uniform(-1.0, 1.0)
            return max(d, 0.0)

    def delay(self) -> float:
        """Seconds to wait before the next attempt: the remaining open
        window while the breaker is open, else the backoff.  An open
        window that has elapsed transitions to HALF_OPEN here — loops
        that pace themselves with :meth:`wait`/:meth:`delay` (rather
        than polling :meth:`allow`) get the same one-probe half-open
        semantics: the attempt after the wait IS the probe, and its
        :meth:`failure` re-opens the breaker."""
        with self._lock:
            if self.state == OPEN:
                remain = self.open_s - (time.monotonic() - self._opened_at)
                if remain > 0:
                    return remain
                self.state = HALF_OPEN
                self._sync_metrics_locked()
        return self.backoff()

    def wait(self, stop: Optional[threading.Event] = None,
             max_s: Optional[float] = None) -> bool:
        """Sleep :meth:`delay` (capped at ``max_s``), interruptible by
        ``stop`` and by a forced breaker transition
        (:meth:`force_half_open` / :meth:`reset` kick the sleep, so a
        loop sitting out a long open window re-probes immediately).
        Returns False when ``stop`` fired during the wait."""
        # clear the kick BEFORE reading delay(): a forced transition
        # landing between the two is then reflected in the delay we
        # compute (the state already moved), while one landing after
        # the clear wakes the sleep — either way the probe runs now,
        # never after a stale open window
        self._kick.clear()
        d = self.delay()
        if max_s is not None:
            d = min(d, max_s)
        if d <= 0:
            return stop is None or not stop.is_set()
        if stop is None:
            self._kick.wait(d)
            return True
        deadline = time.monotonic() + d
        while True:
            remain = deadline - time.monotonic()
            if remain <= 0 or self._kick.is_set():
                return True
            if stop.wait(min(remain, 0.05)):
                return False

    # -- forced transitions (the actuation plane) -----------------------------

    def force_open(self) -> None:
        """Administratively OPEN the breaker — the **drain** actuation:
        the link stops attempting until ``open_s`` elapses (or a forced
        probe).  Not counted in :attr:`breaker_opens` (that counts
        failure-driven opens; the gauge reflects the state either
        way)."""
        with self._lock:
            self.state = OPEN
            self._opened_at = time.monotonic()
            self._sync_metrics_locked()
        logw("%s: circuit breaker forced OPEN (drain)",
             self.name or "link")

    def force_half_open(self) -> None:
        """Force the one-probe half-open state NOW instead of when the
        open window expires, and kick any policy-paced sleep — the
        **re-dial** actuation for a controller that knows (or suspects)
        the peer is back."""
        with self._lock:
            if self.state == OPEN:
                self.state = HALF_OPEN
                self._sync_metrics_locked()
        self._kick.set()

    def reset(self) -> None:
        """Administratively close the breaker and zero the backoff —
        the **restart-link** actuation (the next attempt runs at full
        cadence, and a failure starts a fresh outage)."""
        with self._lock:
            self.consecutive_failures = 0
            self.state = CLOSED
            self._sync_metrics_locked()
        self._kick.set()

    def actuators(self) -> dict:
        """This link's actuator set (``runtime/actuators.py``): one
        ``breaker`` knob, value = target state (0 closed/reset,
        1 half-open probe, 2 open/drain)."""
        with self._lock:
            acts = self._actuators
        if acts is not None:
            return acts
        from ..runtime.actuators import Actuator

        def _set(v: float) -> None:
            s = int(round(v))
            if s >= OPEN:
                self.force_open()
            elif s == HALF_OPEN:
                self.force_half_open()
            else:
                self.reset()

        built = {"breaker": Actuator(
            "breaker", "link", self.name or "link",
            get_fn=lambda: float(self.state), set_fn=_set,
            lo=float(CLOSED), hi=float(OPEN), unit="state",
            cooldown_s=0.5)}
        with self._lock:
            # concurrent first builds converge on one set (shared
            # cooldown/revert state)
            if self._actuators is None:
                self._actuators = built
            return self._actuators

    # -- introspection --------------------------------------------------------

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self.state]

    @property
    def backoff_level(self) -> int:
        """Failure streak length — the exponent driving the backoff."""
        return self.consecutive_failures

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": _STATE_NAMES[self.state],
                    "backoff_level": self.consecutive_failures,
                    "breaker_opens": self.breaker_opens}

    def _sync_metrics(self) -> None:
        with self._lock:
            self._sync_metrics_locked()

    def _sync_metrics_locked(self) -> None:
        m = self.metrics
        if m is not None:
            m.set_retry_state(self.state, self.consecutive_failures,
                              self.breaker_opens)
