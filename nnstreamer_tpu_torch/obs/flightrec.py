"""Flight recorder — an always-on black box for the serving runtime.

Counterpart of the JAX package's ``obs/flightrec.py``.  The admission and
chaos layers *detect* trouble — the admission controller hard-sheds, an
element errors — but by the time a human looks, the interesting seconds
are gone.  This module keeps them: a bounded ring of control-plane events
(sheds, element errors, lifecycle steps, chaos triggers — each carrying
its cumulative counters, so the ring holds the metric *deltas* of the
last N seconds) that is cheap when idle (no thread, no hot-path hook:
only the rare control-plane paths push events) and is dumped when
triggered:

- **admission hard-shed** — the shed ramp reached 1.0
  (``runtime/serving.py`` ``_warn_shed``);
- **uncaught element error** (``Element.post_error``);
- **circuit breaker opening** (``chaos/retrypolicy.py``);
- **explicitly** — the metrics server's ``/dump`` endpoint, SIGUSR2
  (:func:`install_signal_handler`), or :meth:`FlightRecorder.trigger`.

A dump is two files in the armed directory: a Perfetto loadable trace
(``flightrec-NNN-<reason>-trace.json``: the ring's events as instant
marks, plus — when a latency tracer is attached — its per-frame spans)
and a metrics-registry snapshot (``…-snapshot.json``); while the host
profiler's sampler runs (``obs/prof.py``) the dump also embeds its last
seconds of collapsed stacks (``host_stacks``).

Arming: ``NNS_TPU_TORCH_FLIGHTREC_DIR=<dir>`` (picked up at first
pipeline start, like ``NNS_TPU_TORCH_CHAOS``) or :meth:`FLIGHT.arm
<FlightRecorder.arm>`.  Unarmed, triggers still count and the ring still
records — ``/dump`` can read it — but nothing is written.  Dump writes
are rate-limited (:attr:`FlightRecorder.min_dump_interval_s`).  The
global kill switch (``NNS_TPU_TORCH_OBS_DISABLE``) turns the recorder
off.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils.conf import ENV_PREFIX
from . import hooks as _hooks

#: the environment key that arms dump-to-disk
DIR_ENV = f"{ENV_PREFIX}FLIGHTREC_DIR"


class FlightRecorder:
    """Bounded ring of timestamped events + the trigger/dump machinery."""

    def __init__(self, max_events: int = 4096, horizon_s: float = 120.0,
                 min_dump_interval_s: float = 5.0):
        self._lock = threading.Lock()
        self._events: "collections.deque" = collections.deque(
            maxlen=int(max_events))
        self.horizon_s = float(horizon_s)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.enabled = not _hooks.DISABLED
        self._dir: Optional[str] = None
        self._seq = 0
        self._last_dump_ts = 0.0
        self.triggers: Dict[str, int] = {}
        self.dumps: List[Tuple[str, str]] = []  # (trace, snapshot) paths

    # -- arming --------------------------------------------------------------

    def arm(self, directory: str) -> None:
        """Enable dump-to-disk into ``directory`` (created if needed)."""
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self._dir = directory

    def disarm(self) -> None:
        with self._lock:
            self._dir = None

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._dir is not None

    # -- recording (the rare control-plane paths call these) -----------------

    def note(self, kind: str, name: str = "", **args: Any) -> None:
        """Append one event to the ring.  ``args`` should carry the
        caller's cumulative counters (total sheds, breaker opens, ...)
        so the ring doubles as a metric-delta log."""
        if not self.enabled:
            return
        evt = {"ts": time.monotonic(), "wall": time.time(),
               "kind": kind, "name": name, "args": args}
        with self._lock:
            self._events.append(evt)

    def trigger(self, reason: str, name: str = "",
                **args: Any) -> Optional[Tuple[str, str]]:
        """Record a trigger event and — when armed and not rate-limited
        — dump the black box.  Returns the (trace, snapshot) paths of a
        written dump, else None."""
        decision = self._trigger_decision(reason, name, **args)
        if decision is None:
            return None
        directory, seq = decision
        return self._dump_files(directory, reason, seq,
                                self.dump_json(reason))

    def trigger_async(self, reason: str, name: str = "",
                      **args: Any) -> bool:
        """Trigger for latency-critical callers (streaming/submit/retry
        threads): the counting is synchronous (deterministic), but the
        expensive part — registry snapshot, trace serialization, file
        writes — runs on a short-lived thread, and ONLY when a dump is
        actually due (armed, not rate-limited), so an error/shed storm
        costs a counter bump per event, not a thread per event.
        Returns True when a dump was scheduled."""
        decision = self._trigger_decision(reason, name, **args)
        if decision is None:
            return False
        directory, seq = decision

        def _work():
            self._dump_files(directory, reason, seq,
                             self.dump_json(reason))

        from . import prof as _prof

        _prof.named_thread("flightrec", "dump", _work).start()
        return True

    def trigger_dump(self, reason: str = "endpoint") -> dict:
        """Trigger + the full dump document, built ONCE: the same doc
        is written to disk (when armed and not rate-limited) and
        returned to the caller — the ``/dump`` endpoint's path, so the
        response and the on-disk dump cannot disagree."""
        decision = self._trigger_decision(reason)
        doc = self.dump_json(reason)
        if decision is not None:
            self._dump_files(decision[0], reason, decision[1], doc)
        return doc

    def _trigger_decision(
            self, reason: str, name: str = "",
            **args: Any) -> Optional[Tuple[str, int]]:
        """Count the trigger; return (directory, seq) when a dump
        should be written, else None (disabled/unarmed/rate-limited)."""
        if not self.enabled:
            return None
        self.note("trigger", name or reason, reason=reason, **args)
        with self._lock:
            self.triggers[reason] = self.triggers.get(reason, 0) + 1
            directory = self._dir
            now = time.monotonic()
            if directory is None or \
                    now - self._last_dump_ts < self.min_dump_interval_s:
                return None
            self._last_dump_ts = now
            self._seq += 1
            return directory, self._seq

    # -- convenience feeders (the wired trigger paths) -----------------------

    def element_error(self, element: str, err: BaseException) -> None:
        """An error reached an element's bus (``Element.post_error``) —
        called from the erroring STREAMING thread, so the dump is
        offloaded (:meth:`trigger_async`)."""
        if not self.enabled:
            return
        self.note("error", element,
                  error=f"{type(err).__name__}: {err}")
        self.trigger_async("element-error", element)

    def breaker_opened(self, link: str, failures: int,
                       opens: int) -> None:
        """A link's circuit breaker opened (chaos/retrypolicy.py) —
        called on the retry path, dump offloaded."""
        self.note("breaker-open", link, failures=failures, opens=opens)
        self.trigger_async("breaker-open", link)

    def shed(self, pool: str, priority: str, reason: str,
             total_shed: int, hard: bool) -> None:
        """The admission controller shed frames; ``hard`` means the
        shed ramp reached 1.0 — the hard-shed trigger threshold.
        Called on the frame submit path during overload: a synchronous
        dump here would stall the very thread whose SLO breach
        triggered the shed, so it is offloaded."""
        self.note("shed", pool, priority=priority, reason=reason,
                  total_shed=total_shed, hard=hard)
        if hard:
            self.trigger_async("admission-hard-shed", pool,
                               total_shed=total_shed)

    # -- the dump ------------------------------------------------------------

    def events(self) -> List[dict]:
        """Ring contents within the horizon, oldest first."""
        cutoff = time.monotonic() - self.horizon_s
        with self._lock:
            return [dict(e) for e in self._events if e["ts"] >= cutoff]

    def chrome_trace(self) -> dict:
        """The ring as Chrome trace-event JSON: one instant mark per
        event on a dedicated ``flightrec`` lane — merged with the
        attached latency tracer's per-frame spans (same monotonic
        clock) when one is installed, so the dump shows WHAT the
        pipeline was doing around the trigger, not only that it
        triggered."""
        events: List[dict] = [{
            "name": f"{e['kind']}:{e['name']}" if e["name"]
            else e["kind"],
            "cat": "flightrec", "ph": "i", "s": "g",
            "pid": 1, "tid": 0,
            "ts": e["ts"] * 1e6,
            "args": {**e["args"], "wall": e["wall"]},
        } for e in self.events()]
        tracer = _hooks.tracer
        if tracer is not None and hasattr(tracer, "chrome_trace"):
            cutoff_us = (time.monotonic() - self.horizon_s) * 1e6
            try:
                for ev in tracer.chrome_trace().get("traceEvents", ()):
                    if ev.get("ts", 0) >= cutoff_us:
                        events.append(ev)
            except (TypeError, ValueError, KeyError):
                pass  # a half-built tracer record must not kill a dump
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_json(self, reason: str = "endpoint") -> dict:
        """The full dump document (what ``/dump`` serves): trace +
        registry snapshot + trigger accounting."""
        from .metrics import REGISTRY

        with self._lock:
            triggers = dict(self.triggers)
        doc = {
            "reason": reason,
            "time": time.time(),
            "triggers": triggers,
            "trace": self.chrome_trace(),
            "snapshot": REGISTRY.snapshot(),
        }
        # host profiler (obs/prof.py): when the sampler is armed, the
        # dump embeds its last-K-seconds collapsed stacks — a hard-shed
        # or breaker-open dump answers "what was the host doing"
        # without a reproduction
        from .prof import PROFILER

        if PROFILER.running:
            doc["host_stacks"] = PROFILER.ring_collapsed()
        return doc

    def _dump_files(self, directory: str, reason: str, seq: int,
                    doc: dict) -> Optional[Tuple[str, str]]:
        from ..utils.log import logw

        base = os.path.join(directory, f"flightrec-{seq:03d}-{reason}")
        trace_path = base + "-trace.json"
        snap_path = base + "-snapshot.json"
        try:
            with open(trace_path, "w") as f:
                json.dump(doc["trace"], f)
            with open(snap_path, "w") as f:
                json.dump({"reason": doc["reason"], "time": doc["time"],
                           "triggers": doc["triggers"],
                           "snapshot": doc["snapshot"],
                           **({"host_stacks": doc["host_stacks"]}
                              if "host_stacks" in doc else {})}, f)
        except (OSError, TypeError, ValueError) as e:
            # TypeError/ValueError: a ring event carried a
            # non-JSON-serializable arg — the dump fails, the process
            # (and the error being recorded) must not
            logw("flight recorder: cannot write dump under %s: %s",
                 directory, e)
            return None
        with self._lock:
            self.dumps.append((trace_path, snap_path))
        logw("flight recorder: dumped %s (trigger: %s)", trace_path,
             reason)
        return trace_path, snap_path

    def clear(self) -> None:
        """Tests only: drop ring, trigger counts and dump bookkeeping."""
        with self._lock:
            self._events.clear()
            self.triggers.clear()
            self.dumps.clear()
            self._last_dump_ts = 0.0


#: the process-wide recorder every wired trigger path feeds
FLIGHT = FlightRecorder()

_env_checked = False


def maybe_arm_from_env() -> None:
    """``NNS_TPU_TORCH_FLIGHTREC_DIR=<dir>`` arms the recorder when the
    first pipeline starts (the activation hook of
    ``NNS_TPU_TORCH_CHAOS`` / ``NNS_TPU_TORCH_METRICS_PORT`` too).  Also
    installs the SIGUSR2 dump handler, best effort."""
    global _env_checked
    if _env_checked:
        return
    _env_checked = True
    directory = os.environ.get(DIR_ENV, "").strip()
    if not directory:
        return
    try:
        FLIGHT.arm(directory)
    except OSError as e:
        from ..utils.log import logw

        logw("cannot arm flight recorder on %s=%s: %s", DIR_ENV,
             directory, e)
        return
    install_signal_handler()


def install_signal_handler(signum: Optional[int] = None) -> bool:
    """Dump on a signal (default SIGUSR2) — the attach-a-debugger
    analog for a wedged production process.  Returns False where
    installation is impossible (no such signal on the platform, or not
    the main thread)."""
    import signal as _signal

    signum = signum if signum is not None \
        else getattr(_signal, "SIGUSR2", None)
    if signum is None:
        return False

    def _on_signal(_s, _f):
        # hand off to a thread: the handler preempts the main thread,
        # which may hold FLIGHT._lock or a registry lock — trigger()'s
        # non-reentrant lock acquire + blocking file I/O would wedge
        # the very process the signal is meant to diagnose
        from . import prof as _prof

        _prof.named_thread("flightrec", "signal", FLIGHT.trigger,
                           args=("signal",)).start()

    try:
        _signal.signal(signum, _on_signal)
    except ValueError:
        return False  # signal only works in the main thread
    return True
