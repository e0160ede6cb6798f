"""The actuator API — named, bounded, reversible runtime knobs.

Counterpart of the JAX package's ``runtime/actuators.py``, with the same
kinds, knob names, bounds and actuation records.  Observability made the
serving runtime *measurable*; this module makes it *steerable* without
making it *wreckable*.  Every
steerable object (a serving :class:`~nnstreamer_tpu_torch.runtime.serving.
PoolEntry`'s cross-stream window, its admission controller, an edge
link's :class:`~nnstreamer_tpu_torch.chaos.retrypolicy.RetryPolicy` breaker)
exposes a small set of :class:`Actuator` s — each one a **named**
operation with a **guard**:

- **bounded** — numeric requests clamp to ``[lo, hi]`` (the clamp is
  reported, never silent), so an external controller can nudge a batch
  window but can never set a 0-frame batch or a 10-minute deadline;
- **cooldown** — a minimum interval between actuations of the same
  knob (:class:`CooldownActive` rejection, counted by the caller), so
  an oscillating rule cannot saw a knob at sampler frequency;
- **reversible** — the first actuation snapshots the prior
  configuration; :meth:`Actuator.revert` restores it *exactly* (not
  just "a similar value": per-stream maps restore per stream).

Actuators read and write their target **through the owning entry**, not
through a captured object: a pool whose batcher was torn down by
``Pipeline.stop()`` raises a clean :class:`ActuationError` from the
racing actuation instead of poking a dead window — the same contract
as the registry's scrape-vs-stop tolerance.

Discovery: :func:`list_actuators` walks the process-wide steerable
objects (``MODEL_POOL`` entries, registered ``RetryPolicy`` links) at
call time — like the metrics registry, nothing is pushed; targets
appear and disappear with the objects that own them.  The controller
(``obs/control.py``) and ``nns-ctl`` both resolve targets through this
one function.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.profile import GATE

#: default minimum seconds between actuations of one knob
DEFAULT_COOLDOWN_S = 0.5

#: actuator names by target kind — the static catalog a playbook is
#: linted against (``obs/control.py`` ``lint_playbook``: a playbook
#: naming an actuator nothing exports can never act)
KNOWN_ACTUATORS: Dict[str, Tuple[str, ...]] = {
    "pool": ("window-ms", "max-batch", "coalescing", "ramp-start",
             "queue-limit"),
    "link": ("breaker",),
    # model lifecycle (runtime/lifecycle.py): swap/canary take the
    # model reference as a TEXT value; promote/rollback are numeric
    # (playbook-drivable verdict knobs)
    "model": ("swap", "canary", "promote", "rollback"),
}


class ActuationError(ValueError):
    """An actuation could not apply (target gone, guard violated)."""


class CooldownActive(ActuationError):
    """Rejected: the knob was actuated more recently than its
    cooldown allows."""


class Actuator:
    """One named, bounded, reversible knob on one target.

    ``get_fn``/``set_fn`` read/write the live value (raising
    :class:`ActuationError` when the underlying object is gone);
    ``snapshot_fn``/``restore_fn`` optionally override how the prior
    configuration is captured and restored when a scalar is not enough
    (e.g. per-stream queue limits restore per stream).
    """

    def __init__(self, name: str, kind: str, target: str,
                 get_fn: Callable[[], Any],
                 set_fn: Callable[[float], None],
                 lo: Optional[float] = None, hi: Optional[float] = None,
                 unit: str = "", cooldown_s: float = DEFAULT_COOLDOWN_S,
                 snapshot_fn: Optional[Callable[[], Any]] = None,
                 restore_fn: Optional[Callable[[Any], None]] = None,
                 text: bool = False):
        self.name = name
        self.kind = kind
        self.target = target
        self.unit = unit
        #: text=True: the knob consumes a STRING value (a model
        #: reference on the lifecycle's swap/canary knobs) — no
        #: clamping; numeric values still pass through for knobs that
        #: accept both (canary N)
        self.text = bool(text)
        self.lo = lo
        self.hi = hi
        self.cooldown_s = float(cooldown_s)
        self._get = get_fn
        self._set = set_fn
        self._snapshot = snapshot_fn or get_fn
        self._restore = restore_fn or (lambda prior: set_fn(prior))
        self._lock = threading.Lock()
        self._last_ts: Optional[float] = None
        #: prior config captured at the FIRST deviation, consumed by
        #: revert() — "reversible" means the exact pre-steering state
        self._initial: Any = None
        self._dirty = False

    # -- introspection --------------------------------------------------------

    def read(self) -> Any:
        """Current value (None when the target is gone)."""
        try:
            return self._get()
        except ActuationError:
            return None

    def describe(self) -> dict:
        with self._lock:
            dirty = self._dirty
        return {"kind": self.kind, "target": self.target,
                "actuator": self.name, "value": self.read(),
                "lo": self.lo, "hi": self.hi, "unit": self.unit,
                "cooldown_s": self.cooldown_s, "dirty": dirty}

    def clamp(self, value: float) -> float:
        if self.text and isinstance(value, str):
            return value  # text knobs take references, not numbers
        v = float(value)
        if self.lo is not None:
            v = max(v, self.lo)
        if self.hi is not None:
            v = min(v, self.hi)
        return v

    # -- the guarded write ----------------------------------------------------

    def actuate(self, value: float,
                now: Optional[float] = None) -> dict:
        """Apply ``value`` (clamped, cooldown-guarded).  Returns the
        actuation record; raises :class:`CooldownActive` on a too-soon
        repeat and :class:`ActuationError` when the target is gone.
        Runs inside the profiler's gate (``utils/profile.py``): a
        setter may run the model (a bucket check, a swap)."""
        with GATE.inside(), self._lock:
            now = time.monotonic() if now is None else now
            if self._last_ts is not None \
                    and now - self._last_ts < self.cooldown_s:
                raise CooldownActive(
                    f"{self.target}.{self.name}: cooldown "
                    f"({self.cooldown_s:g}s) active — "
                    f"{now - self._last_ts:.2f}s since last actuation")
            prior = self._get()
            applied = self.clamp(value)
            if not self._dirty:
                self._initial = self._snapshot()
                self._dirty = True
            self._set(applied)
            self._last_ts = now
            requested = value if (self.text and isinstance(value, str)) \
                else float(value)
            return {"kind": self.kind, "target": self.target,
                    "actuator": self.name,
                    "requested": requested, "applied": applied,
                    "prior": prior,
                    "clamped": applied != requested}

    def revert(self, now: Optional[float] = None) -> Optional[dict]:
        """Restore the exact pre-steering configuration (None when
        nothing was ever applied).  Bypasses the cooldown — backing out
        is always allowed — but stamps it, so the next forward
        actuation still waits."""
        with GATE.inside(), self._lock:
            if not self._dirty:
                return None
            now = time.monotonic() if now is None else now
            prior = self._get()
            initial = self._initial
            self._restore(initial)
            self._dirty = False
            self._initial = None
            self._last_ts = now
            return {"kind": self.kind, "target": self.target,
                    "actuator": self.name, "requested": None,
                    "applied": initial, "prior": prior,
                    "clamped": False, "reverted": True}


# -- discovery ----------------------------------------------------------------


def _pool_sets() -> List[Tuple[str, Dict[str, Actuator]]]:
    from .serving import MODEL_POOL

    return [(entry.label(), entry.actuators())
            for entry in MODEL_POOL.entries()]


def _link_sets() -> List[Tuple[str, Dict[str, Actuator]]]:
    from ..chaos.retrypolicy import RetryPolicy

    return [(pol.name or "link", pol.actuators())
            for pol in RetryPolicy.all_policies()]


def _model_sets() -> List[Tuple[str, Dict[str, Actuator]]]:
    """Model-lifecycle knobs (runtime/lifecycle.py): one set per live
    pool entry — swapping/canarying is a pool-level operation, so the
    targets mirror the pool actuators' labels."""
    from .serving import MODEL_POOL

    return [(entry.label(), entry.lifecycle.actuators())
            for entry in MODEL_POOL.entries()]


def list_actuators(kind: Optional[str] = None) -> List[Actuator]:
    """Every live actuator in the process, pools first (stable order
    within a scrape; targets come and go with their owners)."""
    out: List[Actuator] = []
    if kind in (None, "pool"):
        for _label, acts in _pool_sets():
            out.extend(acts.values())
    if kind in (None, "model"):
        for _label, acts in _model_sets():
            out.extend(acts.values())
    if kind in (None, "link"):
        for _label, acts in _link_sets():
            out.extend(acts.values())
    return out


def find_actuators(kind: str, target: str,
                   name: str) -> List[Actuator]:
    """Actuators matching ``(kind, target-glob, name)`` — possibly
    several (two links may share a name), possibly none (the caller
    reports ``no-target``, it is not an exception)."""
    import fnmatch

    out = []
    for act in list_actuators(kind):
        if act.name != name:
            continue
        if target and target != "*" \
                and not fnmatch.fnmatch(act.target, target):
            continue
        out.append(act)
    return out
