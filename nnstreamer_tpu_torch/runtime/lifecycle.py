"""Model lifecycle of a serving pool: hot swap, canary, promote, rollback.

Counterpart of the JAX package's ``runtime/lifecycle.py``, on the port's
pool (``runtime/serving.py``):

- :class:`ModelVersion` / :class:`VersionManager` — a per-
  :class:`~nnstreamer_tpu_torch.runtime.serving.PoolEntry` registry of
  model versions, each with its own
  :class:`~nnstreamer_tpu_torch.utils.stats.InvokeStats`, error count and
  dispatches by bucket.
- **Double-buffered hot swap**: :meth:`VersionManager.stage` resolves a
  (possibly ``@``-versioned, ``filters/modeluri.py``) model reference and
  builds a warmed SHADOW instance off the dispatch path
  (``TorchCudaFilter.prepare_swap``: weights copied to the card, fold
  verdicts taken at every bucket) while the current version serves;
  :meth:`VersionManager.swap` flips at a *window boundary* (the pool
  batcher's flush serialization lock), so no frame is dropped and no
  window mixes versions.  :attr:`VersionManager.last_swap_stall_s` is the
  flip's host time under that lock.
- **Canary**: ``canary=<tag>:1/N`` (a pool-level ``tensor_filter``
  property) routes 1-in-N *streams* to the staged version; a window
  partitions by version and each part dispatches through its version's
  instance, so a failing canary errors only its own streams' buses and
  counts only against its own version.  :meth:`~VersionManager.promote`
  (refused before ``min_canary_frames``) and
  :meth:`~VersionManager.rollback` give the verdict.

Every lifecycle event (stage, swap, canary, promote, rollback, errors) is
kept in ``history`` and noted in the flight recorder
(``obs/flightrec.py``).  Every knob is exposed through the actuator API
(``runtime/actuators.py``, kind ``model``): ``swap`` and ``canary`` take
the model reference as a TEXT value, ``promote``/``rollback`` are
numeric and playbook-drivable; a failed operation raises
:class:`LifecycleError`, an ``ActuationError``.  A checkpoint step
directory (``root@latest``, ``trainers/checkpoint.py``) is a weights-only
swap source: its tree replaces the weights and the serving architecture
stays.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import types
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ..utils.stats import InvokeStats
from .actuators import ActuationError

_log = logging.getLogger("nnstreamer_tpu_torch")

#: version states (staged=0 serving=1 canary=2 retired=3 rolled-back=4)
STATES = ("staged", "serving", "canary", "retired", "rolled-back")

#: default minimum canary frames before ``promote`` is allowed: a canary
#: that served nothing has proven nothing (override per manager, or force)
MIN_CANARY_FRAMES = 16

#: swap/stage/canary/verdict records kept in ``VersionManager.history``
HISTORY_LEN = 64


class LifecycleError(ActuationError):
    """A lifecycle operation that cannot apply (bad canary grammar,
    nothing staged, premature promote); an ``ActuationError``, so a
    controller and the filter's RELOAD_MODEL count it as a failed
    actuation."""


def parse_canary(spec: str) -> Tuple[str, int]:
    """``"<tag>:1/N"`` → ``(tag, N)``; ``""`` → ``("", 0)`` (no canary).
    ``tag`` names the version the split applies to — ``next`` for
    whatever gets staged next; the short form ``"1/N"`` implies it."""
    s = str(spec or "").strip()
    if not s:
        return "", 0
    tag, sep, ratio = s.rpartition(":")
    if not sep:
        tag, ratio = "", s
    tag = tag.strip() or "next"
    num, sep, den = ratio.partition("/")
    try:
        if not sep or int(num) != 1:
            raise ValueError
        n = int(den)
    except ValueError:
        raise LifecycleError(
            f"canary spec {spec!r}: want '<version>:1/N' (or '1/N'), "
            f"e.g. 'next:1/4' — one in N streams routes to the canary"
        ) from None
    if n < 2:
        raise LifecycleError(
            f"canary spec {spec!r}: N must be >= 2 (1/1 is a full swap)")
    return tag, n


class ModelVersion:
    """One version of a pool's model: identity, provenance and its own
    serving stats.  ``subplugin`` serves this version: the pool's shared
    instance for the baseline, the prepared shadow for a staged or
    canary version."""

    def __init__(self, tag: str, source: str, subplugin: Any,
                 state: str = "staged"):
        self.tag = str(tag)
        self.source = str(source)
        self.subplugin = subplugin
        self.state = state
        self.stats = InvokeStats()
        self.errors = 0  # failed dispatches attributed to this version
        self.buckets: Dict[int, int] = {}  # bucket -> dispatches
        self.staged_wall = time.time()
        self.load_s = 0.0  # off-path load + place + warm seconds

    def row(self, pool: str, canary_n: int) -> dict:
        s = self.stats.snapshot()
        return {
            "pool": pool,
            "version": self.tag,
            "state": self.state,
            "source": self.source,
            "invokes": s["invokes"],
            "frames": s["frames"],
            "latency_us": s["latency_us"],
            "errors": self.errors,
            "buckets": dict(sorted(self.buckets.items())),
            "canary_n": canary_n if self.state == "canary" else 0,
            "load_s": self.load_s,
            "staged_wall": self.staged_wall,
        }


class VersionManager:
    """Per-PoolEntry version registry and the swap / canary / promote /
    rollback state machine.

    Mutations serialize on ``self._lock``; the flip also holds the pool
    batcher's flush lock so it lands between windows.  The dispatch path
    reads ``_canary``/``_assign`` only through :meth:`partition` /
    :meth:`subplugin_for` — plain attribute reads, no lock ordering
    against the dispatch."""

    def __init__(self, entry: Any):
        self._entry_ref = weakref.ref(entry)
        self._lock = threading.RLock()
        sp = entry.subplugin
        self.baseline = ModelVersion("v0", self._source_of(sp), sp,
                                     state="serving")
        self._canary: Optional[ModelVersion] = None
        self._staged: Optional[ModelVersion] = None
        self.canary_n = 0
        self.default_canary: Tuple[str, int] = ("", 0)  # canary= property
        self.min_canary_frames = MIN_CANARY_FRAMES
        #: stream routing: id(owner) -> True when it rides the canary
        self._assign: Dict[int, bool] = {}
        self._attach_seq = 0
        self.swaps = 0
        self.promotes = 0
        self.rollbacks = 0
        self._rollback_ref: Optional[ModelVersion] = None
        self.last_swap_stall_s = 0.0
        self.history: List[dict] = []  # bounded provenance trail
        self._actuators: Dict[str, Any] = {}
        self._seq = 0  # version sequence for auto tags

    # -- introspection --------------------------------------------------------

    @property
    def entry(self):
        e = self._entry_ref()
        if e is None:
            raise LifecycleError(
                "model lifecycle: the owning pool entry is gone")
        return e

    @staticmethod
    def _source_of(sp: Any) -> str:
        mn = getattr(sp, "model_name", None)
        return str(mn()) if callable(mn) else ""

    @property
    def canary_active(self) -> bool:
        return self._canary is not None and self.canary_n > 1

    @property
    def engaged(self) -> bool:
        """Whether the lifecycle was used (a stage, swap, canary or
        rollback happened)."""
        with self._lock:
            return bool(self.swaps or self.promotes or self.rollbacks
                        or self._staged is not None
                        or self._canary is not None
                        or len(self.history))

    def versions(self) -> List[ModelVersion]:
        with self._lock:
            out = [self.baseline]
            if self._canary is not None:
                out.append(self._canary)
            if self._staged is not None and self._staged is not self._canary:
                out.append(self._staged)
            return out

    def snapshot_rows(self) -> List[dict]:
        """One row per live version of this pool."""
        label = self._entry_label()
        with self._lock:
            n = self.canary_n
            return [v.row(label, n) for v in self.versions()]

    def summary(self) -> dict:
        """Pool-level lifecycle figures and the live canary/baseline
        comparator pair."""
        with self._lock:
            out = {
                "swaps": self.swaps,
                "promotes": self.promotes,
                "rollbacks": self.rollbacks,
                "canary_n": self.canary_n if self.canary_active else 0,
                "canary_streams": sum(
                    1 for c in self._assign.values() if c),
                "last_swap_stall_s": self.last_swap_stall_s,
            }
            if self.canary_active:
                out["canary_version"] = self._canary.tag
                out["canary_latency_us"] = self._canary.stats.latency_us
                out["baseline_latency_us"] = self.baseline.stats.latency_us
                out["canary_errors"] = self._canary.errors
                out["canary_frames"] = self._canary.stats.total_frame_num
        return out

    def _entry_label(self) -> str:
        e = self._entry_ref()
        return e.label() if e is not None else "?"

    def _note(self, event: str, **data) -> None:
        rec = {"event": event, "wall": time.time(), **data}
        with self._lock:
            self.history.append(rec)
            del self.history[:-HISTORY_LEN]
        from ..obs.flightrec import FLIGHT

        FLIGHT.note("lifecycle", f"{self._entry_label()}:{event}",
                    **{k: v for k, v in data.items()
                       if isinstance(v, (str, int, float, bool))})

    # -- stage ----------------------------------------------------------------

    def stage(self, model: Any, version: str = "",
              warm: bool = True) -> ModelVersion:
        """Load a replacement OFF the dispatch path: resolve the (possibly
        ``@``-versioned) reference, build the warmed shadow through the
        framework's ``prepare_swap`` and park it as the staged version.
        The current version serves throughout.  Staging again replaces a
        staged (un-canaried) version."""
        from ..filters.api import FilterError
        from ..filters.modeluri import resolve_model_uri_versioned

        entry = self.entry
        resolved, tag = resolve_model_uri_versioned(model)
        if isinstance(resolved, str) and os.path.isdir(resolved):
            # a checkpoint (step) directory: weights-only swap — load the
            # tree and keep the serving architecture
            from ..trainers.checkpoint import load_dir

            source = str(resolved)
            try:
                resolved = load_dir(resolved)
            except ValueError as e:
                raise LifecycleError(
                    f"{entry.label()}: staging {source!r} failed: {e}"
                ) from e
        else:
            source = resolved if isinstance(resolved, str) \
                else getattr(resolved, "name", repr(type(resolved)))
        with self._lock:
            self._seq += 1
            version = str(version or tag or f"v{self._seq}")
        sp = entry.subplugin
        t0 = time.perf_counter()
        buckets = entry.buckets if entry.batcher is not None else ()
        try:
            shadow = sp.prepare_swap(resolved, buckets=buckets, warm=warm)
        except FilterError as e:
            raise LifecycleError(
                f"{entry.label()}: staging {source!r} failed: {e}") from e
        ver = ModelVersion(version, f"{source}@{tag}" if tag else source,
                           shadow)
        ver.load_s = time.perf_counter() - t0
        with self._lock:
            self._staged = ver
        self._note("stage", version=version, source=ver.source,
                   load_s=ver.load_s)
        _log.info("%s: staged model version %s (%s) in %.3f s off-path",
                  self._entry_label(), version, ver.source, ver.load_s)
        return ver

    # -- the flip -------------------------------------------------------------

    def _window_boundary(self):
        """The guard the flip holds: the batcher's flush lock, held while
        a window dispatches, so the flip lands BETWEEN windows.  A pool
        without a batcher (per-frame dispatch) flips under an uncontended
        stand-in: the framework's ``_swap_lock`` keeps each dispatch
        consistent."""
        b = self.entry.batcher
        if b is not None:
            return b._flush_serial_lock
        return threading.Lock()

    def swap(self, version: Optional[ModelVersion] = None) -> dict:
        """Commit the staged (or given) version as the serving model at a
        window boundary.  Frames parked in the window ride the next
        dispatch on the new version; nothing drops or re-queues."""
        entry = self.entry
        with self._lock:
            ver = version or self._staged
            if ver is None:
                raise LifecycleError(
                    f"{entry.label()}: nothing staged to swap in (stage a "
                    f"model first)")
        sp = entry.subplugin
        # the OUTGOING state, kept before the flip: after it the shared
        # instance serves the new model, so a swap back needs this holder
        prior_state = _swap_state_of(sp)
        with self._window_boundary():
            t0 = time.perf_counter()
            sp.commit_swap(ver.subplugin)
            stall = time.perf_counter() - t0
        with self._lock:
            old = self.baseline
            old.state = "retired"
            old.subplugin = prior_state
            ver.state = "serving"
            # the new baseline serves through the pool's shared instance;
            # the staged/canary stats carry over
            nb = ModelVersion(ver.tag, ver.source, sp, state="serving")
            nb.stats = ver.stats
            nb.buckets = ver.buckets
            nb.load_s = ver.load_s
            self.baseline = nb
            self._rollback_ref = old
            if self._staged is ver:
                self._staged = None
            if self._canary is ver:
                self._canary = None
                self.canary_n = 0
                self._assign = {}
            self.swaps += 1
            self.last_swap_stall_s = stall
        self._note("swap", version=ver.tag, source=ver.source, stall_s=stall)
        _log.info("%s: hot-swapped to version %s (%s), flip stall %.6f s",
                  self._entry_label(), ver.tag, ver.source, stall)
        return {"version": ver.tag, "stall_s": stall}

    # -- canary ---------------------------------------------------------------

    def start_canary(self, n: int,
                     version: Optional[ModelVersion] = None) -> dict:
        """Route 1-in-``n`` attached streams to the staged version, by
        attach order: the streams with ``seq % n == n - 1`` ride it;
        streams attaching later keep the same law."""
        entry = self.entry
        n = int(n)
        if n < 2:
            raise LifecycleError(
                f"{entry.label()}: canary needs N >= 2 (got {n}); swap for "
                f"a full cutover")
        with self._lock:
            ver = version or self._staged
            if ver is None:
                raise LifecycleError(
                    f"{entry.label()}: nothing staged to canary")
            self._canary = ver
            self._staged = ver  # promote/rollback resolve to it
            ver.state = "canary"
            self.canary_n = n
            self._assign = {}
            self._attach_seq = 0
            for sid in self._stream_ids():
                self._assign[sid] = self._attach_seq % n == n - 1
                self._attach_seq += 1
        routed = sum(1 for c in self._assign.values() if c)
        self._note("canary-start", version=ver.tag, n=n, streams=routed)
        _log.info("%s: canarying version %s on 1-in-%d streams (%d routed)",
                  self._entry_label(), ver.tag, n, routed)
        return {"version": ver.tag, "n": n, "streams": routed}

    def _stream_ids(self) -> List[int]:
        e = self._entry_ref()
        if e is None:
            return []
        return e.stream_ids()

    def on_attach(self, owner: Any) -> None:
        """Keep the 1-in-N law over streams that attach during a canary."""
        with self._lock:
            if not self.canary_active:
                return
            self._assign[id(owner)] = \
                self._attach_seq % self.canary_n == self.canary_n - 1
            self._attach_seq += 1

    def on_detach(self, owner: Any) -> None:
        with self._lock:
            self._assign.pop(id(owner), None)

    def is_canary_stream(self, owner: Any) -> bool:
        return self.canary_active and self._assign.get(id(owner), False)

    def subplugin_for(self, owner: Any) -> Any:
        """The instance serving ``owner``'s frames: the canary shadow for
        a canary-routed stream, else the pool's shared instance."""
        if self.is_canary_stream(owner):
            c = self._canary
            if c is not None:
                return c.subplugin
        return self.entry.subplugin

    def partition(self, items: List[Any]
                  ) -> List[Tuple[ModelVersion, Any, List[Any]]]:
        """Split one window's ``(owner, buf, ...)`` items by version:
        ``[(version, subplugin, items), ...]``, baseline first.  Each
        stream maps to one version, so per-stream FIFO holds."""
        canary = self._canary
        if canary is None or not self.canary_active:
            return [(self.baseline, self.entry.subplugin, items)]
        base_items, canary_items = [], []
        assign = self._assign
        for it in items:
            (canary_items if assign.get(id(it[0]), False)
             else base_items).append(it)
        out = []
        if base_items:
            out.append((self.baseline, self.entry.subplugin, base_items))
        if canary_items:
            out.append((canary, canary.subplugin, canary_items))
        return out or [(self.baseline, self.entry.subplugin, items)]

    # -- verdicts -------------------------------------------------------------

    def promote(self, force: bool = False) -> dict:
        """Commit the canary as the serving version — refused until it
        served ``min_canary_frames`` unless forced."""
        with self._lock:
            ver = self._canary
            if ver is None:
                raise LifecycleError(
                    f"{self._entry_label()}: no canary to promote")
            served = ver.stats.total_frame_num
            if not force and served < self.min_canary_frames:
                raise LifecycleError(
                    f"{self._entry_label()}: canary {ver.tag} served only "
                    f"{served}/{self.min_canary_frames} frames — not enough "
                    f"evidence to promote (force=True overrides)")
        res = self.swap(ver)
        with self._lock:
            self._canary = None
            self.canary_n = 0
            self._assign = {}
            self.promotes += 1
        self._note("promote", version=ver.tag, frames=served)
        _log.info("%s: promoted canary %s after %d frames",
                  self._entry_label(), ver.tag, served)
        return dict(res, promoted=True, frames=served)

    def rollback(self) -> dict:
        """Stop routing to the canary and discard it (the baseline never
        stopped serving, so recovery is immediate); with no canary, swap
        back to the retired pre-swap version.  Check and mutate happen
        under one lock acquisition, so two concurrent rollbacks roll back
        once."""
        prior = None
        with self._lock:
            ver = self._canary
            if ver is not None:
                ver.state = "rolled-back"
                self._canary = None
                if self._staged is ver:
                    self._staged = None
                self.canary_n = 0
                self._assign = {}
                self.rollbacks += 1
            else:
                prior = self._rollback_ref
                self._rollback_ref = None
        if ver is not None:
            self._note("rollback", version=ver.tag, errors=ver.errors,
                       frames=ver.stats.total_frame_num)
            _log.warning("%s: rolled back canary %s (errors=%d after %d "
                         "frames); the baseline keeps serving",
                         self._entry_label(), ver.tag, ver.errors,
                         ver.stats.total_frame_num)
            return {"version": ver.tag, "rolled_back": True, "canary": True}
        if prior is not None and prior.subplugin is not None \
                and getattr(prior.subplugin, "_program", None) is not None:
            try:
                res = self.swap(prior)
            except Exception:
                with self._lock:  # keep the undo on failure
                    self._rollback_ref = prior
                raise
            with self._lock:
                self.rollbacks += 1
            self._note("rollback", version=prior.tag, full_swap=True)
            return dict(res, rolled_back=True, canary=False)
        raise LifecycleError(
            f"{self._entry_label()}: nothing to roll back (no canary "
            f"active, no prior version kept)")

    # -- dispatch-side recording (PoolEntry drives these) ---------------------

    def record(self, version: ModelVersion, latency_s: Optional[float],
               frames: int, streams: int = 1, bucket: int = 0) -> None:
        if latency_s is not None:
            version.stats.record(latency_s, frames=frames, streams=streams)
        else:
            version.stats.count(frames=frames, streams=streams)
        if bucket:
            with self._lock:
                version.buckets[bucket] = version.buckets.get(bucket, 0) + 1

    def record_error(self, version: ModelVersion) -> None:
        with self._lock:
            version.errors += 1

    # -- actuators (runtime/actuators.py kind "model") ------------------------

    def actuators(self) -> Dict[str, Any]:
        """The lifecycle's named knobs on this pool: ``swap`` /
        ``canary`` (text-valued: the model reference), ``promote`` /
        ``rollback`` (numeric, playbook-drivable).  Built once; state
        (cooldowns) persists for the entry's lifetime."""
        with self._lock:
            if self._actuators:
                return self._actuators
        from .actuators import Actuator

        label = self._entry_label()

        def _swap(ref) -> None:
            if isinstance(ref, str) and ref.strip():
                self.stage(ref.strip())
            self.swap()

        def _canary(ref) -> None:
            if isinstance(ref, (int, float)):
                if float(ref) <= 0:
                    # numeric 0 stops the canary without a verdict
                    with self._lock:
                        if self._canary is not None:
                            self._canary.state = "staged"
                            self._staged = self._canary
                        self._canary = None
                        self.canary_n = 0
                        self._assign = {}
                    return
                self.start_canary(int(ref))
                return
            ref = str(ref).strip()
            n = 0
            if ":" in ref and "/" in ref.rsplit(":", 1)[-1]:
                # trailing :1/N ratio on the reference (the version
                # identity rides the reference's own @tag)
                head, _, ratio = ref.rpartition(":")
                try:
                    _, n = parse_canary(ratio)
                    ref = head
                except LifecycleError:
                    n = 0
            if n == 0:
                n = self.default_canary[1] or 2
            if ref:
                self.stage(ref)
            self.start_canary(n)

        built = {
            "swap": Actuator(
                "swap", "model", label,
                get_fn=lambda: self.baseline.tag,
                set_fn=_swap, unit="ref", text=True,
                # revert of a swap IS a rollback: the retained prior
                # executable state flips back (not a re-stage by tag)
                snapshot_fn=lambda: self.baseline.tag,
                restore_fn=lambda prior: self.rollback()),
            "canary": Actuator(
                "canary", "model", label,
                get_fn=lambda: float(self.canary_n),
                set_fn=_canary, unit="ref|1/N", text=True,
                snapshot_fn=lambda: float(self.canary_n),
                restore_fn=lambda prior: _canary(float(prior or 0))),
            "promote": Actuator(
                "promote", "model", label,
                get_fn=lambda: 1.0 if self.canary_active else 0.0,
                set_fn=lambda v: self.promote(force=v >= 2.0)
                if v >= 0.5 else None,
                lo=0.0, hi=2.0, unit="go"),
            "rollback": Actuator(
                "rollback", "model", label,
                get_fn=lambda: 0.0,
                set_fn=lambda v: self.rollback()
                if v >= 0.5 else None,
                lo=0.0, hi=1.0, unit="go"),
        }
        with self._lock:
            if not self._actuators:
                self._actuators = built
            return self._actuators


def _swap_state_of(sp: Any) -> Any:
    """A sub-plugin's live (model, program, fold verdicts) frozen into a
    ``commit_swap``-compatible holder: what a full swap keeps to roll
    back to."""
    with sp._swap_lock:
        model, program = sp._model, sp._program
    with sp._batch_lock:
        verdicts = dict(sp._batch_fold)
    ns = types.SimpleNamespace(_model=model, _program=program,
                               _batch_fold=verdicts)
    ns.model_name = (lambda: model.name if model is not None else "")
    return ns
