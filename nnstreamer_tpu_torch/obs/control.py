"""``nns-ctl`` — the closed-loop controller: rule → playbook → actuation.

Counterpart of the JAX package's ``obs/control.py``: the same playbook
grammar, default playbooks, audit records and ``control`` table.
``obs/watch.py`` turned the registry into alarms; this module turns
alarms into *actions*.  A :class:`Controller` subscribes to a watchdog's
alert state (in-process, or a fleet-scraping watch over the shared
``obs/scrape.py`` client) and maps firing rules through declarative
**playbooks** onto the runtime's **actuator API**
(``runtime/actuators.py``): tighten the admission shed ramp when the
SLO budget burns, widen a pool's batch window when MFU collapses with
roofline headroom to spare, force a half-open probe on a link whose
breaker is stuck open.  Every knob is bounded, cooldown-guarded and
reversible, so the controller can steer the serving plane but cannot
wedge it.

Every decision is itself observability:

- ``nns_control_actions_total{playbook,actuator,outcome}`` counts every
  decision (applied, clamped, cooldown-rejected, guard-held, failed,
  no-target, reverted — rejections are data, not silence);
- ``nns_control_state{kind,target,actuator}`` gauges the last applied
  value per knob;
- a bounded **decision audit ring** records observed series values →
  rule → chosen action → applied/prior values, exported in the registry
  snapshot's ``control`` table (v6), rendered by ``nns-top``'s CONTROL
  section, summarized on ``/healthz``, and noted + dumped by the flight
  recorder on every actuation.

Playbooks load from a TOML/JSON file (``NNS_TPU_TORCH_CTL_PLAYBOOKS``;
grammar below) on top of the built-in :func:`default_playbooks` pack.
``NNS_TPU_TORCH_CTL=<interval_s>`` starts a process-global controller at
first pipeline start (same activation hook as ``NNS_TPU_TORCH_WATCH``),
reusing the env-started watchdog or starting one.  The global obs kill
switch ``NNS_TPU_TORCH_OBS_DISABLE`` makes the whole module strictly inert:
no thread, no actuation, no export.

Playbook grammar (TOML shown; JSON is the same structure under a
top-level ``"playbook"`` list)::

    [[playbook]]
    name = "tighten-admission"
    rule = "slo-burn"           # the watch rule that triggers it
    kind = "pool"               # pool | link
    actuator = "ramp-start"     # runtime/actuators.py catalog
    action = "set"              # set | step | revert
    value = 0.5
    target = "*"                # fnmatch on the target label; the
                                # firing alert's own pool/link label
                                # narrows it further
    cooldown = "10s"            # playbook-level rate limit
    on_resolve = "revert"       # revert | none (when the rule clears)
    guard = ""                  # "" | "mfu-headroom"

:func:`lint_playbook` validates a playbook statically (unknown rule,
unknown actuator).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
import weakref
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import hooks as _hooks
from .metrics import REGISTRY, MetricsRegistry
from .watch import RuleError as _WatchRuleError
from .watch import Watch, _parse_duration

from ..runtime.actuators import (
    KNOWN_ACTUATORS,
    ActuationError,
    Actuator,
    CooldownActive,
    find_actuators,
)

PLAYBOOK_ACTIONS = ("set", "step", "revert")

PLAYBOOK_GUARDS = ("", "mfu-headroom")

ON_RESOLVE = ("none", "revert")

#: the guard's "no headroom" ceiling: with live MFU at/above this (or
#: HBM bandwidth saturated) widening the window buys nothing — the
#: executable is already at its roofline
GUARD_MFU_CEILING = 0.85
GUARD_BW_CEILING = 0.95

#: decision outcomes (the ``outcome`` label on
#: ``nns_control_actions_total``)
OUTCOMES = ("applied", "reverted", "cooldown", "guard-hold", "failed",
            "no-target", "noop")


class PlaybookError(ValueError):
    """Malformed playbook / playbook file."""


@dataclasses.dataclass
class Playbook:
    """One declarative rule→actuation mapping (grammar in the module
    doc)."""

    name: str
    rule: str
    kind: str
    actuator: str
    action: str = "set"
    value: float = 0.0
    target: str = "*"
    cooldown_s: float = 5.0
    on_resolve: str = "none"
    guard: str = ""
    severity: str = ""
    #: only act when the firing alert's offending series carries this
    #: tenant label (tenant attribution — obs/tenantstat.py): a
    #: shed-burn playbook scoped to the tenant whose traffic it should
    #: throttle.  "" = any series (the default, tenant-blind)
    tenant: str = ""

    def __post_init__(self):
        if not str(self.name).strip():
            raise PlaybookError("playbook without a name")
        ctx = f"playbook {self.name!r}"
        for fld in ("rule", "kind", "actuator"):
            if not str(getattr(self, fld)).strip():
                raise PlaybookError(f"{ctx}: no {fld}")
        if self.kind not in KNOWN_ACTUATORS:
            raise PlaybookError(
                f"{ctx}: unknown target kind {self.kind!r}; one of "
                f"{sorted(KNOWN_ACTUATORS)}")
        if self.action not in PLAYBOOK_ACTIONS:
            raise PlaybookError(
                f"{ctx}: unknown action {self.action!r}; one of "
                f"{list(PLAYBOOK_ACTIONS)}")
        if self.on_resolve not in ON_RESOLVE:
            raise PlaybookError(
                f"{ctx}: on_resolve={self.on_resolve!r} not one of "
                f"{list(ON_RESOLVE)}")
        if self.guard not in PLAYBOOK_GUARDS:
            raise PlaybookError(
                f"{ctx}: unknown guard {self.guard!r}; one of "
                f"{[g or '(none)' for g in PLAYBOOK_GUARDS]}")
        if isinstance(self.value, bool) \
                or not isinstance(self.value, (int, float)):
            raise PlaybookError(f"{ctx}: value={self.value!r} must be "
                                f"a number")
        self.value = float(self.value)
        if not isinstance(self.cooldown_s, (int, float)) \
                or isinstance(self.cooldown_s, bool) \
                or self.cooldown_s < 0:
            raise PlaybookError(f"{ctx}: cooldown must be a "
                                f"duration >= 0")
        self.cooldown_s = float(self.cooldown_s)
        if self.action == "step" and self.value == 0.0:
            raise PlaybookError(f"{ctx}: step with value=0 never "
                                f"moves the knob")


_PB_KEY_MAP = {"cooldown": "cooldown_s"}
_PB_FIELDS = {f.name for f in dataclasses.fields(Playbook)}


def parse_playbook(item: dict) -> Playbook:
    if not isinstance(item, dict):
        raise PlaybookError(
            f"playbook entry is not a table/object: {item!r}")
    kw: Dict[str, Any] = {}
    for key, val in item.items():
        fld = _PB_KEY_MAP.get(key, key)
        if fld not in _PB_FIELDS:
            raise PlaybookError(
                f"playbook {item.get('name', '?')!r}: unknown key "
                f"{key!r} (known: "
                f"{sorted(_PB_FIELDS | set(_PB_KEY_MAP))})")
        if fld == "cooldown_s":
            val = _parse_duration(
                val, f"playbook {item.get('name', '?')!r}.{key}")
        kw[fld] = val
    for required in ("name", "rule", "kind", "actuator"):
        if required not in kw:
            raise PlaybookError(
                f"playbook {kw.get('name', '?')!r}: missing "
                f"{required!r}")
    if kw.get("action", "set") != "revert" and "value" not in kw:
        # a forgotten value would silently actuate the dataclass
        # default 0.0 — for the coalescing knob that PAUSES the very
        # window the playbook meant to fix
        raise PlaybookError(
            f"playbook {kw.get('name', '?')!r}: action "
            f"{kw.get('action', 'set')!r} needs an explicit 'value'")
    try:
        return Playbook(**kw)
    except _WatchRuleError as e:  # _parse_duration raises RuleError
        raise PlaybookError(str(e)) from None


def parse_playbooks(doc: Any) -> List[Playbook]:
    """Playbooks from a parsed TOML/JSON document: a top-level
    ``playbook`` (or ``playbooks``) list, or a bare list."""
    if isinstance(doc, dict):
        items = doc.get("playbook", doc.get("playbooks"))
        if items is None:
            raise PlaybookError(
                "playbooks document has no top-level 'playbook' list "
                "([[playbook]] tables in TOML, \"playbook\": [...] in "
                "JSON)")
    else:
        items = doc
    if not isinstance(items, list) or not items:
        raise PlaybookError("playbooks document names no playbooks")
    pbs = [parse_playbook(item) for item in items]
    seen: Dict[str, int] = {}
    for pb in pbs:
        seen[pb.name] = seen.get(pb.name, 0) + 1
    dupes = sorted(n for n, c in seen.items() if c > 1)
    if dupes:
        raise PlaybookError(
            f"duplicate playbook name(s): {dupes} — controller state "
            f"is keyed by name")
    return pbs


def load_playbooks(path: str) -> List[Playbook]:
    """Load + parse a playbook file; ``.toml`` via stdlib tomllib
    (3.11+), anything else as JSON.  Raises :class:`PlaybookError` on
    malformed grammar, ``OSError`` on unreadable files."""
    if str(path).endswith(".toml"):
        try:
            import tomllib
        except ImportError:
            raise PlaybookError(
                "TOML playbook files need Python 3.11+ (tomllib); "
                "use the JSON form instead") from None
        try:
            with open(path, "rb") as f:
                doc = tomllib.load(f)
        except tomllib.TOMLDecodeError as e:
            raise PlaybookError(f"invalid TOML: {e}") from None
    else:
        with open(path, "r", encoding="utf-8") as f:
            try:
                doc = json.load(f)
            except ValueError as e:
                raise PlaybookError(f"invalid JSON: {e}") from None
    return parse_playbooks(doc)


def lint_playbook(pb: Playbook,
                  rule_names: Optional[List[str]] = None) -> List[str]:
    """Static problems with one (well-formed) playbook — the checks
    beyond grammar: an actuator nothing exports, a rule name
    the active rule set never evaluates."""
    problems: List[str] = []
    if pb.actuator not in KNOWN_ACTUATORS.get(pb.kind, ()):
        problems.append(
            f"actuator {pb.actuator!r} does not exist on kind "
            f"{pb.kind!r} (known: "
            f"{list(KNOWN_ACTUATORS.get(pb.kind, ()))})")
    if rule_names is not None and pb.rule not in rule_names:
        problems.append(
            f"rule {pb.rule!r} is not in the active rule set (the "
            f"playbook can never trigger); known rules: "
            f"{sorted(rule_names)}")
    if pb.action == "revert" and pb.on_resolve == "revert":
        problems.append(
            "action=revert with on_resolve=revert is a double "
            "back-out (the resolve revert finds nothing to restore)")
    return problems


def default_playbooks() -> List[Playbook]:
    """The built-in pack, the closed-loop triad:
    SLO burn → shed earlier/harder; MFU collapse with roofline headroom
    → widen the batch window (the clamp at the largest compiled bucket
    is the guard); breaker stuck open → force the half-open probe
    (re-dial) instead of sitting out the open window."""
    P = Playbook
    return [
        P(name="tighten-admission", rule="slo-burn", kind="pool",
          actuator="ramp-start", action="set", value=0.5,
          cooldown_s=10.0, on_resolve="revert"),
        P(name="widen-window", rule="mfu-collapse", kind="pool",
          actuator="max-batch", action="step", value=8.0,
          guard="mfu-headroom", cooldown_s=10.0),
        P(name="widen-deadline", rule="mfu-collapse", kind="pool",
          actuator="window-ms", action="step", value=2.0,
          guard="mfu-headroom", cooldown_s=10.0),
        P(name="redial-link", rule="breaker-open", kind="link",
          actuator="breaker", action="set", value=1.0,
          cooldown_s=2.0),
    ]


def playbooks_from_env() -> List[Playbook]:
    """The active playbook set: ``NNS_TPU_TORCH_CTL_PLAYBOOKS=<file>`` when
    set (replacing the default pack), else :func:`default_playbooks`."""
    path = os.environ.get("NNS_TPU_TORCH_CTL_PLAYBOOKS", "").strip()
    if not path:
        return default_playbooks()
    return load_playbooks(path)


# -- the controller -----------------------------------------------------------


class _PbState:
    __slots__ = ("was_firing", "last_ts", "applied")

    def __init__(self):
        self.was_firing = False
        self.last_ts: Optional[float] = None
        # (kind, target, actuator) keys this playbook steered, for the
        # on_resolve revert
        self.applied: Dict[Tuple[str, str, str], Actuator] = {}


#: live controllers (weak): the snapshot's ``control`` table and
#: ``/healthz`` aggregate over these, exactly like the pool/link tables
_CTL_LOCK = threading.Lock()
_CONTROLLERS: "weakref.WeakSet[Controller]" = weakref.WeakSet()


class Controller:
    """The actuation loop: watch alert state → playbooks → actuators.

    ``watch`` is the alert source (an :class:`~nnstreamer_tpu_torch.obs.
    watch.Watch`, in-process or fleet-scraping — the controller only
    reads its rule states); actuation targets are always the objects of
    THIS process (``runtime/actuators.py`` discovery).  Strictly inert
    under ``NNS_TPU_TORCH_OBS_DISABLE``: no thread, no actuation, no
    export."""

    def __init__(self, playbooks: Optional[List[Playbook]] = None,
                 watch: Optional[Watch] = None,
                 interval_s: float = 0.5,
                 registry: Optional[MetricsRegistry] = None,
                 audit_len: int = 256):
        self.playbooks = list(playbooks) if playbooks is not None \
            else default_playbooks()
        seen = set()
        for pb in self.playbooks:
            if pb.name in seen:
                raise PlaybookError(f"duplicate playbook {pb.name!r}")
            seen.add(pb.name)
        self.watch = watch
        self.interval_s = max(float(interval_s), 0.01)
        self.registry = registry if registry is not None else REGISTRY
        self.enabled = not _hooks.DISABLED
        self.audit: Deque[dict] = collections.deque(
            maxlen=int(audit_len))
        self.actions_total = 0
        self.last_action: Optional[dict] = None
        self.ticks = 0
        self._states: Dict[str, _PbState] = {
            pb.name: _PbState() for pb in self.playbooks}
        self._lock = threading.RLock()
        # LEAF lock for the audit/export state (_record writes,
        # snapshot/control_table/control_health read).  It exists so
        # the scrape path — registry.snapshot() → control_table(),
        # possibly called by a Watch sampler HOLDING the watch lock —
        # never needs self._lock, which tick() holds WHILE taking the
        # watch lock (alerts(), guard reads).  One lock for both paths
        # is a lock-order inversion: tick holds ctl→wants watch, the
        # sampler holds watch→wants ctl.
        self._alock = threading.Lock()  # nns-lock: leaf
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if self.enabled:
            self._actions = self.registry.counter(
                "nns_control_actions_total",
                "controller decisions by outcome (obs/control.py)",
                labelnames=("playbook", "actuator", "outcome"))
            self._state_gauge = self.registry.gauge(
                "nns_control_state",
                "last applied value of a steered knob",
                labelnames=("kind", "target", "actuator"))
            with _CTL_LOCK:
                _CONTROLLERS.add(self)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> bool:
        """Spawn the actuation loop (False — and strictly nothing else
        — under the global obs kill switch)."""
        if not self.enabled or self._thread is not None:
            return False
        self._stop.clear()
        from . import prof as _prof

        self._thread = _prof.named_thread("ctl", "actuator", self._run)
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 - the controller must
                # outlive whatever it steers; one bad tick is logged,
                # not fatal
                from ..utils.log import logw

                logw("nns-ctl: tick failed: %s: %s",
                     type(e).__name__, e)

    # -- one tick -------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One control round: read alert state, run due playbooks,
        revert resolved ones.  Returns this tick's decisions."""
        if not self.enabled:
            return []
        with self._lock:
            now = time.monotonic() if now is None else now
            self.ticks += 1
            alerts = {a["rule"]: a for a in self.watch.alerts()} \
                if self.watch is not None else {}
            decisions: List[dict] = []
            for pb in self.playbooks:
                st = self._states[pb.name]
                a = alerts.get(pb.rule)
                firing = bool(a and a["firing"]) and (
                    not pb.severity or a["severity"] == pb.severity)
                if firing and pb.tenant:
                    # tenant-scoped playbook: the offending series
                    # must name this tenant (forecast/threshold rules
                    # over nns_tenant_* families carry the label)
                    series = ((a.get("detail") or {})
                              .get("series") or {})
                    firing = series.get("tenant") == pb.tenant
                if firing:
                    decisions.extend(self._fire(pb, st, a, now))
                elif st.was_firing and pb.on_resolve == "revert":
                    decisions.extend(self._resolve(pb, st, now))
                st.was_firing = firing
            return decisions

    def _observed(self, alert: Optional[dict]) -> dict:
        d = (alert or {}).get("detail") or {}
        return {"metric": d.get("metric", ""),
                "value": d.get("value"),
                "series": dict(d.get("series") or {})}

    def _fire(self, pb: Playbook, st: _PbState, alert: dict,
              now: float) -> List[dict]:
        if st.last_ts is not None \
                and now - st.last_ts < pb.cooldown_s:
            return []  # playbook-level pacing: not even a decision —
            # the episode was already acted on this cooldown window
        observed = self._observed(alert)
        base = {"rule": pb.rule, "playbook": pb.name, "kind": pb.kind,
                "actuator": pb.actuator, "action": pb.action,
                "observed": observed}
        if pb.guard and not self._guard_passes(pb.guard):
            st.last_ts = now
            return [self._record(dict(
                base, target=pb.target, requested=pb.value,
                applied=None, prior=None, clamped=False,
                outcome="guard-hold", guard=pb.guard), now)]
        acts = self._resolve_targets(pb, observed["series"])
        if not acts:
            st.last_ts = now
            return [self._record(dict(
                base, target=pb.target, requested=pb.value,
                applied=None, prior=None, clamped=False,
                outcome="no-target"), now)]
        st.last_ts = now
        out = []
        for act in acts:
            out.append(self._record(
                self._execute(pb, st, act, base, now), now))
        return out

    def _resolve(self, pb: Playbook, st: _PbState,
                 now: float) -> List[dict]:
        out = []
        applied, st.applied = st.applied, {}
        for (kind, target, name), act in applied.items():
            base = {"rule": pb.rule, "playbook": pb.name,
                    "kind": kind, "actuator": name, "action": "revert",
                    "target": target,
                    "observed": {"metric": "", "value": None,
                                 "series": {}, "resolved": True}}
            try:
                res = act.revert(now=now)
            except ActuationError as e:
                out.append(self._record(dict(
                    base, requested=None, applied=None, prior=None,
                    clamped=False, outcome="failed", error=str(e)),
                    now))
                continue
            if res is None:
                out.append(self._record(dict(
                    base, requested=None, applied=None, prior=None,
                    clamped=False, outcome="noop"), now))
                continue
            out.append(self._record(dict(
                base, requested=None, applied=res["applied"],
                prior=res["prior"], clamped=False,
                outcome="reverted"), now))
        return out

    def _execute(self, pb: Playbook, st: _PbState, act: Actuator,
                 base: dict, now: float) -> dict:
        d = dict(base, target=act.target, requested=pb.value,
                 applied=None, prior=None, clamped=False)
        try:
            if pb.action == "revert":
                res = act.revert(now=now)
                if res is None:
                    return dict(d, outcome="noop")
                return dict(d, requested=None,
                            applied=res["applied"],
                            prior=res["prior"], outcome="reverted")
            value = pb.value
            if pb.action == "step":
                cur = act.read()
                if cur is None or not isinstance(cur, (int, float)):
                    return dict(d, outcome="failed",
                                error="current value unreadable")
                value = float(cur) + pb.value
            res = act.actuate(value, now=now)
            if pb.on_resolve == "revert":
                # only revert-on-resolve playbooks need the actuator
                # back; holding it otherwise would pin the pool/link
                # the closures capture for the controller's lifetime
                st.applied[(act.kind, act.target, act.name)] = act
            return dict(d, requested=value, applied=res["applied"],
                        prior=res["prior"], clamped=res["clamped"],
                        outcome="applied")
        except CooldownActive as e:
            return dict(d, outcome="cooldown", error=str(e))
        except ActuationError as e:
            return dict(d, outcome="failed", error=str(e))

    def _resolve_targets(self, pb: Playbook,
                         series: Dict[str, str]) -> List[Actuator]:
        """The firing alert's own labels narrow the playbook's target
        pattern: an alert on pool X steers pool X, not every pool.
        Model-lifecycle knobs target pools too (a canary alert carries
        the pool label of the versions it compares)."""
        label = series.get("pool") if pb.kind in ("pool", "model") \
            else series.get("link")
        target = pb.target or "*"
        acts = find_actuators(pb.kind, target, pb.actuator)
        if label:
            exact = [a for a in acts if a.target == label]
            if exact:
                return exact
            # the alert names an object this process doesn't own (a
            # fleet-scraped alert): fall through to the pattern — the
            # operator chose the playbook's blast radius via target=
        return acts

    def _guard_passes(self, guard: str) -> bool:
        """``mfu-headroom``: act only while the roofline says a wider
        window can help — live MFU below the ceiling and HBM bandwidth
        not saturated.  With no MFU series at all (unknown backend)
        headroom is unknowable and the guard stands aside."""
        if guard != "mfu-headroom" or self.watch is None:
            return True
        with self.watch._lock:
            mfus = [s.last("level")
                    for _k, s in self.watch.store.match("nns_mfu", {})]
            bws = [s.last("level")
                   for _k, s in self.watch.store.match(
                       "nns_hbm_bw_util", {})]
        mfus = [p[1] for p in mfus if p is not None]
        bws = [p[1] for p in bws if p is not None]
        if not mfus:
            return True
        if max(mfus) >= GUARD_MFU_CEILING:
            return False
        if bws and max(bws) >= GUARD_BW_CEILING:
            return False
        return True

    # -- the audit trail ------------------------------------------------------

    def _record(self, decision: dict, now: float) -> dict:
        """EVERY decision — applied or rejected — lands in the audit
        ring AND the exported counter (the bench gate asserts the two
        counts equal), is gauged when it moved a knob, and is noted +
        dumped by the flight recorder."""
        decision = dict(decision, ts=now, wall=time.time())
        with self._alock:
            self.audit.append(decision)
            self.actions_total += 1
            self.last_action = decision
        self._actions.labels(
            playbook=decision["playbook"],
            actuator=decision["actuator"],
            outcome=decision["outcome"]).inc()
        applied = decision.get("applied")
        if isinstance(applied, (int, float)) \
                and not isinstance(applied, bool):
            self._state_gauge.labels(
                kind=decision["kind"], target=decision["target"],
                actuator=decision["actuator"]).set(float(applied))
        from ..utils.log import logw

        logw("nns-ctl: %s %s.%s[%s] %s -> %s (%s)",
             decision["playbook"], decision["kind"],
             decision["actuator"], decision["target"],
             decision.get("prior"), applied, decision["outcome"])
        from .flightrec import FLIGHT

        FLIGHT.note("actuation", decision["playbook"],
                    actuator=decision["actuator"],
                    target=decision["target"],
                    outcome=decision["outcome"],
                    applied=applied, prior=decision.get("prior"))
        FLIGHT.trigger_async("actuation", decision["playbook"])
        return decision

    def apply(self, kind: str, target: str, actuator: str,
              value: Optional[float] = None,
              revert: bool = False) -> List[dict]:
        """Manual actuation (the ``nns-ctl --apply/--revert`` path):
        routed through the same guard/audit/export machinery as a
        playbook decision, under the reserved playbook name
        ``manual``.  A no-op (empty list) while obs is disabled."""
        if not self.enabled:
            return []
        with self._lock:
            now = time.monotonic()
            base = {"rule": "", "playbook": "manual", "kind": kind,
                    "actuator": actuator,
                    "action": "revert" if revert else "set",
                    "observed": {"metric": "", "value": None,
                                 "series": {}}}
            acts = find_actuators(kind, target or "*", actuator)
            if not acts:
                return [self._record(dict(
                    base, target=target or "*", requested=value,
                    applied=None, prior=None, clamped=False,
                    outcome="no-target"), now)]
            out = []
            for act in acts:
                d = dict(base, target=act.target, requested=value,
                         applied=None, prior=None, clamped=False)
                try:
                    if revert:
                        res = act.revert(now=now)
                        if res is None:
                            out.append(self._record(
                                dict(d, outcome="noop"), now))
                            continue
                        out.append(self._record(dict(
                            d, applied=res["applied"],
                            prior=res["prior"], outcome="reverted"),
                            now))
                    else:
                        # text knobs (the lifecycle's swap/canary)
                        # take the raw string — a model reference is
                        # not a number
                        v = value if (getattr(act, "text", False)
                                      and isinstance(value, str)) \
                            else float(value)
                        res = act.actuate(v, now=now)
                        out.append(self._record(dict(
                            d, applied=res["applied"],
                            prior=res["prior"],
                            clamped=res["clamped"],
                            outcome="applied"), now))
                except CooldownActive as e:
                    out.append(self._record(dict(
                        d, outcome="cooldown", error=str(e)), now))
                except ActuationError as e:
                    out.append(self._record(dict(
                        d, outcome="failed", error=str(e)), now))
            return out

    # -- pull side ------------------------------------------------------------

    def snapshot(self, recent: int = 32) -> dict:
        with self._alock:
            return {
                "playbooks": [pb.name for pb in self.playbooks],
                "actions_total": self.actions_total,
                "last_action": dict(self.last_action)
                if self.last_action else None,
                "audit": [dict(d) for d in
                          list(self.audit)[-int(recent):]],
            }


# -- snapshot/healthz integration (pulled by obs/metrics.py) ------------------


def _live_controllers() -> List[Controller]:
    with _CTL_LOCK:
        return list(_CONTROLLERS)


def control_table(recent: int = 32) -> dict:
    """The snapshot's ``control`` table (v6): every live controller's
    playbooks, decision totals and recent audit entries aggregated —
    empty-but-present when no controller runs, so the top-level
    snapshot shape is stable."""
    ctls = _live_controllers()
    snaps = [c.snapshot(recent=recent) for c in ctls]
    audit = sorted((d for s in snaps for d in s["audit"]),
                   key=lambda d: d.get("ts", 0.0))[-int(recent):]
    last = None
    for s in snaps:
        la = s["last_action"]
        if la and (last is None or la.get("ts", 0) > last.get("ts", 0)):
            last = la
    return {
        "controllers": len(ctls),
        "playbooks": sorted({n for s in snaps for n in s["playbooks"]}),
        "actions_total": sum(s["actions_total"] for s in snaps),
        "last_action": last,
        "audit": audit,
    }


def control_health() -> dict:
    """Cheap controller summary for ``/healthz``: playbooks loaded,
    decision count, last action — no full audit walk."""
    ctls = _live_controllers()
    last = None
    total = 0
    names: set = set()
    for c in ctls:
        with c._alock:
            total += c.actions_total
            la = c.last_action
        names.update(pb.name for pb in c.playbooks)
        if la and (last is None or la.get("ts", 0) > last.get("ts", 0)):
            last = la
    return {
        "controllers": len(ctls),
        "playbooks": sorted(names),
        "actions_total": total,
        "last_action": {
            "playbook": last["playbook"], "actuator": last["actuator"],
            "target": last["target"], "outcome": last["outcome"],
            "wall": last["wall"]} if last else None,
    }


# -- process-global controller (env hook) -------------------------------------

CONTROLLER: Optional[Controller] = None

_env_checked = False


def maybe_start_from_env() -> None:
    """``NNS_TPU_TORCH_CTL=<interval_s>`` starts a process-global controller
    on first pipeline start, with playbooks from
    ``NNS_TPU_TORCH_CTL_PLAYBOOKS`` (or the default pack) and the env-started
    watchdog as its alert source (starting one with the default rule
    pack when ``NNS_TPU_TORCH_WATCH`` wasn't set — a controller without
    alarms would be deaf).  A no-op under the global obs kill
    switch."""
    global _env_checked, CONTROLLER
    if _env_checked:
        return
    _env_checked = True
    spec = os.environ.get("NNS_TPU_TORCH_CTL", "").strip()
    if not spec or _hooks.DISABLED:
        return
    from . import watch as _watch

    try:
        interval = float(spec) if spec not in ("1", "true", "yes") \
            else 1.0
        if _watch.WATCH is None:
            _watch.WATCH = Watch(rules=_watch.rules_from_env(),
                                 interval_s=min(interval, 1.0))
            _watch.WATCH.start()
        CONTROLLER = Controller(playbooks=playbooks_from_env(),
                                watch=_watch.WATCH,
                                interval_s=interval)
        CONTROLLER.start()
    except (ValueError, PlaybookError, _WatchRuleError, OSError) as e:
        from ..utils.log import logw

        logw("cannot start controller from NNS_TPU_TORCH_CTL=%s: %s",
             spec, e)


# -- CLI (`nns-ctl`) ----------------------------------------------------------


def _render_actuators(acts: List[Actuator]) -> str:
    lines = [f"{'KIND':<6}{'TARGET':<28}{'ACTUATOR':<13}{'VALUE':>10}"
             f"{'LO':>8}{'HI':>9}{'UNIT':>8}{'CD s':>6}{'DIRTY':>7}"]
    for a in acts:
        d = a.describe()
        val = d["value"]
        lines.append(
            f"{d['kind']:<6}{d['target']:<28.28}{d['actuator']:<13.13}"
            + (f"{val:.3g}" if isinstance(val, (int, float))
               else "-").rjust(10)
            + (f"{d['lo']:g}" if d["lo"] is not None else "-").rjust(8)
            + (f"{d['hi']:g}" if d["hi"] is not None else "-").rjust(9)
            + str(d["unit"] or "-").rjust(8)
            + f"{d['cooldown_s']:g}".rjust(6)
            + ("yes" if d["dirty"] else "no").rjust(7))
    return "\n".join(lines)


def render_audit(audit: List[dict], indent: str = "") -> str:
    """Decision rows as one table — the ONE renderer behind both
    ``nns-ctl --audit`` and ``nns-top``'s CONTROL section."""
    lines = [indent + f"{'PLAYBOOK':<20}{'RULE':<18}{'ACTUATOR':<13}"
                      f"{'TARGET':<24}{'VALUE':>10}{'OUTCOME':>11}"]
    for d in audit:
        applied = d.get("applied")
        lines.append(
            indent + f"{d.get('playbook', '?'):<20.20}"
            f"{d.get('rule', '') or '-':<18.18}"
            f"{d.get('actuator', '?'):<13.13}"
            f"{str(d.get('target', '?')):<24.24}"
            + (f"{applied:.3g}" if isinstance(applied, (int, float))
               and not isinstance(applied, bool)
               else "-").rjust(10)
            + str(d.get("outcome", "?")).rjust(11))
    return "\n".join(lines)


_render_audit = render_audit  # CLI-internal alias


def _parse_spec(spec: str) -> Tuple[str, str, str, Optional[Any]]:
    """``kind:target:actuator[=value]`` → parts (the --apply/--revert
    grammar; target may itself contain ``:`` — kind is the first
    segment, the actuator name the last).  Non-numeric values pass
    through as strings for the text-valued lifecycle knobs
    (``model:<pool>:swap=file://new.pkl@v2``)."""
    head, _, val = spec.partition("=")
    parts = head.split(":")
    if len(parts) < 3:
        raise ValueError(
            f"bad actuation spec {spec!r} (want "
            f"kind:target:actuator[=value])")
    kind, target, name = parts[0], ":".join(parts[1:-1]), parts[-1]
    if not val:
        return kind, target, name, None
    try:
        return kind, target, name, float(val)
    except ValueError:
        return kind, target, name, val


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="nns-torch-ctl",
        description="Closed-loop controller over the actuator API: "
                    "list knobs, actuate, audit, or run the "
                    "rule→playbook loop")
    p.add_argument("--list", action="store_true",
                   help="list every live actuator (value, bounds, "
                        "cooldown)")
    p.add_argument("--apply", metavar="KIND:TARGET:ACTUATOR=VALUE",
                   action="append", default=[],
                   help="one manual actuation (repeatable; audited "
                        "like a playbook decision)")
    p.add_argument("--revert", metavar="KIND:TARGET:ACTUATOR",
                   action="append", default=[],
                   help="restore a knob's pre-steering config")
    p.add_argument("--audit", action="store_true",
                   help="print the decision audit ring")
    p.add_argument("--run", action="store_true",
                   help="run the controller loop (rules + playbooks)")
    p.add_argument("--playbooks", default=None, metavar="FILE",
                   help="TOML/JSON playbook file (default: "
                        "$NNS_TPU_TORCH_CTL_PLAYBOOKS, else the built-in "
                        "pack)")
    p.add_argument("--rules", default=None, metavar="FILE",
                   help="watch rules file for --run (default: "
                        "$NNS_TPU_TORCH_WATCH_RULES, else the built-in "
                        "pack)")
    p.add_argument("--connect", metavar="HOST:PORT[,HOST:PORT...]",
                   action="append", default=None,
                   help="watch remote /json endpoints for --run "
                        "(alert source only; actuation targets are "
                        "in-process)")
    p.add_argument("--interval", type=float, default=0.5,
                   help="seconds between control rounds (default 0.5)")
    p.add_argument("--once", type=int, default=None, metavar="N",
                   help="with --run: N watch+control rounds, print "
                        "the audit, exit")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="machine-readable output")
    return p


def main(argv=None, out=None) -> int:
    import sys

    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    if not (args.list or args.apply or args.revert or args.audit
            or args.run):
        build_parser().print_usage(sys.stderr)
        print("error: nothing to do (use --list, --apply, --revert, "
              "--audit or --run)", file=sys.stderr)
        return 2
    if _hooks.DISABLED:
        print("nns-ctl: observability disabled (NNS_TPU_TORCH_OBS_DISABLE) "
              "— nothing to do", file=sys.stderr)
        return 2
    from ..runtime.actuators import list_actuators

    if args.list:
        acts = list_actuators()
        if args.as_json:
            print(json.dumps([a.describe() for a in acts], indent=1),
                  file=out)
        else:
            print(_render_actuators(acts), file=out)
        if not (args.apply or args.revert or args.run or args.audit):
            return 0
    try:
        playbooks = load_playbooks(args.playbooks) if args.playbooks \
            else playbooks_from_env()
    except (PlaybookError, OSError) as e:
        print(f"nns-ctl: bad playbooks: {e}", file=sys.stderr)
        return 2
    if args.apply or args.revert:
        ctl = Controller(playbooks=playbooks, watch=None)
        decisions = []
        try:
            for spec in args.apply:
                kind, target, name, value = _parse_spec(spec)
                if value is None:
                    raise ValueError(f"--apply {spec!r} needs =VALUE")
                decisions.extend(ctl.apply(kind, target, name,
                                           value=value))
            for spec in args.revert:
                kind, target, name, _v = _parse_spec(spec)
                decisions.extend(ctl.apply(kind, target, name,
                                           revert=True))
        except ValueError as e:
            print(f"nns-ctl: {e}", file=sys.stderr)
            return 2
        if args.as_json:
            print(json.dumps(decisions, indent=1, default=str),
                  file=out)
        else:
            print(_render_audit(decisions), file=out)
        bad = [d for d in decisions
               if d["outcome"] not in ("applied", "reverted", "noop")]
        return 1 if bad else 0
    if args.audit and not args.run:
        table = control_table(recent=64)
        if args.as_json:
            print(json.dumps(table, indent=1, default=str), file=out)
        else:
            print(_render_audit(table["audit"]), file=out)
        return 0
    # --run
    from . import watch as _watch

    try:
        rules = _watch.load_rules(args.rules) if args.rules \
            else _watch.rules_from_env()
    except (_WatchRuleError, OSError) as e:
        print(f"nns-ctl: bad rules: {e}", file=sys.stderr)
        return 2
    endpoints: List[str] = []
    for item in args.connect or []:
        endpoints.extend(tok.strip() for tok in str(item).split(",")
                         if tok.strip())
    w = Watch(rules=rules, interval_s=args.interval,
              endpoints=endpoints or None)
    ctl = Controller(playbooks=playbooks, watch=w,
                     interval_s=args.interval)
    try:
        if args.once is not None:
            for i in range(max(args.once, 1)):
                if i:
                    time.sleep(args.interval)
                w.sample_once()
                ctl.tick()
            snap = ctl.snapshot(recent=64)
            if args.as_json:
                print(json.dumps(snap, indent=1, default=str),
                      file=out)
            else:
                print(_render_audit(snap["audit"]), file=out)
            return 0
        w.start()
        ctl.start()
        while True:
            time.sleep(max(args.interval, 0.1))
    except KeyboardInterrupt:
        return 0
    finally:
        ctl.stop()
        w.stop()


if __name__ == "__main__":
    import sys

    sys.exit(main())
