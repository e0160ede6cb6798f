"""NNS510/NNS517/NNS518 — static validation of ``obs/watch.py`` rules

Counterpart of the JAX package's ``analyze/watchrules.py``, over the port's
modules.
files and the host-profiler environment.

A watch rule that references a metric family the registry never
exports, or that cannot parse at all, fails in the worst possible way:
*silently*, at 3am, by not firing.  This pass loads a TOML/JSON rules
file (the same loader the watchdog uses — one grammar, one error
surface) WITHOUT starting anything and reports:

- malformed grammar (unknown keys/kinds/ops, bad durations, duplicate
  names, unreadable/unparseable files) — the exact :class:`RuleError`
  the watchdog would raise at startup;
- rules that can never fire: unknown metric family, a signal that
  cannot exist for the family's kind (``rate`` on a gauge, ``p99`` on
  a counter), ratio/burn shapes that can never bind (see
  :func:`nnstreamer_tpu_torch.obs.watch.lint_rule`);
- nonsense ``[store]`` sizing (rings too short for any quantile or
  anomaly baseline, a series cap too small to hold one pool) — still
  NNS510, it is the same file;
- NNS517 — forecast rules that cannot predict: a missing or
  non-positive ``horizon`` (the watchdog refuses the set at startup;
  the lint catches it at review time), a forecast bound to a
  histogram family (windowed quantiles re-derive each tick — there is
  no single series to fit a trend through), or a horizon shorter than
  three sampler intervals (a "trend" over fewer than ~3 points of
  lookahead is noise, and the fit's significance gate would suppress
  every firing anyway).

- NNS518 — host-profiler misconfiguration (:func:`prof_env_problems`
  for the pure-env faces; the deep-episode-vs-``for`` face binds here
  against the rules file): ``NNS_TPU_TORCH_PROF``/``NNS_TPU_TORCH_PROF_DEEP_DIR``
  set together with ``NNS_TPU_TORCH_OBS_DISABLE`` (the profiler is strictly
  inert — a silent no-op, the NNS508 family), an unparsable or
  > 250 Hz sampling rate (the sampler walks every thread's stack each
  tick; past ~250 Hz it stops being low-overhead), or
  ``NNS_TPU_TORCH_PROF_DEEP_SECONDS`` longer than a rule's ``for`` window
  (the capture outlasts the episode that triggered it — the tail of
  the profile records recovery, not the incident).

Invoked by ``nns-lint --watch-rules FILE`` (bare ``--watch-rules``
reads ``$NNS_TPU_TORCH_WATCH_RULES``, the same env var the runtime loads
from).
"""

from __future__ import annotations

import os
from typing import List, Optional

from .diagnostics import Diagnostic

_HINT = ("rule grammar + the exported-family catalog: "
         "Documentation/observability.md ('Alerting & watchdog'); "
         "known families: nnstreamer_tpu_torch.obs.watch.KNOWN_FAMILIES")

_FC_HINT = ("forecast grammar: horizon = \"<duration>\" > 0 (and >= 3 "
            "sampler intervals), bound to a counter/gauge family — "
            "Documentation/observability.md ('Forecast rules & "
            "capacity headroom')")

#: sampler interval the horizon sanity check assumes when nobody says
#: otherwise (the watchdog's own default)
DEFAULT_INTERVAL_S = 1.0

#: a horizon shorter than this many sampler intervals forecasts over
#: fewer points than any trend needs
MIN_HORIZON_TICKS = 3

_PROF_HINT = ("host-profiler env vars (NNS_TPU_TORCH_PROF=<hz>, "
              "NNS_TPU_TORCH_PROF_DEEP_DIR, NNS_TPU_TORCH_PROF_DEEP_SECONDS): "
              "Documentation/observability.md ('Host execution "
              "profiling')")

#: past this sampling rate the sys._current_frames() walk stops being
#: low-overhead (every tick walks every thread's whole stack)
MAX_PROF_HZ = 250.0

#: deep-capture default when NNS_TPU_TORCH_PROF_DEEP_SECONDS is unset — must
#: track obs.prof.DeepProfiler's default
DEFAULT_DEEP_SECONDS = 2.0


def _deep_seconds() -> Optional[float]:
    """The armed deep-episode length, or None when deep capture is not
    armed at all (no NNS_TPU_TORCH_PROF_DEEP_DIR — nothing to check)."""
    if not os.environ.get("NNS_TPU_TORCH_PROF_DEEP_DIR", "").strip():
        return None
    raw = os.environ.get("NNS_TPU_TORCH_PROF_DEEP_SECONDS", "").strip()
    if not raw:
        return DEFAULT_DEEP_SECONDS
    try:
        return float(raw)
    except ValueError:
        return DEFAULT_DEEP_SECONDS


def prof_env_problems() -> List[Diagnostic]:
    """The pure-environment NNS518 faces (the ``prof-env`` target —
    only gathered when a profiler env var is set, so default nns-lint
    output stays byte-stable): profiler armed under the obs kill
    switch, and an unparsable or unworkable sampling rate."""
    from ..obs import hooks as obs_hooks

    prof = os.environ.get("NNS_TPU_TORCH_PROF", "").strip()
    deep = os.environ.get("NNS_TPU_TORCH_PROF_DEEP_DIR", "").strip()
    diags: List[Diagnostic] = []
    if not prof and not deep:
        return diags
    if obs_hooks.obs_disabled():
        armed = " and ".join(
            n for n, v in (("NNS_TPU_TORCH_PROF", prof),
                           ("NNS_TPU_TORCH_PROF_DEEP_DIR", deep)) if v)
        diags.append(Diagnostic.make(
            "NNS518",
            f"{armed} set together with NNS_TPU_TORCH_OBS_DISABLE: the host "
            "profiler is strictly inert under the kill switch — no "
            "sampler thread, no registry, no export (a silent no-op, "
            "like NNS508)", hint=_PROF_HINT))
    if prof:
        try:
            hz = float(prof)
        except ValueError:
            hz = None
            diags.append(Diagnostic.make(
                "NNS518",
                f"NNS_TPU_TORCH_PROF={prof!r} is not a sample rate in Hz — "
                "the profiler will not start", hint=_PROF_HINT))
        if hz is not None and hz > MAX_PROF_HZ:
            diags.append(Diagnostic.make(
                "NNS518",
                f"NNS_TPU_TORCH_PROF={hz:g} Hz exceeds {MAX_PROF_HZ:g} Hz: "
                "each tick walks every thread's whole stack — at this "
                "rate the profiler is no longer low-overhead "
                "(the --hostprof bench gates < 3%)", hint=_PROF_HINT))
    return diags


def _forecast_problems(rule, interval_s: float) -> List[str]:
    """The NNS517 faces of one well-formed forecast rule."""
    from ..obs import watch as _watch

    problems: List[str] = []
    if not rule.horizon_s > 0:
        problems.append(
            "forecast without a horizon (horizon = \"30s\") — the "
            "watchdog refuses the rule set at startup")
    elif rule.horizon_s < MIN_HORIZON_TICKS * interval_s:
        problems.append(
            f"horizon {rule.horizon_s:g}s is shorter than "
            f"{MIN_HORIZON_TICKS} sampler intervals "
            f"({MIN_HORIZON_TICKS * interval_s:g}s at {interval_s:g}s "
            f"sampling) — too little lookahead to beat the reactive "
            f"rules, and the noise gate suppresses it anyway")
    if _watch.KNOWN_FAMILIES.get(rule.metric) == "histogram":
        problems.append(
            f"forecast bound to histogram family {rule.metric!r} — "
            f"windowed quantiles re-derive each tick; trend-forecast "
            f"a counter rate or gauge level instead")
    return problems


def check_watch_rules(path: Optional[str],
                      interval_s: float = DEFAULT_INTERVAL_S
                      ) -> List[Diagnostic]:
    """Diagnostics for one rules file.  ``path=None`` means "use
    ``$NNS_TPU_TORCH_WATCH_RULES``" — unset is itself a finding (the user
    asked for a check with nothing to check).  ``interval_s`` is the
    sampler interval the horizon sanity check assumes."""
    from ..obs import watch as _watch

    if path is None:
        path = os.environ.get("NNS_TPU_TORCH_WATCH_RULES", "").strip()
        if not path:
            return [Diagnostic.make(
                "NNS510",
                "--watch-rules given without a file and "
                "NNS_TPU_TORCH_WATCH_RULES is unset — no rules to validate",
                hint=_HINT)]
    label = os.path.basename(path)
    try:
        rules = _watch.load_rules(path)
        store_cfg = _watch.load_store(path)
    except _watch.RuleError as e:
        return [Diagnostic.make(
            "NNS510", f"{label}: malformed rules file: {e}",
            element=path, hint=_HINT)]
    except OSError as e:
        return [Diagnostic.make(
            "NNS510", f"{label}: cannot read rules file: {e}",
            element=path, hint=_HINT)]
    diags: List[Diagnostic] = []
    deep_s = _deep_seconds()
    for rule in rules:
        for problem in _watch.lint_rule(rule):
            diags.append(Diagnostic.make(
                "NNS510", f"{label}: rule {rule.name!r}: {problem}",
                element=path, pad=rule.name, hint=_HINT))
        if rule.kind == "forecast":
            for problem in _forecast_problems(rule, interval_s):
                diags.append(Diagnostic.make(
                    "NNS517", f"{label}: rule {rule.name!r}: {problem}",
                    element=path, pad=rule.name, hint=_FC_HINT))
        # NNS518 deep-episode face: a deep capture longer than the
        # rule's for= window outlasts the very episode that fires it —
        # the profile's tail records recovery, not the incident
        if deep_s is not None and 0 < rule.for_s < deep_s:
            diags.append(Diagnostic.make(
                "NNS518",
                f"{label}: rule {rule.name!r}: deep-profile episode "
                f"({deep_s:g}s, NNS_TPU_TORCH_PROF_DEEP_SECONDS) is longer "
                f"than the rule's for= window ({rule.for_s:g}s) — the "
                "capture outlasts the alert episode that triggers it",
                element=path, pad=rule.name, hint=_PROF_HINT))
    for problem in _watch.lint_store(store_cfg):
        diags.append(Diagnostic.make(
            "NNS510", f"{label}: {problem}", element=path,
            hint=_HINT))
    return diags
