"""``nns-watch`` — in-process time-series store + alerting watchdog.

Counterpart of the JAX package's ``obs/watch.py``: the same rule
grammar, rule kinds, default rule pack, series and alert families, so a
rules file written for the JAX package reads the port unchanged.
Everything the passive observability layer builds (registry, tracer, cost
attribution, transfer ledger, MFU join) is *pull-only*: a human must run
``nns-top`` or scrape ``/metrics`` at the right moment to notice a
breaker flapping, a p99 burning through its SLO, or MFU falling off a
cliff.  Fleets of among-device edge pipelines have no such human.  This
module is the reactive layer — the time dimension:

- a **background sampler** scrapes the process registry (or, in fleet
  mode, the same ``host:port`` ``/json`` endpoints ``nns-top
  --connect`` takes, via the shared :mod:`obs.scrape` client) on an
  interval into bounded per-series ring buffers: counters become
  *rates*, gauges *levels*, histograms *windowed quantiles* (the same
  :func:`~nnstreamer_tpu_torch.obs.metrics.bucket_quantile` interpolation the
  admission controller sheds on);
- declarative **alert rules** evaluate against those series.  Four
  kinds:

  - ``threshold`` — value (optionally a ratio via ``per=``) compared
    against a bound, sustained for ``for`` seconds
    (``nns_edge_breaker_state >= open for 10s``);
  - ``slo_burn`` — classic dual-window error-budget burn: the fraction
    of observations over the SLO (histogram mode, e.g.
    ``nns_admission_latency_seconds`` vs the pool's ``slo-ms``) or the
    ratio of two counters (``nns_admission_shed_total`` /
    ``nns_admission_submitted_total``), over a *fast* and a *slow*
    window, both exceeding ``burn`` × the error ``budget``;
  - ``anomaly`` — robust z-score drift (median/MAD with a deviation
    floor) on a rate/level/quantile series: e2e latency, MFU,
    crossings/frame, RTT;
  - ``forecast`` — predictive: a robust linear trend
    (:mod:`.forecast`, Theil–Sen + residual MAD band) over a rate or
    level ring fires when the *predicted* value crosses the threshold
    within ``horizon`` seconds — before the reactive rules would.
    Current forecasts export as ``nns_forecast_value{rule}`` /
    ``nns_forecast_eta_seconds{rule}``, and the sampler joins an
    arrival-rate forecast against live MFU/roofline capacity into
    ``nns_capacity_headroom{pool}``;

- firing alerts carry severity and the offending series snapshot, and
  the shipped **actions** close the loop: a rate-limited bus WARNING on
  every registered pipeline, a flight-recorder dump
  (``obs/flightrec.py`` — triggered exactly once per firing transition,
  off the sampler thread), and alert-state export back into the
  registry (``nns_alert_state{rule,severity}``,
  ``nns_alerts_fired_total``) so ``/healthz`` and ``nns-top`` grow an
  ALERTS view and a fleet controller can scrape watch itself.

Rules load from a TOML/JSON file (``NNS_TPU_TORCH_WATCH_RULES``; grammar
below) on top of / instead of the built-in :func:`default_rules` pack
(breaker-open, edge health, SLO burn, queue saturation, latency drift,
MFU collapse).  ``NNS_TPU_TORCH_WATCH=<interval_s>`` starts a process-global
watchdog at first pipeline start (same activation hook as
``NNS_TPU_TORCH_METRICS_PORT`` / ``NNS_TPU_TORCH_CHAOS``).  The global obs kill
switch ``NNS_TPU_TORCH_OBS_DISABLE`` makes the whole module strictly inert:
no sampler thread, no rings, no export.

Rules file grammar (TOML shown; the JSON equivalent is the same
structure under a top-level ``"rule"`` list)::

    [[rule]]
    name = "breaker-open"
    kind = "threshold"
    metric = "nns_edge_breaker_state"
    op = ">="
    value = "open"          # symbolic: closed/half-open/open -> 0/1/2
    for = "10s"
    severity = "critical"

    [[rule]]
    name = "slo-burn"
    kind = "slo_burn"
    metric = "nns_admission_latency_seconds"
    # slo_ms omitted: derived from the pool's own admission slo-ms
    fast = "30s"
    slow = "300s"
    budget = 0.01           # allowed error fraction
    burn = 4.0              # fire when err_frac >= burn * budget ...
    severity = "critical"   # ... on BOTH windows

    [[rule]]
    name = "mfu-collapse"
    kind = "anomaly"
    metric = "nns_mfu"
    z = 8.0
    side = "lower"
    severity = "warning"

    [[rule]]
    name = "arrival-surge"
    kind = "forecast"
    metric = "nns_pool_frames_total"   # counter -> rate signal
    op = ">="
    value = 500.0           # frames/s the pool cannot sustain
    horizon = "30s"         # fire when the trend crosses within 30s

    [store]                 # optional: size the series store
    ring_points = 512       # points kept per derived ring
    max_series = 4096       # series cap (overflow counted, not silent)

:func:`lint_rule` and :func:`lint_store` validate a rules file
statically (unknown metric family, malformed grammar, nonsense store
sizing, forecast-rule grammar) without running anything.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from . import hooks as _hooks
from . import scrape as _scrape
from .forecast import FORECASTS
from . import forecast as _forecast
from .metrics import REGISTRY, MetricsRegistry, bucket_quantile

#: symbolic threshold values (the breaker-state gauge encoding from
#: chaos/retrypolicy.py): ``value = "open"`` reads as 2
SYMBOLIC_VALUES = {"closed": 0.0, "half-open": 1.0, "open": 2.0}

SEVERITIES = ("info", "warning", "critical")

RULE_KINDS = ("threshold", "slo_burn", "anomaly", "forecast")

#: derived-series signals a rule can bind to, by family kind
SIGNALS_BY_KIND = {
    "counter": ("rate",),
    "gauge": ("level",),
    "histogram": ("p50", "p95", "p99"),
}

#: every metric family the runtime can export, name -> kind — the
#: static catalog a rules file is linted against (a rule
#: watching a family nobody ever exports will simply never fire; that
#: is a config bug worth a warning, not a runtime surprise)
KNOWN_FAMILIES: Dict[str, str] = {
    # elements / pipelines
    "nns_element_buffers_in_total": "counter",
    "nns_element_buffers_out_total": "counter",
    "nns_element_stat_total": "counter",
    "nns_element_errors_total": "counter",
    "nns_queue_depth": "gauge",
    "nns_queue_capacity": "gauge",
    # host-execution profiler (obs/prof.py)
    "nns_element_cpu_seconds_total": "counter",
    "nns_element_run_seconds_total": "counter",
    "nns_element_wait_seconds_total": "counter",
    "nns_gil_waiters": "gauge",
    # filters
    "nns_filter_invokes_total": "counter",
    "nns_filter_frames_total": "counter",
    "nns_filter_latency_us": "gauge",
    "nns_filter_throughput_milli_fps": "gauge",
    "nns_filter_dispatch_milli_fps": "gauge",
    "nns_filter_batch_occupancy": "gauge",
    "nns_filter_stream_occupancy": "gauge",
    "nns_batcher_pending": "gauge",
    "nns_batcher_flushes_total": "counter",
    "nns_executable_cache_hits_total": "counter",
    "nns_executable_cache_misses_total": "counter",
    # serving pools + admission
    "nns_pool_streams": "gauge",
    "nns_pool_refcount": "gauge",
    "nns_pool_dispatches_total": "counter",
    "nns_pool_frames_total": "counter",
    "nns_pool_latency_us": "gauge",
    "nns_pool_batch_occupancy": "gauge",
    "nns_pool_stream_occupancy": "gauge",
    "nns_pool_pending": "gauge",
    "nns_pool_flushes_total": "counter",
    "nns_model_weight_bytes": "gauge",
    # model lifecycle (runtime/lifecycle.py): per-version series + the
    # canary comparator pair a promote/rollback playbook binds to
    "nns_model_version_invokes_total": "counter",
    "nns_model_version_frames_total": "counter",
    "nns_model_version_errors_total": "counter",
    "nns_model_version_latency_us": "gauge",
    "nns_model_version_state": "gauge",
    "nns_model_swaps_total": "counter",
    "nns_model_promotions_total": "counter",
    "nns_model_rollbacks_total": "counter",
    "nns_model_swap_stall_seconds": "gauge",
    "nns_model_canary_streams": "gauge",
    "nns_model_canary_latency_us": "gauge",
    "nns_model_baseline_latency_us": "gauge",
    "nns_model_canary_errors_total": "counter",
    "nns_model_canary_frames_total": "counter",
    "nns_admission_slo_at_risk": "gauge",
    "nns_admission_p99_us": "gauge",
    "nns_admission_submitted_total": "counter",
    "nns_admission_shed_total": "counter",
    "nns_admission_latency_seconds": "histogram",
    # edge links
    "nns_edge_tx_bytes_total": "counter",
    "nns_edge_rx_bytes_total": "counter",
    "nns_edge_tx_messages_total": "counter",
    "nns_edge_rx_messages_total": "counter",
    "nns_edge_inflight": "gauge",
    "nns_edge_timeouts_total": "counter",
    "nns_edge_reconnects_total": "counter",
    "nns_edge_bad_frames_total": "counter",
    "nns_edge_backoff_level": "gauge",
    "nns_edge_breaker_state": "gauge",
    "nns_edge_breaker_opens_total": "counter",
    "nns_edge_rtt_seconds": "histogram",
    # cost attribution / compiles
    "nns_invoke_device_seconds": "histogram",
    "nns_invoke_host_seconds": "histogram",
    "nns_compiles_total": "counter",
    "nns_compile_seconds_total": "counter",
    # data movement / device memory
    "nns_transfer_bytes_total": "counter",
    "nns_transfer_count_total": "counter",
    "nns_transfer_seconds": "histogram",
    "nns_device_memory_bytes": "gauge",
    # program cost / MFU / mesh
    "nns_executable_flops": "gauge",
    "nns_executable_bytes": "gauge",
    "nns_executable_peak_memory_bytes": "gauge",
    "nns_mfu": "gauge",
    "nns_hbm_bw_util": "gauge",
    "nns_shard_imbalance": "gauge",
    "nns_mesh_dispatches_total": "counter",
    "nns_mesh_pad_slots_total": "counter",
    "nns_mesh_replicated_dispatches_total": "counter",
    "nns_mesh_shard_frames_total": "counter",
    # tenancy / cost export (obs/tenantstat.py)
    "nns_tenant_device_seconds_total": "counter",
    "nns_tenant_frames_total": "counter",
    "nns_tenant_dollars_total": "counter",
    "nns_tenant_slo_attainment": "gauge",
    "nns_tenant_shed_total": "counter",
    # forecasting / capacity (obs/forecast.py)
    "nns_forecast_value": "gauge",
    "nns_forecast_eta_seconds": "gauge",
    "nns_capacity_headroom": "gauge",
    # chaos + watch itself
    "nns_chaos_injected_total": "counter",
    "nns_alert_state": "gauge",
    "nns_alerts_fired_total": "counter",
    "nns_watch_samples_total": "counter",
    "nns_watch_scrape_errors_total": "counter",
    # the closed-loop controller (obs/control.py)
    "nns_control_actions_total": "counter",
    "nns_control_state": "gauge",
}


class RuleError(ValueError):
    """Malformed watch rule / rules file."""


def _parse_duration(v: Any, field: str) -> float:
    """``10``/``10.5``/``"10s"``/``"500ms"``/``"2m"`` → seconds."""
    if isinstance(v, bool):
        raise RuleError(f"{field}: expected a duration, got {v!r}")
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip().lower()
    mult = 1.0
    for suffix, m in (("ms", 1e-3), ("s", 1.0), ("m", 60.0), ("h", 3600.0)):
        if s.endswith(suffix):
            s, mult = s[: -len(suffix)], m
            break
    try:
        return float(s) * mult
    except ValueError:
        raise RuleError(
            f"{field}: cannot parse duration {v!r} "
            f"(use seconds, or a number with ms/s/m/h suffix)") from None


_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


@dataclasses.dataclass
class AlertRule:
    """One declarative alert rule (see the module doc for grammar)."""

    name: str
    kind: str
    metric: str
    severity: str = "warning"
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    signal: str = ""        # rate|level|p50|p95|p99; "" = kind default
    # threshold
    op: str = ">"
    value: Any = 0.0
    per: str = ""           # denominator family (value becomes a ratio)
    for_s: float = 0.0
    # slo_burn
    slo_ms: float = 0.0     # 0 = derive from the pool's admission slo-ms
    budget: float = 0.01
    burn: float = 4.0
    fast_s: float = 30.0
    slow_s: float = 300.0
    # forecast: fire when the fitted trend crosses ``value`` within
    # this many seconds (0 = unset; the watchdog refuses a forecast
    # rule without one — see Watch.__init__.  Parse stays lenient so
    # a linter can reach the file and report it instead.)
    horizon_s: float = 0.0
    # anomaly
    z: float = 6.0
    side: str = "upper"     # upper|lower|both
    min_samples: int = 8
    rel_floor: float = 0.05  # MAD floor as a fraction of |median|
    abs_floor: float = 0.0   # MAD floor in the series' own unit
    #: how many recent points form the anomaly baseline — a bounded
    #: window, so ancient regimes (startup compile decay, a long-gone
    #: traffic pattern) age OUT of the median/MAD instead of poisoning
    #: it forever
    baseline_points: int = 64

    def __post_init__(self):
        if not str(self.name).strip():
            raise RuleError("rule without a name")
        ctx = f"rule {self.name!r}"
        if self.kind not in RULE_KINDS:
            raise RuleError(f"{ctx}: unknown kind {self.kind!r}; one of "
                            f"{list(RULE_KINDS)}")
        if not str(self.metric).strip():
            raise RuleError(f"{ctx}: no metric")
        if self.severity not in SEVERITIES:
            raise RuleError(f"{ctx}: unknown severity {self.severity!r}; "
                            f"one of {list(SEVERITIES)}")
        if self.op not in _OPS:
            raise RuleError(f"{ctx}: unknown op {self.op!r}; one of "
                            f"{sorted(_OPS)}")
        if self.side not in ("upper", "lower", "both"):
            raise RuleError(f"{ctx}: side={self.side!r} not "
                            f"upper/lower/both")
        if isinstance(self.value, str):
            sym = SYMBOLIC_VALUES.get(self.value.strip().lower())
            if sym is None:
                raise RuleError(
                    f"{ctx}: symbolic value {self.value!r} unknown; one "
                    f"of {sorted(SYMBOLIC_VALUES)} (or a number)")
            self.value = sym
        self.value = float(self.value)
        if not isinstance(self.labels, dict):
            raise RuleError(f"{ctx}: labels must be a table/object")
        self.labels = {str(k): str(v) for k, v in self.labels.items()}
        for fld in ("for_s", "fast_s", "slow_s", "horizon_s", "slo_ms",
                    "budget", "burn", "z", "rel_floor", "abs_floor"):
            v = getattr(self, fld)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0:
                raise RuleError(f"{ctx}: {fld}={v!r} must be a "
                                f"number >= 0")
        if self.kind == "forecast" \
                and self.op not in _forecast.ORDERED_OPS:
            # "=="/"!=" have no crossing direction to project through
            raise RuleError(f"{ctx}: forecast needs an ordered op "
                            f"({list(_forecast.ORDERED_OPS)}), "
                            f"not {self.op!r}")
        if self.kind == "slo_burn":
            if self.budget <= 0:
                raise RuleError(f"{ctx}: budget must be > 0")
            if self.fast_s > self.slow_s:
                raise RuleError(f"{ctx}: fast window ({self.fast_s}s) "
                                f"longer than slow ({self.slow_s}s)")
        if self.min_samples < 2:
            raise RuleError(f"{ctx}: min_samples must be >= 2")
        self.baseline_points = int(self.baseline_points)
        if self.baseline_points < self.min_samples:
            raise RuleError(f"{ctx}: baseline_points "
                            f"({self.baseline_points}) smaller than "
                            f"min_samples ({self.min_samples})")


#: rules-file keys -> dataclass fields (duration strings parsed)
_RULE_KEY_MAP = {"for": "for_s", "fast": "fast_s", "slow": "slow_s",
                 "horizon": "horizon_s"}
_DURATION_FIELDS = {"for_s", "fast_s", "slow_s", "horizon_s"}
_RULE_FIELDS = {f.name for f in dataclasses.fields(AlertRule)}


def parse_rule(item: dict) -> AlertRule:
    if not isinstance(item, dict):
        raise RuleError(f"rule entry is not a table/object: {item!r}")
    kw: Dict[str, Any] = {}
    for key, val in item.items():
        fld = _RULE_KEY_MAP.get(key, key)
        if fld not in _RULE_FIELDS:
            raise RuleError(
                f"rule {item.get('name', '?')!r}: unknown key {key!r} "
                f"(known: {sorted(_RULE_FIELDS | set(_RULE_KEY_MAP))})")
        if fld in _DURATION_FIELDS:
            val = _parse_duration(val, f"rule {item.get('name', '?')!r}"
                                       f".{key}")
        kw[fld] = val
    for required in ("name", "kind", "metric"):
        if required not in kw:
            raise RuleError(
                f"rule {kw.get('name', '?')!r}: missing {required!r}")
    return AlertRule(**kw)


def parse_rules(doc: Any) -> List[AlertRule]:
    """Rules from a parsed TOML/JSON document: a top-level ``rule`` (or
    ``rules``) list, or a bare list."""
    if isinstance(doc, dict):
        items = doc.get("rule", doc.get("rules"))
        if items is None:
            raise RuleError(
                "rules document has no top-level 'rule' list "
                "([[rule]] tables in TOML, \"rule\": [...] in JSON)")
    else:
        items = doc
    if not isinstance(items, list) or not items:
        raise RuleError("rules document names no rules")
    rules = [parse_rule(item) for item in items]
    seen: Dict[str, int] = {}
    for r in rules:
        seen[r.name] = seen.get(r.name, 0) + 1
    dupes = sorted(n for n, c in seen.items() if c > 1)
    if dupes:
        raise RuleError(f"duplicate rule name(s): {dupes} — alert state "
                        f"is keyed by name")
    return rules


def _load_doc(path: str) -> Any:
    """Parse a rules file into its document; ``.toml`` via stdlib
    tomllib (3.11+), anything else as JSON.  Raises
    :class:`RuleError` on malformed syntax, ``OSError`` on unreadable
    files."""
    if str(path).endswith(".toml"):
        try:
            import tomllib
        except ImportError:
            raise RuleError(
                "TOML rules files need Python 3.11+ (tomllib); "
                "use the JSON form instead") from None
        try:
            with open(path, "rb") as f:
                return tomllib.load(f)
        except tomllib.TOMLDecodeError as e:
            raise RuleError(f"invalid TOML: {e}") from None
    with open(path, "r", encoding="utf-8") as f:
        try:
            return json.load(f)
        except ValueError as e:
            raise RuleError(f"invalid JSON: {e}") from None


def load_rules(path: str) -> List[AlertRule]:
    """Load + parse a rules file (grammar errors raise
    :class:`RuleError`)."""
    return parse_rules(_load_doc(path))


#: keys the optional top-level ``[store]`` table may carry — they size
#: the watchdog's SeriesStore (Watch constructor kwargs of the same
#: names)
_STORE_KEYS = ("ring_points", "max_series")


def parse_store(doc: Any) -> Dict[str, int]:
    """The optional top-level ``[store]`` table of a rules file:
    ``{ring_points, max_series}`` overrides for the series store
    ({} when absent — the Watch defaults stand).  Unknown keys and
    non-positive/non-integer values are grammar errors
    (:class:`RuleError`), same strictness as the rule tables."""
    if not isinstance(doc, dict):
        return {}
    st = doc.get("store")
    if st is None:
        return {}
    if not isinstance(st, dict):
        raise RuleError("[store] is not a table/object")
    out: Dict[str, int] = {}
    for key, val in st.items():
        if key not in _STORE_KEYS:
            raise RuleError(f"[store]: unknown key {key!r} "
                            f"(known: {sorted(_STORE_KEYS)})")
        if isinstance(val, bool) or not isinstance(val, int) \
                or val <= 0:
            raise RuleError(f"[store]: {key}={val!r} must be a "
                            f"positive integer")
        out[key] = int(val)
    return out


def load_store(path: str) -> Dict[str, int]:
    """The ``[store]`` overrides of a rules file ({} when it has
    none)."""
    return parse_store(_load_doc(path))


def lint_store(cfg: Dict[str, int]) -> List[str]:
    """Static problems with a (well-formed) ``[store]`` section —
    values that parse but cannot work (the checks beyond grammar)."""
    problems: List[str] = []
    rp = cfg.get("ring_points")
    if rp is not None and rp < QUANT_WINDOW_TICKS:
        problems.append(
            f"[store]: ring_points={rp} is shorter than the "
            f"{QUANT_WINDOW_TICKS}-tick quantile window — histogram "
            f"signals (and any anomaly baseline) cannot form")
    ms = cfg.get("max_series")
    if ms is not None and ms < 16:
        problems.append(
            f"[store]: max_series={ms} cannot hold even one pool's "
            f"families — everything past the cap is dropped (counted, "
            f"but every rule on a dropped series is blind)")
    return problems


def lint_rule(rule: AlertRule) -> List[str]:
    """Static problems with one (well-formed) rule — the
    checks beyond grammar: metric families the registry never exports,
    signals that cannot exist for the family's kind, burn rules that
    can never bind."""
    problems: List[str] = []
    if rule.name == "endpoint-down":
        problems.append(
            "'endpoint-down' is reserved for the built-in "
            "fleet-liveness check (the watchdog refuses the rule set)")
    kind = KNOWN_FAMILIES.get(rule.metric)
    if kind is None:
        problems.append(
            f"metric {rule.metric!r} is not a family the registry "
            f"ever exports (the rule can never fire)")
    elif rule.signal and rule.signal not in SIGNALS_BY_KIND[kind]:
        problems.append(
            f"signal {rule.signal!r} does not exist for "
            f"{kind} family {rule.metric!r} (valid: "
            f"{list(SIGNALS_BY_KIND[kind])})")
    if rule.per:
        per_kind = KNOWN_FAMILIES.get(rule.per)
        if per_kind is None:
            problems.append(
                f"per={rule.per!r} is not a family the registry ever "
                f"exports (the ratio can never form)")
        elif kind is not None and per_kind != kind:
            problems.append(
                f"per={rule.per!r} ({per_kind}) does not match "
                f"{rule.metric!r} ({kind}) — a ratio needs two "
                f"families of the same kind")
    if rule.kind == "slo_burn" and kind is not None:
        if kind == "histogram" and rule.per:
            problems.append(
                "slo_burn on a histogram family takes no per= "
                "(the error fraction comes from the buckets vs the SLO)")
        if kind == "counter" and not rule.per:
            problems.append(
                "slo_burn on a counter family needs per= (the "
                "denominator counter of the error ratio)")
        if kind == "gauge":
            problems.append(
                "slo_burn needs a histogram (latency-vs-SLO mode) or a "
                "counter pair (ratio mode), not a gauge")
    if rule.kind == "anomaly" and rule.side == "lower" \
            and rule.rel_floor > 0 and rule.z * rule.rel_floor >= 1.0:
        problems.append(
            f"z ({rule.z:g}) x rel_floor ({rule.rel_floor:g}) >= 1 on "
            f"a lower-side rule: a nonnegative series can drop at most "
            f"-median, i.e. |z| <= 1/rel_floor when the MAD floors out "
            f"— the rule can never fire on a flat baseline")
    return problems


def default_rules() -> List[AlertRule]:
    """The built-in pack: breaker-open, edge-link health, hard-shed +
    SLO burn, queue saturation, latency drift, MFU collapse.  Tuned for
    this runtime's own links and pools — a deployment with different
    baselines overrides via ``NNS_TPU_TORCH_WATCH_RULES``."""
    R = AlertRule
    return [
        # a circuit breaker opening IS the outage signal
        R(name="breaker-open", kind="threshold",
          metric="nns_edge_breaker_state", op=">=", value="open",
          severity="critical"),
        # edge-link health: any timeout/reconnect/corrupt frame in a
        # sampling window is a symptom worth an alarm on an edge fleet
        R(name="edge-timeouts", kind="threshold",
          metric="nns_edge_timeouts_total", op=">", value=0.0),
        R(name="edge-reconnect-flap", kind="threshold",
          metric="nns_edge_reconnects_total", op=">", value=0.0),
        R(name="edge-bad-frames", kind="threshold",
          metric="nns_edge_bad_frames_total", op=">", value=0.0),
        R(name="edge-rtt-drift", kind="anomaly",
          metric="nns_edge_rtt_seconds", signal="p95", z=8.0,
          side="upper", min_samples=10, rel_floor=0.5),
        # model path: sustained latency drift and errored dispatches
        R(name="pool-latency-drift", kind="anomaly",
          metric="nns_pool_latency_us", z=8.0, side="upper",
          min_samples=8, rel_floor=0.35),
        R(name="filter-latency-drift", kind="anomaly",
          metric="nns_filter_latency_us", z=8.0, side="upper",
          min_samples=8, rel_floor=0.35),
        R(name="element-errors", kind="threshold",
          metric="nns_element_errors_total", op=">", value=0.0,
          severity="critical"),
        # admission: any shed is loud; the burn pair watches the error
        # budget the way an SRE console would
        R(name="hard-shed", kind="threshold",
          metric="nns_admission_shed_total", op=">", value=0.0),
        R(name="slo-burn", kind="slo_burn",
          metric="nns_admission_latency_seconds", fast_s=15.0,
          slow_s=120.0, budget=0.01, burn=4.0, severity="critical"),
        R(name="shed-burn", kind="slo_burn",
          metric="nns_admission_shed_total",
          per="nns_admission_submitted_total", fast_s=15.0,
          slow_s=120.0, budget=0.05, burn=2.0),
        R(name="queue-saturation", kind="threshold",
          metric="nns_queue_depth", per="nns_queue_capacity",
          op=">=", value=0.9, for_s=1.0),
        # efficiency: MFU falling off a cliff on a serving fleet.
        # z * rel_floor must stay < 1 on a lower-side rule: the
        # biggest possible drop of a nonnegative series is -median,
        # i.e. z = -1/rel_floor when MAD floors out — 8.0 x 0.25
        # could literally never fire
        R(name="mfu-collapse", kind="anomaly", metric="nns_mfu",
          z=3.5, side="lower", min_samples=8, rel_floor=0.25),
    ]


def rules_from_env() -> List[AlertRule]:
    """The active rule set: ``NNS_TPU_TORCH_WATCH_RULES=<file>`` when set
    (replacing the default pack), else :func:`default_rules`."""
    path = os.environ.get("NNS_TPU_TORCH_WATCH_RULES", "").strip()
    if not path:
        return default_rules()
    return load_rules(path)


# -- the series store ---------------------------------------------------------

#: how many per-tick histogram deltas the windowed quantile sums over
#: (the same rolling-delta idea as AdmissionController.HIST_WINDOW_DELTAS)
QUANT_WINDOW_TICKS = 16


class _Series:
    """One bounded time series: raw cumulative state + derived rings."""

    __slots__ = ("kind", "labels", "rings", "prev", "prev_ts", "raw",
                 "qwin", "bounds", "seen_tick", "reborn")

    def __init__(self, kind: str, labels: Dict[str, str],
                 ring_points: int):
        self.kind = kind
        self.labels = labels
        self.seen_tick = 0  # the endpoint tick this series last appeared
        # True when this key was EVICTED and came back: its first
        # cumulative value is history re-surfacing, not increments born
        # inside the sampling window — rate-from-zero must not apply
        self.reborn = False
        # signal -> deque[(ts, value)]
        self.rings: Dict[str, Deque[Tuple[float, float]]] = {
            sig: collections.deque(maxlen=ring_points)
            for sig in SIGNALS_BY_KIND[kind]}
        self.prev: Any = None       # counter: cum value; hist: noncum dist
        self.prev_ts: Optional[float] = None
        # counter: deque[(ts, cum)]; histogram: deque[(ts, delta_dist)]
        self.raw: Deque[Tuple] = collections.deque(maxlen=ring_points)
        # histogram only: the short delta window the live quantiles sum
        self.qwin: Deque[Tuple] = collections.deque(
            maxlen=QUANT_WINDOW_TICKS)
        self.bounds: Tuple[float, ...] = ()

    def last(self, signal: str) -> Optional[Tuple[float, float]]:
        ring = self.rings.get(signal)
        return ring[-1] if ring else None

    def tail(self, signal: str, n: int = 32) -> List[Tuple[float, float]]:
        ring = self.rings.get(signal)
        return list(ring)[-n:] if ring else []

    def cum_delta_over(self, window_s: float,
                       now: float) -> Optional[float]:
        """Counter: increments over the trailing window (None before
        two raw points exist)."""
        if len(self.raw) < 2:
            return None
        cutoff = now - window_s
        base_ts, base = self.raw[0]
        for ts, cum in self.raw:
            if ts > cutoff:
                break
            base_ts, base = ts, cum
        return max(self.raw[-1][1] - base, 0.0)

    def hist_window(self, window_s: float,
                    now: float) -> Optional[List[float]]:
        """Histogram: elementwise sum of the per-tick non-cumulative
        delta distributions inside the trailing window."""
        cutoff = now - window_s
        dist: Optional[List[float]] = None
        for ts, delta in self.raw:
            if ts < cutoff:
                continue
            if dist is None:
                dist = list(delta)
            else:
                dist = [a + b for a, b in zip(dist, delta)]
        return dist


def _labelkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _le_float(le: str) -> float:
    return float("inf") if le in ("+Inf", "inf") else float(le)


class SeriesStore:
    """Bounded store of derived series, fed one snapshot at a time.

    Keys are ``(endpoint, family, labelset)``; every ring is a
    ``deque(maxlen=ring_points)`` and the series count is capped, so a
    watchdog attached to a high-cardinality process stays bounded (the
    overflow is counted, never silent)."""

    #: ticks a series may miss from its endpoint's snapshots before
    #: rule evaluation treats it as STALE (its source is gone — a
    #: stopped pipeline, a released pool, a closed link): a stale
    #: series must stop satisfying conditions, or an alert raised on a
    #: since-dead object would stay FIRING forever on its frozen last
    #: point
    STALE_TICKS = 3
    #: ticks after which a stale series is evicted outright (restart/
    #: re-create churn must not accumulate ghost series to the cap)
    EVICT_TICKS = 128

    #: evicted keys remembered (bounded): a series re-appearing after
    #: eviction must RE-BASE, not rate-from-zero — its cumulative
    #: value is old history, and dividing it by one tick manufactures
    #: a giant phantom spike (and a phantom alert) out of nothing
    EVICT_MEMORY = 4096

    def __init__(self, ring_points: int = 512, max_series: int = 4096):
        self.ring_points = int(ring_points)
        self.max_series = int(max_series)
        self._series: Dict[Tuple, _Series] = {}
        self._evicted: "collections.OrderedDict[Tuple, None]" = \
            collections.OrderedDict()
        self.dropped_series = 0
        self._tick_no: Dict[str, int] = {}  # endpoint -> ingest count
        # (endpoint, pool) -> slo_ms hint from the pools table, for
        # slo_burn rules that don't pin their own slo_ms
        self._slo_hints: Dict[Tuple[str, str], float] = {}
        # endpoint -> ts of its last ingested snapshot: a counter/
        # histogram series first appearing AFTER the endpoint's first
        # tick was born inside the sampling window, so its initial
        # value IS a delta (from zero) — without this, a counter that
        # springs to life already at 1 (first error, first timeout)
        # never shows a nonzero rate.  On the endpoint's FIRST tick
        # everything is baseline (cumulative history, not news).
        self._last_tick: Dict[str, float] = {}

    def __len__(self) -> int:
        return len(self._series)

    def _get(self, endpoint: str, family: str, kind: str,
             labels: Dict[str, str]) -> Optional[_Series]:
        key = (endpoint, family, _labelkey(labels))
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self.max_series:
                self.dropped_series += 1
                return None
            s = _Series(kind, dict(labels), self.ring_points)
            if key in self._evicted:
                del self._evicted[key]
                s.reborn = True
            self._series[key] = s
        s.seen_tick = self._tick_no.get(endpoint, 0)
        return s

    def is_stale(self, key: Tuple, s: _Series) -> bool:
        """Whether the series stopped appearing in its endpoint's
        snapshots (source object gone)."""
        return self._tick_no.get(key[0], 0) - s.seen_tick \
            > self.STALE_TICKS

    def slo_hint(self, endpoint: str, pool: Optional[str]
                 ) -> Optional[float]:
        if pool is None:
            return None
        return self._slo_hints.get((endpoint, pool))

    def match(self, family: str,
              labels: Dict[str, str]) -> List[Tuple[Tuple, _Series]]:
        """LIVE series of ``family`` whose labels are a superset of the
        rule's filter, every endpoint (stale series — absent from their
        endpoint's recent snapshots — don't bind: their frozen last
        point must not keep an alert firing)."""
        out = []
        for key, s in self._series.items():
            if key[1] != family or self.is_stale(key, s):
                continue
            if all(s.labels.get(k) == v for k, v in labels.items()):
                out.append((key, s))
        return out

    def find(self, endpoint: str, family: str,
             labels: Dict[str, str]) -> Optional[_Series]:
        return self._series.get((endpoint, family, _labelkey(labels)))

    # -- ingest ---------------------------------------------------------------

    def ingest(self, endpoint: str, snap: dict, ts: float) -> None:
        """Fold one registry snapshot into the store (counter→rate,
        gauge→level, histogram→windowed quantiles)."""
        prev_tick = self._last_tick.get(endpoint)
        self._last_tick[endpoint] = ts
        tick = self._tick_no.get(endpoint, 0) + 1
        self._tick_no[endpoint] = tick
        for row in snap.get("pools", []):
            adm = row.get("admission")
            if adm and adm.get("slo_ms"):
                self._slo_hints[(endpoint, row.get("pool", ""))] = \
                    float(adm["slo_ms"])
        for name, fam in snap.get("metrics", {}).items():
            kind = fam.get("kind")
            if kind == "histogram":
                self._ingest_hist(endpoint, name, fam, ts, prev_tick)
            elif kind in ("counter", "gauge"):
                self._ingest_flat(endpoint, name, kind, fam, ts,
                                  prev_tick)
        # evict long-gone series so restart/re-create churn (new pool
        # per run, new link per port) never accumulates ghost series
        # up to the cap
        dead = [key for key, s in self._series.items()
                if key[0] == endpoint
                and tick - s.seen_tick > self.EVICT_TICKS]
        for key in dead:
            del self._series[key]
            # remember who left, so a reborn key re-bases instead of
            # spiking rate-from-zero (bounded LRU, oldest forgotten)
            self._evicted[key] = None
            self._evicted.move_to_end(key)
        while len(self._evicted) > self.EVICT_MEMORY:
            self._evicted.popitem(last=False)

    def _ingest_flat(self, endpoint: str, name: str, kind: str,
                     fam: dict, ts: float,
                     prev_tick: Optional[float]) -> None:
        for sample in fam.get("samples", []):
            value = float(sample.get("value", 0.0))
            s = self._get(endpoint, name, kind, sample.get("labels", {}))
            if s is None:
                continue
            if kind == "gauge":
                s.rings["level"].append((ts, value))
                continue
            s.raw.append((ts, value))
            if s.prev is not None and s.prev_ts is not None \
                    and ts > s.prev_ts:
                delta = value - s.prev
                if delta >= 0:  # negative = counter reset: skip one tick
                    s.rings["rate"].append(
                        (ts, delta / (ts - s.prev_ts)))
            elif s.prev is None and prev_tick is not None \
                    and ts > prev_tick and not s.reborn:
                # series born inside the window: its whole value is
                # this window's increments (rate-from-zero, same rule
                # nns-top applies to its XFER columns).  A REBORN
                # series (evicted, then re-appeared) is the one case
                # where that logic lies: its value is accumulated
                # history, so it re-bases silently instead
                s.rings["rate"].append((ts, value / (ts - prev_tick)))
            s.reborn = False
            s.prev, s.prev_ts = value, ts

    def _ingest_hist(self, endpoint: str, name: str, fam: dict,
                     ts: float, prev_tick: Optional[float]) -> None:
        # group the flat _bucket/_sum/_count samples by label set
        groups: Dict[Tuple, Dict[float, float]] = {}
        label_of: Dict[Tuple, Dict[str, str]] = {}
        for sample in fam.get("samples", []):
            sub = sample.get("name", name)
            if not sub.endswith("_bucket"):
                continue
            labels = dict(sample.get("labels", {}))
            le = labels.pop("le", None)
            if le is None:
                continue
            key = _labelkey(labels)
            groups.setdefault(key, {})[_le_float(le)] = \
                float(sample.get("value", 0.0))
            label_of[key] = labels
        for key, by_le in groups.items():
            bounds = tuple(sorted(by_le))
            cum = [by_le[le] for le in bounds]
            # exposition buckets are cumulative; the store works on
            # per-bucket counts
            noncum = [c - (cum[i - 1] if i else 0.0)
                      for i, c in enumerate(cum)]
            s = self._get(endpoint, name, "histogram", label_of[key])
            if s is None:
                continue
            if s.bounds and (s.bounds != bounds
                             or len(s.prev or ()) != len(noncum)):
                # bucket layout changed under us: resync, skip a tick —
                # and drop the accumulated delta rows, whose old-length
                # dists would corrupt the windowed quantiles (zip
                # truncation) and index past the new bounds in the
                # burn evaluation
                s.bounds = bounds
                s.prev = noncum
                s.raw.clear()
                s.qwin.clear()
                continue
            if s.prev is None:
                s.bounds = bounds
                s.prev = noncum
                if prev_tick is None or s.reborn:
                    # store cold (history, not news) — or the series
                    # was evicted and came back, same situation
                    s.reborn = False
                    continue
                delta = list(noncum)  # born inside the window
            else:
                delta = [c - p for c, p in zip(noncum, s.prev)]
                s.prev = noncum
                if any(d < 0 for d in delta):  # reset: resync
                    continue
            s.raw.append((ts, delta))
            s.qwin.append((ts, delta))
            if sum(delta) <= 0:
                continue  # no new observations: quantiles stay put
            dist = [0.0] * len(noncum)
            for _t, d in s.qwin:
                dist = [a + b for a, b in zip(dist, d)]
            for sig, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
                v = bucket_quantile(bounds, dist, q)
                if v is not None:
                    s.rings[sig].append((ts, v))


def _over_threshold(bounds: Tuple[float, ...], dist: List[float],
                    thr: float) -> float:
    """Observations above ``thr`` in a non-cumulative distribution,
    with linear apportioning of the straddling bucket (the whole +Inf
    bucket counts as over — conservative in the direction that pages)."""
    over = 0.0
    for i, n in enumerate(dist):
        if n <= 0:
            continue
        lo = bounds[i - 1] if i > 0 else 0.0
        hi = bounds[i]
        if lo >= thr:
            over += n
        elif hi > thr:
            over += n if hi == float("inf") \
                else n * (hi - thr) / (hi - lo)
    return over


def _robust_z(baseline: List[float], x: float, rel_floor: float,
              abs_floor: float) -> float:
    """Median/MAD z-score with a deviation floor: a series that sat
    perfectly flat (MAD 0) must not turn every epsilon into infinity."""
    import statistics

    med = statistics.median(baseline)
    mad = statistics.median(abs(b - med) for b in baseline)
    sigma = max(1.4826 * mad, rel_floor * abs(med), abs_floor, 1e-12)
    return (x - med) / sigma


# -- the watchdog -------------------------------------------------------------


class _RuleState:
    __slots__ = ("firing", "since", "fired", "bad_since", "detail")

    def __init__(self):
        self.firing = False
        self.since = 0.0
        self.fired = 0
        self.bad_since: Dict[Tuple, float] = {}
        self.detail: Optional[dict] = None


class Watch:
    """The watchdog: sampler + store + rule engine + actions.

    ``endpoints=None`` watches the in-process ``registry`` (default:
    the global one); a list of ``host:port`` strings watches a fleet
    over the shared scrape client.  ``source`` overrides the sampling
    function entirely (tests feed synthetic snapshots).  Strictly
    inert under ``NNS_TPU_TORCH_OBS_DISABLE``: :meth:`start` spawns no
    thread, :meth:`sample_once` is a no-op."""

    #: consecutive scrape failures before ``endpoint-down`` fires
    DOWN_AFTER = 3

    def __init__(self, rules: Optional[List[AlertRule]] = None,
                 interval_s: float = 1.0,
                 endpoints: Optional[List[str]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 source: Optional[Callable[[], List[dict]]] = None,
                 ring_points: int = 512, max_series: int = 4096):
        self.rules = list(rules) if rules is not None else default_rules()
        if any(r.name == "endpoint-down" for r in self.rules):
            # the built-in fleet check owns this name and its state —
            # a user rule sharing it would flap fire/resolve every
            # tick against the built-in's transitions
            raise RuleError("'endpoint-down' is reserved for the "
                            "built-in fleet-liveness check; rename "
                            "the rule")
        for r in self.rules:
            # grammar stays lenient (a linter must reach the file and
            # report it); the live watchdog refuses to run it
            if r.kind == "forecast" and not r.horizon_s > 0:
                raise RuleError(
                    f"rule {r.name!r}: forecast needs horizon_s > 0 "
                    f"(e.g. horizon = \"30s\") — without one there is "
                    f"nothing to predict across")
        self.interval_s = max(float(interval_s), 0.01)
        self.endpoints = list(endpoints) if endpoints else None
        self.registry = registry if registry is not None else REGISTRY
        self._source = source
        self.store = SeriesStore(ring_points=ring_points,
                                 max_series=max_series)
        self.enabled = not _hooks.DISABLED
        self.samples = 0
        self.alert_log: Deque[dict] = collections.deque(maxlen=256)
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self._states["endpoint-down"] = _RuleState()
        self._fail_streak: Dict[str, int] = {}
        self._warn_ts = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # RLock: the bus-WARNING action dispatches handlers inline on
        # the sampler thread, and a handler is allowed to read
        # alerts() back — same-thread reentry must not deadlock
        self._lock = threading.RLock()
        if self.enabled:
            self._gauge = self.registry.gauge(
                "nns_alert_state",
                "1 while the watch rule is firing (obs/watch.py)",
                labelnames=("rule", "severity"))
            self._fired = self.registry.counter(
                "nns_alerts_fired_total",
                "watch-rule firing transitions",
                labelnames=("rule", "severity"))
            self._samples_total = self.registry.counter(
                "nns_watch_samples_total",
                "watchdog sampling ticks")
            self._scrape_errors = self.registry.counter(
                "nns_watch_scrape_errors_total",
                "failed watchdog scrapes", labelnames=("endpoint",))
            self._fc_value = self.registry.gauge(
                "nns_forecast_value",
                "forecast rule's predicted series value at its "
                "horizon (obs/forecast.py)", labelnames=("rule",))
            self._fc_eta = self.registry.gauge(
                "nns_forecast_eta_seconds",
                "seconds until the forecast rule's predicted "
                "threshold crossing (-1: none in sight)",
                labelnames=("rule",))
            self._headroom = self.registry.gauge(
                "nns_capacity_headroom",
                "fraction of sustainable rate left after the forecast "
                "arrival rate (1 idle, <=0 predicted overload)",
                labelnames=("pool",))

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> bool:
        """Spawn the sampler thread (False — and strictly nothing else
        — under the global obs kill switch: no thread, no rings, no
        export)."""
        if not self.enabled or self._thread is not None:
            return False
        self._stop.clear()
        from . import prof as _prof

        self._thread = _prof.named_thread("watch", "sampler", self._run)
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
                self.sample_once()
            except Exception as e:  # noqa: BLE001 - the watchdog must
                # outlive whatever it watches; one bad sample is logged,
                # not fatal
                from ..utils.log import logw

                logw("nns-watch: sample failed: %s: %s",
                     type(e).__name__, e)

    # -- one tick -------------------------------------------------------------

    def _scrape(self) -> List[dict]:
        if self._source is not None:
            return self._source()
        if self.endpoints:
            return _scrape.fetch_fleet(self.endpoints)
        try:
            return [{"endpoint": "local",
                     "snap": self.registry.snapshot(), "error": None}]
        except Exception as e:  # noqa: BLE001 - same contract as the
            # fleet client: a scrape failure is data, not death
            return [{"endpoint": "local", "snap": None,
                     "error": f"{type(e).__name__}: {e}"}]

    def sample_once(self, now: Optional[float] = None) -> List[dict]:
        """One sampler tick: scrape → ingest → evaluate → act.
        Returns the alert events fired on THIS tick."""
        if not self.enabled:
            return []
        # Scrape OUTSIDE the watch lock: the scrape is a
        # pure read of the registry (its own locks) and can block on a
        # device sync (executable-table join) — holding self._lock
        # across it would stall alerts() readers (the controller tick)
        # for the whole scrape and re-widen the ctl↔watch lock-order
        # surface the _alock split narrowed.
        entries = self._scrape()
        with self._lock:
            now = time.monotonic() if now is None else now
            self.samples += 1
            self._samples_total.labels().inc()
            for entry in entries:
                ep = entry["endpoint"]
                if entry["snap"] is not None:
                    self._fail_streak[ep] = 0
                    self.store.ingest(ep, entry["snap"], now)
                else:
                    self._fail_streak[ep] = \
                        self._fail_streak.get(ep, 0) + 1
                    self._scrape_errors.labels(endpoint=ep).inc()
            fired: List[dict] = []
            for rule in self.rules:
                detail = self._evaluate(rule, now)
                ev = self._transition(rule.name, rule.severity, detail,
                                      now)
                if ev is not None:
                    fired.append(ev)
            ev = self._transition(
                "endpoint-down", "critical",
                self._endpoint_down_detail(), now)
            if ev is not None:
                fired.append(ev)
            self._capacity_tick(entries, now)
            return fired

    def _endpoint_down_detail(self) -> Optional[dict]:
        down = sorted(ep for ep, n in self._fail_streak.items()
                      if n >= self.DOWN_AFTER)
        if not down:
            return None
        return {"value": float(len(down)), "series": {},
                "endpoint": ",".join(down),
                "note": f"{len(down)} endpoint(s) unreachable for >= "
                        f"{self.DOWN_AFTER} consecutive scrapes"}

    # -- rule evaluation ------------------------------------------------------

    def _evaluate(self, rule: AlertRule, now: float) -> Optional[dict]:
        if rule.kind == "threshold":
            return self._eval_threshold(rule, now)
        if rule.kind == "anomaly":
            return self._eval_anomaly(rule, now)
        if rule.kind == "forecast":
            return self._eval_forecast(rule, now)
        return self._eval_burn(rule, now)

    def _sustained(self, rule: AlertRule, key: Tuple, bad: bool,
                   now: float) -> bool:
        """The ``for`` clause: condition held continuously since."""
        st = self._states[rule.name]
        if not bad:
            st.bad_since.pop(key, None)
            return False
        since = st.bad_since.setdefault(key, now)
        return now - since >= rule.for_s

    def _find_den(self, endpoint: str, per: str,
                  labels: Dict[str, str]) -> Optional["_Series"]:
        """The ``per=`` denominator for one numerator series: the
        exact label set when the two families share a schema, else the
        denominator whose every label agrees with the numerator's —
        the join on the SHARED labels.  Without the fallback a ratio
        across families with different label sets can never bind:
        ``nns_admission_shed_total{pool,priority,reason}`` over
        ``nns_admission_submitted_total{pool,priority}`` is the
        default pack's own shed-burn rule.  Two subset matches pick
        the most specific (largest label set)."""
        den = self.store.find(endpoint, per, labels)
        if den is not None:
            return den
        best: Optional[_Series] = None
        for (ep, _fam, _lk), s in self.store.match(per, {}):
            if ep != endpoint:
                continue
            if all(labels.get(k) == v for k, v in s.labels.items()):
                if best is None or len(s.labels) > len(best.labels):
                    best = s
        return best

    def _detail(self, rule: AlertRule, key: Tuple, series: _Series,
                signal: str, value: float, **extra: Any) -> dict:
        return {
            "endpoint": key[0], "metric": rule.metric,
            "signal": signal, "value": value,
            "series": dict(series.labels),
            "points": [(round(t, 4), v)
                       for t, v in series.tail(signal)],
            **extra,
        }

    def _eval_threshold(self, rule: AlertRule,
                        now: float) -> Optional[dict]:
        op = _OPS[rule.op]
        out: Optional[dict] = None
        for key, series in self.store.match(rule.metric, rule.labels):
            signal = rule.signal or SIGNALS_BY_KIND[series.kind][0]
            point = series.last(signal)
            if point is None:
                continue
            v = point[1]
            if rule.per:
                den = self._find_den(key[0], rule.per, series.labels)
                if den is None:
                    continue
                dsig = SIGNALS_BY_KIND[den.kind][0]
                dp = den.last(dsig)
                if dp is None or dp[1] == 0:
                    continue
                v = v / dp[1]
            if self._sustained(rule, key, op(v, rule.value), now) \
                    and out is None:
                out = self._detail(rule, key, series, signal, v,
                                   threshold=rule.value, op=rule.op)
        return out

    def _eval_anomaly(self, rule: AlertRule,
                      now: float) -> Optional[dict]:
        out: Optional[dict] = None
        for key, series in self.store.match(rule.metric, rule.labels):
            signal = rule.signal or SIGNALS_BY_KIND[series.kind][0]
            ring = series.rings.get(signal)
            if not ring or len(ring) < rule.min_samples + 1:
                continue
            values = [v for _t, v in ring]
            baseline = values[-(rule.baseline_points + 1):-1]
            z = _robust_z(baseline, values[-1], rule.rel_floor,
                          rule.abs_floor)
            bad = (z >= rule.z if rule.side == "upper"
                   else z <= -rule.z if rule.side == "lower"
                   else abs(z) >= rule.z)
            if self._sustained(rule, key, bad, now) and out is None:
                out = self._detail(rule, key, series, signal,
                                   values[-1], zscore=round(z, 2))
        return out

    def _eval_forecast(self, rule: AlertRule,
                       now: float) -> Optional[dict]:
        """The predictive kind: fit a robust trend over each bound
        series' ring tail and fire when the PREDICTED value crosses
        the threshold within the horizon (obs/forecast.py owns the
        math and its noise gate).  Also publishes the nearest forecast
        into the ``nns_forecast_*`` gauges and the FORECASTS store —
        the rule is an exporter even while nothing fires."""
        out: Optional[dict] = None
        best: Optional[dict] = None
        for key, series in self.store.match(rule.metric, rule.labels):
            if series.kind == "histogram":
                continue  # forecast binds rates/levels only
            signal = rule.signal or SIGNALS_BY_KIND[series.kind][0]
            # trend memory matched to the prediction span: fit over
            # ~half the horizon of history (clamped).  A full ring can
            # span several horizons, and a Theil-Sen median over that
            # much flat history damps a fresh ramp into invisibility
            # exactly when the forecast must see it.
            n_fit = max(2 * _forecast.MIN_FIT_POINTS,
                        min(int(rule.horizon_s
                                / (2 * self.interval_s)),
                            _forecast.MAX_FIT_POINTS))
            fit = _forecast.fit_trend(series.tail(signal, n_fit))
            if fit is None:
                self._states[rule.name].bad_since.pop(key, None)
                continue
            predicted, eta, crossing = _forecast.forecast_crossing(
                fit, rule.value, rule.op, rule.horizon_s)
            row = {
                "rule": rule.name, "metric": rule.metric,
                "signal": signal, "series": dict(series.labels),
                "endpoint": key[0], "value": predicted,
                "eta_s": eta, "threshold": rule.value,
                "op": rule.op, "horizon_s": rule.horizon_s,
                "slope": fit.slope, "sigma": fit.sigma,
                "firing": crossing,
            }
            if best is None or (eta is not None
                                and (best["eta_s"] is None
                                     or eta < best["eta_s"])):
                best = row
            if self._sustained(rule, key, crossing, now) \
                    and out is None:
                out = self._detail(
                    rule, key, series, signal, predicted,
                    threshold=rule.value, op=rule.op,
                    eta_s=round(eta, 3) if eta is not None else None,
                    horizon_s=rule.horizon_s,
                    slope=fit.slope)
        if best is not None:
            best["firing"] = out is not None
            self._fc_value.labels(rule=rule.name).set(best["value"])
            self._fc_eta.labels(rule=rule.name).set(
                best["eta_s"] if best["eta_s"] is not None else -1.0)
            FORECASTS.update(rule.name, best)
        return out

    def _capacity_tick(self, entries: List[dict], now: float) -> None:
        """The headroom join, once per sample: forecast each pool's
        arrival rate over the capacity horizon (the longest forecast
        rule's, else the default) and compare against the sustainable
        rate extrapolated from live MFU/roofline — falling back to
        window occupancy.  Exports ``nns_capacity_headroom{pool}`` and
        the FORECASTS capacity rows ``/healthz`` summarizes."""
        horizons = [r.horizon_s for r in self.rules
                    if r.kind == "forecast" and r.horizon_s > 0]
        horizon = max(horizons) if horizons \
            else _forecast.HEADROOM_HORIZON_S
        for entry in entries:
            snap = entry.get("snap")
            if not snap:
                continue
            ep = entry["endpoint"]
            execs = [e for e in snap.get("executables") or []
                     if e.get("mfu")]
            for row in snap.get("pools") or []:
                label = row.get("pool", "")
                s = self.store.find(ep, "nns_pool_frames_total",
                                    {"pool": label})
                if s is None:
                    continue
                pts = s.tail("rate", _forecast.MAX_FIT_POINTS)
                if not pts:
                    continue
                current = pts[-1][1]
                fit = _forecast.fit_trend(pts)
                predicted = fit.at(horizon) if fit is not None \
                    else current
                # the pooled model's live MFU vs its roofline ceiling
                # (busiest executable wins when several match)
                model = row.get("model")
                cands = [e for e in execs
                         if e.get("source") == model] or execs
                mfu = ceiling = None
                if cands:
                    top = max(cands, key=lambda e: e.get(
                        "device_seconds_window", 0.0))
                    mfu = top.get("mfu")
                    ceiling = top.get("mfu_ceiling")
                occ = None
                stats = row.get("stats") or {}
                b = row.get("batcher") or {}
                if stats.get("avg_batch_occupancy") \
                        and b.get("max_batch"):
                    occ = stats["avg_batch_occupancy"] / b["max_batch"]
                cap = _forecast.capacity_headroom(
                    current, predicted, mfu=mfu, mfu_ceiling=ceiling,
                    occupancy=occ)
                if cap is None:
                    continue
                self._headroom.labels(pool=label).set(cap["headroom"])
                FORECASTS.update_capacity(label, {
                    "pool": label, "endpoint": ep,
                    "arrival_fps": current,
                    "predicted_fps": max(predicted, 0.0),
                    "horizon_s": horizon, **cap})

    def _eval_burn(self, rule: AlertRule, now: float) -> Optional[dict]:
        out: Optional[dict] = None
        for key, series in self.store.match(rule.metric, rule.labels):
            fracs = {}
            for win, win_s in (("fast", rule.fast_s),
                               ("slow", rule.slow_s)):
                if series.kind == "histogram":
                    slo_ms = rule.slo_ms or self.store.slo_hint(
                        key[0], series.labels.get("pool"))
                    if not slo_ms:
                        fracs = None
                        break
                    dist = series.hist_window(win_s, now)
                    total = sum(dist) if dist else 0.0
                    if total <= 0:
                        fracs = None
                        break
                    fracs[win] = _over_threshold(
                        series.bounds, dist, slo_ms / 1e3) / total
                else:
                    if not rule.per:
                        fracs = None
                        break
                    den = self._find_den(key[0], rule.per,
                                          series.labels)
                    num_d = series.cum_delta_over(win_s, now)
                    den_d = den.cum_delta_over(win_s, now) \
                        if den is not None else None
                    if num_d is None or not den_d:
                        fracs = None
                        break
                    fracs[win] = num_d / den_d
            if fracs is None:
                self._states[rule.name].bad_since.pop(key, None)
                continue
            bad = all(f >= rule.burn * rule.budget
                      for f in fracs.values())
            if self._sustained(rule, key, bad, now) and out is None:
                burn_fast = fracs["fast"] / rule.budget
                out = self._detail(
                    rule, key, series,
                    rule.signal or ("p99" if series.kind == "histogram"
                                    else "rate"),
                    round(burn_fast, 3),
                    err_frac={k: round(v, 5) for k, v in fracs.items()},
                    burn_threshold=rule.burn)
        return out

    # -- transitions + actions ------------------------------------------------

    def _transition(self, name: str, severity: str,
                    detail: Optional[dict],
                    now: float) -> Optional[dict]:
        st = self._states[name]
        firing = detail is not None
        self._gauge.labels(rule=name, severity=severity).set(
            1.0 if firing else 0.0)
        if firing:
            st.detail = detail
        if firing and not st.firing:
            st.firing = True
            st.since = now
            st.fired += 1
            self._fired.labels(rule=name, severity=severity).inc()
            event = {"ts": now, "wall": time.time(), "rule": name,
                     "severity": severity, "detail": detail}
            self.alert_log.append(event)
            self._act_fire(name, severity, detail)
            return event
        if not firing and st.firing:
            st.firing = False
            self._act_resolve(name, severity, now - st.since)
        return None

    def _act_fire(self, name: str, severity: str, detail: dict) -> None:
        """The shipped actions, on the RISING edge only (one firing
        episode = one warning, one dump trigger): log + bus WARNING on
        every registered pipeline, flight-recorder note + async dump
        (the recorder's own rate limit bounds an alert storm; the dump
        work never runs on the sampler thread)."""
        from ..utils.log import logw

        series = detail.get("series", {})
        logw("nns-watch: ALERT %s [%s] %s=%s %s", name, severity,
             detail.get("metric", ""), detail.get("value"),
             series or "")
        # the bus WARNING is rate-limited across ALL rules (one per
        # second): a rule oscillating around its threshold every
        # sampler tick is a new episode per tick, and the pipelines'
        # buses must not drown in it (the log line, counter and
        # recorder note above still record every episode)
        now = time.monotonic()
        if now - self._warn_ts >= 1.0:
            self._warn_ts = now
            try:
                from ..runtime.events import Message, MessageKind

                for pipe in self.registry._live_pipelines():
                    pipe.post(Message(
                        MessageKind.WARNING, "nns-watch",
                        data={"alert": name, "severity": severity,
                              "metric": detail.get("metric", ""),
                              "value": detail.get("value"),
                              "series": series}))
            except Exception:  # noqa: BLE001 - a broken bus handler
                # must not take the watchdog down with it
                pass
        from .flightrec import FLIGHT

        FLIGHT.note("alert", name, severity=severity,
                    metric=detail.get("metric", ""),
                    value=detail.get("value"))
        FLIGHT.trigger_async("alert", name)
        # deep host profile (obs/prof.py): armed via
        # NNS_TPU_TORCH_PROF_DEEP_DIR — the rising edge makes it once per
        # alert episode, the profiler's own min-interval bounds an
        # alert storm, and the capture runs on its own thread, never
        # this sampler's
        from .prof import deep_trigger

        deep_trigger(name)

    def _act_resolve(self, name: str, severity: str,
                     held_s: float) -> None:
        from ..utils.log import logi

        logi("nns-watch: resolved %s [%s] after %.1fs", name, severity,
             held_s)
        from .flightrec import FLIGHT

        FLIGHT.note("alert-resolved", name, severity=severity,
                    held_s=round(held_s, 2))

    # -- pull side ------------------------------------------------------------

    def alerts(self) -> List[dict]:
        """Current state of every rule (what ``nns-watch`` renders)."""
        with self._lock:
            out = []
            by_name = {r.name: r for r in self.rules}
            for name, st in self._states.items():
                rule = by_name.get(name)
                out.append({
                    "rule": name,
                    "severity": rule.severity if rule else "critical",
                    "firing": st.firing,
                    "fired": st.fired,
                    "since": st.since if st.firing else None,
                    "detail": st.detail if st.firing else None,
                })
            out.sort(key=lambda r: (not r["firing"], r["rule"]))
            return out


# -- process-global watchdog (env hook) ---------------------------------------

WATCH: Optional[Watch] = None

_env_checked = False


def maybe_start_from_env() -> None:
    """``NNS_TPU_TORCH_WATCH=<interval_s>`` starts a process-global watchdog
    on first pipeline start (same activation hook as
    ``NNS_TPU_TORCH_METRICS_PORT`` / ``NNS_TPU_TORCH_CHAOS`` /
    ``NNS_TPU_TORCH_FLIGHTREC_DIR``), with the rule set from
    ``NNS_TPU_TORCH_WATCH_RULES`` (or the default pack).  A no-op under the
    global obs kill switch."""
    global _env_checked, WATCH
    if _env_checked:
        return
    _env_checked = True
    spec = os.environ.get("NNS_TPU_TORCH_WATCH", "").strip()
    if not spec or _hooks.DISABLED:
        return
    try:
        interval = float(spec) if spec not in ("1", "true", "yes") \
            else 1.0
        path = os.environ.get("NNS_TPU_TORCH_WATCH_RULES", "").strip()
        store_cfg = load_store(path) if path else {}
        WATCH = Watch(rules=rules_from_env(), interval_s=interval,
                      **store_cfg)
        WATCH.start()
    except (ValueError, RuleError, OSError) as e:
        from ..utils.log import logw

        logw("cannot start watchdog from NNS_TPU_TORCH_WATCH=%s: %s", spec, e)


# -- CLI (`nns-watch`) --------------------------------------------------------


def _render_alerts(alerts: List[dict]) -> str:
    lines = [f"{'RULE':<26}{'SEVERITY':<10}{'STATE':>8}{'FIRED':>7}"
             f"  DETAIL"]
    for a in alerts:
        d = a.get("detail") or {}
        series = d.get("series") or {}
        det = ""
        if a["firing"]:
            det = f"{d.get('metric', '')}={d.get('value')}"
            if series:
                det += " " + ",".join(f"{k}={v}"
                                      for k, v in sorted(series.items()))
        lines.append(
            f"{a['rule']:<26.26}{a['severity']:<10.10}"
            + ("FIRING" if a["firing"] else "ok").rjust(8)
            + str(a["fired"]).rjust(7) + ("  " + det if det else ""))
    return "\n".join(lines)


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="nns-torch-watch",
        description="Alerting watchdog over the metrics registry: "
                    "sample, evaluate rules, alarm")
    p.add_argument("--connect", metavar="HOST:PORT[,HOST:PORT...]",
                   action="append", default=None,
                   help="watch remote /json endpoints (fleet mode; "
                        "repeat or comma-separate); default: the "
                        "in-process registry")
    p.add_argument("--rules", default=None, metavar="FILE",
                   help="TOML/JSON rules file (default: "
                        "$NNS_TPU_TORCH_WATCH_RULES, else the built-in pack)")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between samples (default 1)")
    p.add_argument("--once", type=int, default=None, metavar="N",
                   help="take N samples, print the alert table, exit "
                        "(1 when anything is firing)")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="machine-readable output")
    return p


def main(argv=None, out=None) -> int:
    import sys

    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    try:
        rules = load_rules(args.rules) if args.rules else rules_from_env()
        path = args.rules \
            or os.environ.get("NNS_TPU_TORCH_WATCH_RULES", "").strip()
        store_cfg = load_store(path) if path else {}
    except (RuleError, OSError) as e:
        print(f"nns-watch: bad rules: {e}", file=sys.stderr)
        return 2
    endpoints: List[str] = []
    for item in args.connect or []:
        endpoints.extend(tok.strip() for tok in str(item).split(",")
                         if tok.strip())
    try:
        w = Watch(rules=rules, interval_s=args.interval,
                  endpoints=endpoints or None, **store_cfg)
    except RuleError as e:
        print(f"nns-watch: bad rules: {e}", file=sys.stderr)
        return 2
    if not w.enabled:
        print("nns-watch: observability disabled "
              "(NNS_TPU_TORCH_OBS_DISABLE) — nothing to do", file=sys.stderr)
        return 2
    try:
        if args.once is not None:
            for i in range(max(args.once, 1)):
                if i:
                    time.sleep(args.interval)
                w.sample_once()
            alerts = w.alerts()
            if args.as_json:
                print(json.dumps(alerts, indent=1, default=str),
                      file=out)
            else:
                print(_render_alerts(alerts), file=out)
            return 1 if any(a["firing"] for a in alerts) else 0
        while True:
            events = w.sample_once()
            for ev in events:
                if args.as_json:
                    print(json.dumps(ev, default=str), file=out)
                else:
                    d = ev["detail"] or {}
                    print(f"ALERT {ev['rule']} [{ev['severity']}] "
                          f"{d.get('metric', '')}={d.get('value')} "
                          f"{d.get('series', '')}", file=out)
            out.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
