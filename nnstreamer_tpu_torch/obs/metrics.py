"""Process-wide metrics registry: counters, gauges, histograms + the
pipeline collector that absorbs the runtime's scattered stats.

Counterpart of the JAX package's ``obs/metrics.py``: the same family
names, label sets, exposition and snapshot keys, so a scraper or
dashboard built for the JAX package reads the port unchanged.  Two kinds
of metric enter one registry:

- **Instruments** — labeled ``Counter``/``Gauge``/``Histogram`` families
  created via :meth:`MetricsRegistry.counter` etc., bumped directly by
  whoever owns them (thread-safe, one lock per family).
- **Collected state** — the stats the runtime already keeps are *pulled*
  at scrape time, not pushed per buffer: ``Element.count_stat`` flow
  counters, ``InvokeStats.snapshot()``, MicroBatcher/SharedBatcher flush
  reasons and pending depth, ``queue`` depth/drops, the serving
  ``ModelPool`` entries, and the transfer, device-memory, executable,
  stage and tenant tables.  A pipeline registers itself on ``start()``
  and unregisters on ``stop()`` (weakly referenced); between scrapes the
  hot path pays **nothing** beyond the counters it was already keeping,
  which is why passive metrics stay within 3% of the frame rate.

Outputs:

- :meth:`MetricsRegistry.exposition` — Prometheus text format 0.0.4;
- :meth:`MetricsRegistry.snapshot` — one JSON-able dict with the flat
  metric families and the structured per-pipeline/per-pool tables;
- :func:`serve_metrics` — a stdlib-http endpoint: ``/metrics`` (text),
  ``/json`` and ``/snapshot`` (the snapshot), ``/healthz`` and ``/dump``
  (the flight recorder).  ``NNS_TPU_TORCH_METRICS_PORT`` serves the
  global registry when the first pipeline starts.

The active layer feeds it too: the ``forecasts`` table (``obs/forecast.py``,
filled by a running watchdog), the ``control`` table (``obs/control.py``),
the ``profile`` table and the host-profiler families (``obs/prof.py``),
``/prof`` (the profiler's stacks), and ``/healthz``'s ``alerts``,
``control``, ``capacity`` and ``prof`` sections.  The parallel layer
feeds the ``mesh`` table (``obs/meshstat.py``: the ``nns_shard_imbalance``
and ``nns_mesh_*`` families), the ``nns_placement_overlap`` gauges and
the pool rows' ``placement``/``stage``/``mesh`` join (``nns_pool_shards``,
``nns_pool_shard_imbalance``, ``nns_pool_pad_frac``).  Absent rather than
stubbed: the snapshot's ``compiles`` (the port compiles no XLA programs).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..utils.conf import ENV_PREFIX

#: the environment key that serves the global registry
PORT_ENV = f"{ENV_PREFIX}METRICS_PORT"

#: the JAX package's snapshot version whose tables the port's share: its
#: keys are a subset of that version's (see the module doc for the
#: tables that wait for later slices)
SNAPSHOT_VERSION = 10

_KINDS = ("counter", "gauge", "histogram")


def _fmt_value(v: float) -> str:
    """Prometheus sample value: ints bare, floats repr'd."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    esc = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")
        esc.append(f'{k}="{v}"')
    return "{" + ",".join(esc) + "}"


class _Child:
    """One labeled time series of a family."""

    __slots__ = ("_family", "labels", "value", "_buckets", "_sum", "_count")

    def __init__(self, family: "Family", labels: Dict[str, str]):
        self._family = family
        self.labels = labels
        self.value = 0.0
        if family.kind == "histogram":
            self._buckets = [0] * len(family.buckets)
            self._sum = 0.0
            self._count = 0

    def inc(self, n: float = 1.0) -> None:
        if self._family.kind == "histogram":
            raise ValueError("inc() on a histogram (use observe())")
        if self._family.kind == "counter" and n < 0:
            raise ValueError("counters only go up")
        with self._family._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        if self._family.kind != "gauge":
            raise ValueError(f"dec() on a {self._family.kind}")
        with self._family._lock:
            self.value -= n

    def set(self, v: float) -> None:
        if self._family.kind != "gauge":
            raise ValueError(f"set() on a {self._family.kind}")
        with self._family._lock:
            self.value = float(v)

    def observe(self, v: float) -> None:
        if self._family.kind != "histogram":
            raise ValueError(f"observe() on a {self._family.kind}")
        with self._family._lock:
            self._sum += v
            self._count += 1
            # non-cumulative per-bucket counts; the exposition renderer
            # cumulates them into Prometheus `le` semantics
            for i, le in enumerate(self._family.buckets):
                if v <= le:
                    self._buckets[i] += 1
                    break

    def hist_state(self) -> Tuple[List[int], float, int]:
        """One consistent read of this histogram child's cumulative
        state: (per-bucket counts [non-cumulative], sum, count).  The
        consumer API for controllers that derive their signal from the
        exported histogram (runtime/admission.py) — the same numbers a
        scrape renders, read under the same lock."""
        if self._family.kind != "histogram":
            raise ValueError(f"hist_state() on a {self._family.kind}")
        with self._family._lock:
            return list(self._buckets), self._sum, self._count

    @property
    def bucket_bounds(self) -> Tuple[float, ...]:
        return self._family.buckets


class Family:
    """A named metric with a fixed label schema; ``labels()`` returns
    (creating on first use) the child series for one label value set."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Tuple[str, ...] = (),
                 buckets: Optional[Tuple[float, ...]] = None):
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.help = help
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets or ()) if kind == "histogram" else ()
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def labels(self, **kv: Any) -> _Child:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Child(self, dict(zip(self.labelnames, key)))
                self._children[key] = child
            return child

    def collect(self) -> List[Tuple[Dict[str, str], float]]:
        """(labels, value) samples; histograms expand to
        ``_bucket``/``_sum``/``_count`` in the exposition renderer."""
        with self._lock:
            return [(dict(c.labels), c.value)
                    for c in self._children.values()]

    def _hist_rows(self):
        with self._lock:
            return [(dict(c.labels), list(c._buckets), c._sum, c._count)
                    for c in self._children.values()]


class MetricsRegistry:
    """Thread-safe registry of instrument families + pull collectors."""

    DEFAULT_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1,
                       .25, .5, 1.0, 2.5, 5.0, float("inf"))

    def __init__(self, collect_links: bool = False,
                 collect_transfers: bool = False,
                 collect_devices: bool = False,
                 collect_executables: bool = False,
                 collect_mesh: bool = False,
                 collect_stages: bool = False,
                 collect_tenants: bool = False,
                 collect_prof: bool = False):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}
        self._collectors: List[Callable[[], Iterable[tuple]]] = []
        self._pipelines: Dict[int, Any] = {}  # id -> weakref.ref
        self._server = None
        # the LinkMetrics, TransferLedger, device-memory, XlaCostStats,
        # MeshStats, stage and tenant stores are process-wide: only registries that
        # opt in — the global REGISTRY does — pull them, so a
        # private/test registry's exposition isn't polluted by unrelated
        # state.  The executables join is additionally STATEFUL
        # (scrape-to-scrape delta windows), so exactly one registry
        # should drive it.
        self._collect_links = bool(collect_links)
        self._collect_transfers = bool(collect_transfers)
        self._collect_devices = bool(collect_devices)
        self._collect_executables = bool(collect_executables)
        self._collect_mesh = bool(collect_mesh)
        self._collect_stages = bool(collect_stages)
        self._collect_tenants = bool(collect_tenants)
        self._collect_prof = bool(collect_prof)

    # -- instruments ---------------------------------------------------------

    def _family(self, name: str, help: str, kind: str,
                labelnames=(), buckets=None) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, help, kind, labelnames, buckets)
                self._families[name] = fam
            elif fam.kind != kind or fam.labelnames != tuple(labelnames) \
                    or (kind == "histogram"
                        and fam.buckets != tuple(buckets or ())):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} "
                    f"with labels {fam.labelnames}"
                    + (f" and buckets {fam.buckets}"
                       if fam.kind == "histogram" else ""))
            return fam

    def counter(self, name: str, help: str = "", labelnames=()) -> Family:
        return self._family(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Family:
        return self._family(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets: Optional[Tuple[float, ...]] = None) -> Family:
        b = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        if b[-1] != float("inf"):
            b = b + (float("inf"),)
        return self._family(name, help, "histogram", labelnames, b)

    # -- pull collectors -----------------------------------------------------

    def register_collector(self, fn: Callable[[], Iterable[tuple]]) -> None:
        """``fn()`` yields ``(name, kind, help, labels, value)`` tuples at
        every scrape (the Prometheus custom-collector pattern)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # -- pipeline registration (runtime/pipeline.py drives this) -------------

    def register_pipeline(self, pipe) -> None:
        import weakref

        with self._lock:
            self._pipelines[id(pipe)] = weakref.ref(pipe)
        maybe_serve_from_env(self)

    def unregister_pipeline(self, pipe) -> None:
        with self._lock:
            self._pipelines.pop(id(pipe), None)

    def _live_pipelines(self) -> List[Any]:
        with self._lock:
            refs = list(self._pipelines.items())
        out = []
        for key, ref in refs:
            p = ref()
            if p is None:
                with self._lock:
                    self._pipelines.pop(key, None)
            else:
                out.append(p)
        return out

    # -- outputs -------------------------------------------------------------

    def collect(self) -> "Dict[str, dict]":
        """name -> {name, kind, help, samples:[{labels, value}]} merged
        from instruments, collector callbacks, and registered
        pipelines."""
        return self._collect_all()[-1]

    def _collect_all(self):
        """ONE walk of the runtime state per scrape: the structured
        per-pipeline/per-pool/per-link/compile tables are read first
        (one lock acquisition per element-stats dict / InvokeStats /
        LinkMetrics / CompileStats / TransferLedger), and the flat
        metric samples are DERIVED from those tables — so the two
        views in one snapshot can never disagree, and the hot-path
        locks are not taken a second time.  Returns ``(tables, pools,
        models, links, transfers, devmem, execs, mesh, stages, tenants,
        fams)``."""
        fams: Dict[str, dict] = {}
        with self._lock:
            instruments = list(self._families.values())
            collectors = list(self._collectors)
        tables = [_pipeline_table(p) for p in self._live_pipelines()]
        pools = _pool_table()
        models = _models_table()
        links = _link_table() if self._collect_links else []
        transfers = _transfer_table() if self._collect_transfers else []
        devmem = _device_table() if self._collect_devices else []
        execs, exec_util = _executable_join() \
            if self._collect_executables else ([], [])
        mesh = _mesh_table() if self._collect_mesh else []
        stages = _stage_table() if self._collect_stages else []
        tenants = _tenant_table() if self._collect_tenants else []

        def add(name, kind, help, labels, value, sample_name=None):
            fam = fams.setdefault(name, {
                "name": name, "kind": kind, "help": help, "samples": []})
            sample = {"labels": dict(labels), "value": value}
            if sample_name is not None:
                # histogram sub-series (name_bucket/_sum/_count) stay
                # under ONE family so the exposition declares a single
                # `# TYPE <name> histogram` (Prometheus text 0.0.4)
                sample["name"] = sample_name
            fam["samples"].append(sample)

        for f in instruments:
            if f.kind == "histogram":
                for labels, buckets, s, n in f._hist_rows():
                    for le, cum in zip(f.buckets, _cumulate(buckets)):
                        add(f.name, "histogram", f.help,
                            {**labels, "le": _le_str(le)}, cum,
                            sample_name=f.name + "_bucket")
                    add(f.name, "histogram", f.help, labels, s,
                        sample_name=f.name + "_sum")
                    add(f.name, "histogram", f.help, labels, n,
                        sample_name=f.name + "_count")
            else:
                for labels, value in f.collect():
                    add(f.name, f.kind, f.help, labels, value)
        for fn in collectors:
            for name, kind, help, labels, value in fn():
                add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _pipeline_samples(tables):
            add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _pool_samples(pools):
            add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _model_samples(models):
            add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _link_samples(links):
            add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _transfer_samples(transfers):
            add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _device_samples(devmem):
            add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _executable_samples(execs):
            add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _util_samples(exec_util):
            add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _mesh_samples(mesh):
            add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _stage_samples(stages):
            add(name, kind, help, labels, value)
        if self._collect_stages:
            for name, kind, help, labels, value \
                    in _placement_overlap_samples():
                add(name, kind, help, labels, value)
        for name, kind, help, labels, value in _tenant_samples(tenants):
            add(name, kind, help, labels, value)
        from .transfer import TRANSFER_SECONDS_BUCKETS

        for row in transfers:
            # per-row transfer duration distribution as a proper
            # Prometheus histogram (bucket/sum/count under ONE TYPE)
            labels = {"pipeline": row["pipeline"],
                      "source": row["source"],
                      "direction": row["direction"],
                      "reason": row["reason"]}
            hname = "nns_transfer_seconds"
            hhelp = "duration of one host<->device crossing"
            for le, cum in zip(TRANSFER_SECONDS_BUCKETS,
                               _cumulate(row["buckets"])):
                add(hname, "histogram", hhelp,
                    {**labels, "le": _le_str(le)}, cum,
                    sample_name=hname + "_bucket")
            add(hname, "histogram", hhelp, labels, row["seconds"],
                sample_name=hname + "_sum")
            add(hname, "histogram", hhelp, labels, row["count"],
                sample_name=hname + "_count")
        for row in links:
            # the RTT distribution renders as a proper Prometheus
            # histogram (bucket/sum/count under ONE TYPE declaration)
            labels = {"link": row["link"], "peer": row["peer"],
                      "kind": row["kind"]}
            rtt = row["rtt"]
            hname = "nns_edge_rtt_seconds"
            hhelp = "request round-trip time over the link"
            for le, cum in zip(EDGE_RTT_BUCKETS,
                               _cumulate(rtt["buckets"])):
                add(hname, "histogram", hhelp,
                    {**labels, "le": _le_str(le)}, cum,
                    sample_name=hname + "_bucket")
            add(hname, "histogram", hhelp, labels, rtt["sum_s"],
                sample_name=hname + "_sum")
            add(hname, "histogram", hhelp, labels, rtt["count"],
                sample_name=hname + "_count")
        # host-execution profiler (obs/prof.py): the exact per-element
        # run/wait/CPU accumulators as counter families, plus the
        # sampled GIL-pressure proxy while the profiler runs; the
        # accounts store is process-wide, so (like the ledgers above)
        # only opted-in registries pull it
        from . import prof as _prof

        prof_rows = _prof.account_rows() if self._collect_prof else []
        for row in prof_rows:
            labels = {"pipeline": row["pipeline"],
                      "element": row["element"]}
            add("nns_element_cpu_seconds_total", "counter",
                "host CPU seconds consumed by the element's loop "
                "thread", labels, row["cpu_s"])
            add("nns_element_run_seconds_total", "counter",
                "wall seconds the element loop spent running its "
                "chain", labels, row["run_s"])
            add("nns_element_wait_seconds_total", "counter",
                "wall seconds the element loop spent waiting for "
                "work", labels, row["wait_s"])
        if self._collect_prof and _prof.PROFILER.running:
            add("nns_gil_waiters", "gauge",
                "sampled runnable-but-not-running threads (GIL "
                "pressure proxy)", {},
                float(_prof.PROFILER.gil_waiters))
        return (tables, pools, models, links, transfers, devmem, execs,
                mesh, stages, tenants, fams)

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        fams = self.collect()
        for name in sorted(fams):
            fam = fams[name]
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for s in fam["samples"]:
                lines.append(
                    f"{s.get('name', name)}{_fmt_labels(s['labels'])} "
                    f"{_fmt_value(s['value'])}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """One JSON-able dict: the flat metric families plus the
        structured per-pipeline / per-pool / per-link / transfer /
        device-memory / executable / stage / tenant tables — all views
        derived from the same single read of the runtime state (see
        :meth:`_collect_all`)."""
        (tables, pools, models, links, transfers, devmem, execs, mesh,
         stages, tenants, fams) = self._collect_all()
        return {
            "version": SNAPSHOT_VERSION,
            "time": time.time(),
            "host": _host_tag(),
            "pipelines": tables,
            "pools": pools,
            "models": models,
            "links": links,
            "transfers": transfers,
            "device_memory": devmem,
            "executables": execs,
            "mesh": mesh,
            "stages": stages,
            "tenants": tenants,
            "forecasts": _forecast_table(),
            "control": _control_table(),
            "profile": _profile_table(),
            "metrics": fams,
        }

    def serve(self, port: int = 0, host: str = "127.0.0.1"
              ) -> "MetricsServer":
        """Start (once) the background HTTP endpoint for this registry.
        A closed server deregisters itself, so serve() after close()
        starts a fresh listener instead of returning the dead one."""
        with self._lock:
            if self._server is None:
                self._server = MetricsServer(self, port=port, host=host)
            return self._server


def _host_tag() -> str:
    from .tracectx import host_tag

    return host_tag()


def _cumulate(buckets: List[int]) -> List[int]:
    out, acc = [], 0
    for b in buckets:
        acc += b
        out.append(acc)
    return out


def bucket_quantile(bounds: Tuple[float, ...], dist: List[float],
                    q: float) -> Optional[float]:
    """Interpolated quantile of one NON-cumulative bucket distribution
    (``dist[i]`` observations in ``(bounds[i-1], bounds[i]]``): the one
    histogram→quantile definition in the package, the admission
    controller's shed signal (``runtime/admission.py``), so the number an
    external controller derives from a scrape is bit-identical to the
    one the in-process shedder acts on.

    Linear interpolation within the bucket where the cumulative
    fraction crosses ``q``; ``None`` when the distribution is empty or
    the quantile lands in the ``+Inf`` bucket (no upper bound to
    interpolate toward — callers fall back to their own signal)."""
    total = sum(dist)
    if total <= 0:
        return None
    target = q * total
    acc = 0.0
    for i, n in enumerate(dist):
        if acc + n >= target and n > 0:
            hi = bounds[i]
            if hi == float("inf"):
                return None
            lo = bounds[i - 1] if i > 0 else 0.0
            return lo + (hi - lo) * (target - acc) / n
        acc += n
    return None


def _le_str(le: float) -> str:
    return "+Inf" if le == float("inf") else _fmt_value(le)


# -- the pipeline walk (pull side) -------------------------------------------


def _factory(e) -> str:
    return getattr(e, "FACTORY", "") or type(e).__name__


def pool_label(entry) -> str:
    """Stable short label of a ModelPool entry: framework:model-tail."""
    key = getattr(entry, "key", ("?", "?"))
    model = os.path.basename(str(key[1] if len(key) > 1 else "?"))
    return f"{key[0]}:{model}"


def _batcher_info(b) -> Optional[dict]:
    if b is None:
        return None
    return {
        "pending": b.pending,
        "max_batch": b.max_batch,
        "flushes": {"full": b.flushes_full,
                    "deadline": b.flushes_deadline,
                    "forced": b.flushes_forced,
                    "adaptive": b.flushes_adaptive},
    }


def _element_row(e) -> dict:
    with e._stats_lock:
        stats = dict(e.stats)
    row: dict = {"element": e.name, "factory": _factory(e),
                 "stats": stats}
    if hasattr(e, "current_level_buffers"):
        row["queue"] = {"depth": e.current_level_buffers,
                        "capacity": int(getattr(e, "max_size_buffers", 0))}
    inv = getattr(e, "invoke_stats", None)
    if inv is not None:
        f = inv.snapshot()
        f["batch"] = int(getattr(e, "batch", 1) or 1)
        b = _batcher_info(getattr(e, "_batcher", None))
        if b is not None:
            f["batcher"] = b
        mn = getattr(getattr(e, "subplugin", None), "model_name", None)
        if callable(mn):
            # join key for the executables table (obs/xlacost.py): the
            # model this element's dispatches run
            f["model"] = mn()
        entry = getattr(e, "_pool_entry", None)
        if entry is not None:
            f["pool"] = pool_label(entry)
        else:
            # executable-cache counters of THIS element's own sub-plugin
            # instance; pooled elements share the pool's instance, whose
            # counters export once on the POOL row instead
            cache = getattr(getattr(e, "subplugin", None),
                            "cache_snapshot", None)
            if callable(cache):
                f["cache"] = cache()
        row["filter"] = f
    return row


def _pipeline_table(pipe) -> dict:
    return {
        "pipeline": pipe.name,
        "playing": bool(getattr(pipe, "playing", False)),
        "elements": [_element_row(e)
                     for e in list(pipe.elements.values())],
    }


def _pool_entries() -> List[Any]:
    try:
        from ..runtime.serving import MODEL_POOL
    except ImportError:  # pragma: no cover - partial checkouts
        return []
    with MODEL_POOL._lock:
        return list(MODEL_POOL._entries.values())


def _pool_table() -> List[dict]:
    out = []
    for entry in _pool_entries():
        row = {
            "pool": pool_label(entry),
            "refcount": entry.refcount,
            "streams": entry.attached_streams,
            "stats": entry.stats.snapshot(),
        }
        cache = getattr(entry.subplugin, "cache_snapshot", None)
        if callable(cache):
            row["cache"] = cache()
        mn = getattr(entry.subplugin, "model_name", None)
        if callable(mn):
            row["model"] = mn()
        weights = getattr(entry.subplugin, "weight_bytes", None)
        if callable(weights):
            w = weights()
            if w is not None:
                # params footprint + placement of the pooled model —
                # the nns_model_weight_bytes{pool,placement} gauge
                row["weights"] = w
        rp = getattr(entry, "placement", None)
        if rp is not None:
            # pool <-> mesh join: the entry's placement names the shard
            # topology, the MESH_STATS row (keyed by the pooled model)
            # how this pool's windows actually split
            from .meshstat import MESH_STATS

            row["placement"] = rp.describe()
            # which explicit device subset ("0-3") this pool's stage
            # runs on — "" for whole-inventory placements
            row["stage"] = getattr(rp, "stage", "")
            m = MESH_STATS.get(row.get("model", "")) or {}
            sf = m.get("shard_frames") or []
            total = sum(sf)
            row["mesh"] = {
                "shards": int(rp.data_axis_size),
                "processes": int(rp.num_processes),
                "max_shard_share": (max(sf) / total) if total else 0.0,
                "imbalance": m.get("imbalance", 0.0),
                "pad_frac": m.get("pad_frac", 0.0),
                "replicated_dispatches": m.get(
                    "replicated_dispatches", 0),
            }
        b = _batcher_info(getattr(entry, "batcher", None))
        if b is not None:
            row["batcher"] = b
        adm = getattr(entry, "admission", None)
        if adm is not None:
            row["admission"] = adm.snapshot()
        lc = getattr(entry, "_lifecycle", None)
        if lc is not None and lc.engaged:
            # model-lifecycle join (runtime/lifecycle.py): swap /
            # canary state NEXT TO the pool's serving stats; the
            # per-version detail lives in the snapshot's `models` table
            row["lifecycle"] = lc.summary()
        out.append(row)
    return out


def _models_table() -> List[dict]:
    """The snapshot v7 ``models`` table: one row per (pool, model
    version) with that version's serving stats, state and provenance —
    present only for pools whose lifecycle was ENGAGED (a pool that
    never swapped has exactly one implicit version: itself)."""
    rows: List[dict] = []
    for entry in _pool_entries():
        lc = getattr(entry, "_lifecycle", None)
        if lc is not None and lc.engaged:
            rows.extend(lc.snapshot_rows())
    return rows


#: numeric encoding of the version states on nns_model_version_state
_MODEL_STATE_CODE = {"staged": 0, "serving": 1, "canary": 2,
                     "retired": 3, "rolled-back": 4}


def _model_samples(models) -> Iterable[tuple]:
    """Flat ``nns_model_version_*`` samples derived from the models
    table (same single-read rule as :func:`_pipeline_samples`)."""
    for row in models:
        labels = {"pool": row["pool"], "version": row["version"]}
        yield ("nns_model_version_invokes_total", "counter",
               "dispatches served by this model version", labels,
               row["invokes"])
        yield ("nns_model_version_frames_total", "counter",
               "frames served by this model version", labels,
               row["frames"])
        yield ("nns_model_version_errors_total", "counter",
               "failed dispatches attributed to this version", labels,
               row["errors"])
        if row["latency_us"] >= 0:
            yield ("nns_model_version_latency_us", "gauge",
                   "rolling mean dispatch latency of this version "
                   "(sampled)", labels, row["latency_us"])
        yield ("nns_model_version_state", "gauge",
               "lifecycle state (0 staged, 1 serving, 2 canary, "
               "3 retired, 4 rolled-back)", labels,
               _MODEL_STATE_CODE.get(row["state"], -1))


# -- edge link metrics (nns_edge_*) -------------------------------------------

#: RTT histogram bounds (seconds): 100µs loopback .. multi-second WAN
EDGE_RTT_BUCKETS = (.0001, .00025, .0005, .001, .0025, .005, .01, .025,
                    .05, .1, .25, .5, 1.0, 2.5, float("inf"))


class LinkMetrics:
    """Per-connection edge-link stats (``nns_edge_*``): bytes/messages
    tx+rx, RTT distribution, in-flight requests, timeouts, reconnects.
    The port's edge transports and elements (``edge/``) feed it.

    One instance per (kind, link, peer) — ``kind`` names the role
    (``query``/``query-server``/``edge``...), ``link`` the owning
    element, ``peer`` the remote address.  Obtained via :meth:`get`
    (process-wide registry, same instance across reconnects so the
    counters stay monotonic); the transports bump bytes per framed
    message, the elements bump RTT/in-flight/timeouts.  Pulled into the
    global registry at scrape time like every other collected stat —
    the snapshot's ``links`` table and the flat ``nns_edge_*`` samples
    derive from one consistent read."""

    _REG_LOCK = threading.Lock()
    _REG: Dict[Tuple[str, str, str], "LinkMetrics"] = {}

    def __init__(self, link: str, peer: str, kind: str = "edge"):
        self.link, self.peer, self.kind = link, peer, kind
        self._lock = threading.Lock()
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.tx_msgs = 0
        self.rx_msgs = 0
        self.inflight = 0
        self.timeouts = 0
        self.reconnects = 0
        self.bad_frames = 0  # frames rejected by the wire codec
        # retry-policy state (the edge links' retry policy): breaker_state is
        # 0 closed / 1 half-open / 2 open, backoff_level the failure
        # streak driving the exponential delay
        self.backoff_level = 0
        self.breaker_state = 0
        self.breaker_opens = 0
        self._rtt_buckets = [0] * len(EDGE_RTT_BUCKETS)
        self._rtt_sum = 0.0
        self._rtt_count = 0
        self._rtt_last: Optional[float] = None

    @classmethod
    def get(cls, link: str, peer: str, kind: str = "edge") -> "LinkMetrics":
        key = (kind, str(link), str(peer))
        with cls._REG_LOCK:
            m = cls._REG.get(key)
            if m is None:
                m = cls(str(link), str(peer), kind)
                cls._REG[key] = m
            return m

    @classmethod
    def all_links(cls) -> List["LinkMetrics"]:
        with cls._REG_LOCK:
            return [cls._REG[k] for k in sorted(cls._REG)]

    @classmethod
    def clear_all(cls) -> None:
        """Tests only: drop every registered link."""
        with cls._REG_LOCK:
            cls._REG.clear()

    # -- producers (transports + elements) -----------------------------------

    def on_tx(self, nbytes: int) -> None:
        with self._lock:
            self.tx_bytes += int(nbytes)
            self.tx_msgs += 1

    def on_rx(self, nbytes: int) -> None:
        with self._lock:
            self.rx_bytes += int(nbytes)
            self.rx_msgs += 1

    def observe_rtt(self, seconds: float) -> None:
        with self._lock:
            self._rtt_sum += seconds
            self._rtt_count += 1
            self._rtt_last = seconds
            for i, le in enumerate(EDGE_RTT_BUCKETS):
                if seconds <= le:
                    self._rtt_buckets[i] += 1
                    break

    def set_inflight(self, n: int) -> None:
        with self._lock:
            self.inflight = int(n)

    def timeout(self) -> None:
        with self._lock:
            self.timeouts += 1

    def reconnect(self) -> None:
        with self._lock:
            self.reconnects += 1

    def on_bad_frame(self) -> None:
        """A received frame the wire codec rejected (e.g. corrupted in
        transit): dropped, but never silently — this counter is part of
        the zero-silent-drops accounting."""
        with self._lock:
            self.bad_frames += 1

    def set_retry_state(self, state: int, level: int, opens: int) -> None:
        """Mirror of the link's retry policy state."""
        with self._lock:
            self.breaker_state = int(state)
            self.backoff_level = int(level)
            self.breaker_opens = int(opens)

    # -- pull side -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "link": self.link, "peer": self.peer, "kind": self.kind,
                "tx_bytes": self.tx_bytes, "rx_bytes": self.rx_bytes,
                "tx_msgs": self.tx_msgs, "rx_msgs": self.rx_msgs,
                "inflight": self.inflight,
                "timeouts": self.timeouts,
                "reconnects": self.reconnects,
                "bad_frames": self.bad_frames,
                "backoff_level": self.backoff_level,
                "breaker_state": self.breaker_state,
                "breaker_opens": self.breaker_opens,
                "rtt": {
                    "count": self._rtt_count,
                    "sum_s": self._rtt_sum,
                    "mean_us": (self._rtt_sum / self._rtt_count * 1e6)
                    if self._rtt_count else None,
                    "last_us": self._rtt_last * 1e6
                    if self._rtt_last is not None else None,
                    "buckets": list(self._rtt_buckets),
                },
            }


def _link_table() -> List[dict]:
    return [m.snapshot() for m in LinkMetrics.all_links()]


def _link_samples(links) -> Iterable[tuple]:
    """Flat ``nns_edge_*`` samples derived from the structured link
    table (same single-read rule as :func:`_pipeline_samples`); the RTT
    histogram expands separately in ``_collect_all``."""
    for row in links:
        labels = {"link": row["link"], "peer": row["peer"],
                  "kind": row["kind"]}
        yield ("nns_edge_tx_bytes_total", "counter",
               "bytes sent over the link (framed size)", labels,
               row["tx_bytes"])
        yield ("nns_edge_rx_bytes_total", "counter",
               "bytes received over the link (framed size)", labels,
               row["rx_bytes"])
        yield ("nns_edge_tx_messages_total", "counter",
               "messages sent over the link", labels, row["tx_msgs"])
        yield ("nns_edge_rx_messages_total", "counter",
               "messages received over the link", labels, row["rx_msgs"])
        yield ("nns_edge_inflight", "gauge",
               "requests awaiting an answer", labels, row["inflight"])
        yield ("nns_edge_timeouts_total", "counter",
               "requests that outlived their deadline", labels,
               row["timeouts"])
        yield ("nns_edge_reconnects_total", "counter",
               "mid-stream failovers/reconnects", labels,
               row["reconnects"])
        yield ("nns_edge_bad_frames_total", "counter",
               "received frames rejected by the wire codec", labels,
               row.get("bad_frames", 0))
        yield ("nns_edge_backoff_level", "gauge",
               "consecutive reconnect failures driving the backoff",
               labels, row.get("backoff_level", 0))
        yield ("nns_edge_breaker_state", "gauge",
               "circuit breaker: 0 closed / 1 half-open / 2 open",
               labels, row.get("breaker_state", 0))
        yield ("nns_edge_breaker_opens_total", "counter",
               "times the link's circuit breaker opened", labels,
               row.get("breaker_opens", 0))


def _pipeline_samples(tables) -> Iterable[tuple]:
    """Flat samples DERIVED from the structured pipeline tables (one
    read of the runtime state per scrape — the hot path never pushed
    any of these).  Unknown values (the InvokeStats ``-1`` "no data
    yet" sentinels) are omitted rather than exported as time-series
    points."""
    for table in tables:
        pl = table["pipeline"]
        for row in table["elements"]:
            labels = {"pipeline": pl, "element": row["element"]}
            for key, val in sorted(row["stats"].items()):
                if key == "buffers_in":
                    yield ("nns_element_buffers_in_total", "counter",
                           "buffers entering the element", labels, val)
                elif key == "buffers_out":
                    yield ("nns_element_buffers_out_total", "counter",
                           "buffers leaving the element", labels, val)
                else:
                    yield ("nns_element_stat_total", "counter",
                           "per-element flow counter",
                           {**labels, "stat": key}, val)
            q = row.get("queue")
            if q is not None:
                yield ("nns_queue_depth", "gauge",
                       "buffers parked in the queue", labels,
                       q["depth"])
                yield ("nns_queue_capacity", "gauge",
                       "queue bound (max-size-buffers)", labels,
                       q["capacity"])
            s = row.get("filter")
            if s is not None:
                yield ("nns_filter_invokes_total", "counter",
                       "dispatches issued", labels, s["invokes"])
                yield ("nns_filter_frames_total", "counter",
                       "frames carried by those dispatches", labels,
                       s["frames"])
                if s["latency_us"] >= 0:
                    yield ("nns_filter_latency_us", "gauge",
                           "rolling mean invoke latency (sampled)",
                           labels, s["latency_us"])
                if s["throughput_milli_fps"] >= 0:
                    yield ("nns_filter_throughput_milli_fps", "gauge",
                           "1000x frames/s over the run", labels,
                           s["throughput_milli_fps"])
                if s["dispatch_milli_fps"] >= 0:
                    yield ("nns_filter_dispatch_milli_fps", "gauge",
                           "1000x dispatches/s over the run", labels,
                           s["dispatch_milli_fps"])
                yield ("nns_filter_batch_occupancy", "gauge",
                       "mean frames per dispatch", labels,
                       s["avg_batch_occupancy"])
                yield ("nns_filter_stream_occupancy", "gauge",
                       "mean distinct streams per dispatch", labels,
                       s["avg_stream_occupancy"])
                b = s.get("batcher")
                if b is not None:
                    yield ("nns_batcher_pending", "gauge",
                           "frames parked in the coalescing window",
                           labels, b["pending"])
                    for reason, n in sorted(b["flushes"].items()):
                        yield ("nns_batcher_flushes_total", "counter",
                               "window closes by reason",
                               {**labels, "reason": reason}, n)
                yield from _cache_samples(labels, s.get("cache"))


def _cache_samples(labels: Dict[str, str], cache) -> Iterable[tuple]:
    """Per-bucket executable-cache hit/miss counters of one sub-plugin
    instance (element- or pool-labeled), derived from its
    ``cache_snapshot()`` in the structured tables."""
    if not cache:
        return
    for bucket, hm in sorted(cache.get("by_bucket", {}).items()):
        bl = {**labels, "bucket": bucket}
        yield ("nns_executable_cache_hits_total", "counter",
               "micro-batch executable cache hits", bl, hm["hits"])
        yield ("nns_executable_cache_misses_total", "counter",
               "micro-batch executable cache misses (a window shape "
               "seen for the first time)", bl, hm["misses"])


def _transfer_table() -> List[dict]:
    from .transfer import LEDGER

    return LEDGER.snapshot()


def _transfer_samples(transfers) -> Iterable[tuple]:
    """Flat ``nns_transfer_*`` counters derived from the structured
    transfer table (same single-read rule as
    :func:`_pipeline_samples`); the duration histogram expands
    separately in ``_collect_all``."""
    for row in transfers:
        labels = {"pipeline": row["pipeline"], "source": row["source"],
                  "direction": row["direction"],
                  "reason": row["reason"]}
        yield ("nns_transfer_bytes_total", "counter",
               "bytes crossing the host<->device boundary (exact "
               "payload nbytes)", labels, row["bytes"])
        yield ("nns_transfer_count_total", "counter",
               "host<->device crossings", labels, row["count"])


def _device_table() -> List[dict]:
    from .devicemem import device_memory_table

    return device_memory_table()


def _device_samples(devmem) -> Iterable[tuple]:
    """Flat ``nns_device_memory_bytes`` gauges derived from the
    structured device-memory table (absent kinds — e.g. the CPU
    backend's whole row — are simply not exported)."""
    for row in devmem:
        for kind in ("in_use", "peak", "limit", "reserved"):
            v = row.get(kind)
            if v is not None:
                yield ("nns_device_memory_bytes", "gauge",
                       "device allocator view: in_use/peak allocated "
                       "by tensors, reserved by the caching allocator "
                       "(in use or cached), limit the card's total",
                       {"device": row["device"], "kind": kind}, v)


def _executable_join():
    """The executables table + live utilization samples: static cost
    (obs/xlacost.py) joined at scrape time with the measured
    ``nns_invoke_device_seconds`` histogram — see
    :meth:`XlaCostStats.join`."""
    from .xlacost import XLA_COST

    return XLA_COST.join(_INVOKE_DEVICE._hist_rows())


def _executable_samples(execs) -> Iterable[tuple]:
    """Flat ``nns_executable_*`` gauges derived from the structured
    executables table (same single-read rule as
    :func:`_pipeline_samples`)."""
    for row in execs:
        labels = {"source": row["source"],
                  "bucket": str(row["bucket"]),
                  "placement": row["placement"]}
        yield ("nns_executable_flops", "gauge",
               "FLOPs of one dispatch of the program (FlopCounterMode "
               "matmuls and convolutions + the hand-written kernels' "
               "analytic counts; no elementwise work)", labels,
               row["flops"])
        yield ("nns_executable_bytes", "gauge",
               "bytes of one dispatch: weights + inputs + outputs, "
               "each once (a lower bound on memory traffic)",
               labels, row["bytes"])
        yield ("nns_executable_peak_memory_bytes", "gauge",
               "peak memory of the program (the static I/O footprint: "
               "a lower bound)", labels, row["peak_memory_bytes"])


def _util_samples(exec_util) -> Iterable[tuple]:
    """Live ``nns_mfu`` / ``nns_hbm_bw_util`` gauges: static executable
    cost over the measured device seconds of the scrape window (absent
    on unknown backends — intensity-only fallback, obs/hwspec.py)."""
    for s in exec_util:
        labels = s["labels"]
        if "mfu" in s:
            yield ("nns_mfu", "gauge",
                   "model flops utilization of the measured device "
                   "time (flops x dispatches / device_seconds / peak)",
                   labels, s["mfu"])
        if "hbm_bw_util" in s:
            yield ("nns_hbm_bw_util", "gauge",
                   "HBM bandwidth utilization of the measured device "
                   "time (a lower bound: nns_executable_bytes is one)",
                   labels, s["hbm_bw_util"])


def _stage_table() -> List[dict]:
    from .stagestat import STAGE_STATS

    return STAGE_STATS.snapshot()


def _mesh_table() -> List[dict]:
    from .meshstat import MESH_STATS

    return MESH_STATS.snapshot()


def _mesh_samples(mesh) -> Iterable[tuple]:
    """Flat per-shard attribution samples derived from the structured
    mesh table (same single-read rule as :func:`_pipeline_samples`)."""
    from .meshstat import shard_device_label

    for row in mesh:
        labels = {"source": row["source"]}
        yield ("nns_shard_imbalance", "gauge",
               "per-shard useful-frame imbalance (max/mean - 1; 0.0 "
               "on even splits)", labels, row["imbalance"])
        yield ("nns_mesh_dispatches_total", "counter",
               "dispatches issued over the mesh", labels,
               row["dispatches"])
        yield ("nns_mesh_pad_slots_total", "counter",
               "micro-batch pad slots executed on the mesh (wasted "
               "device time)", labels, row["pad_slots"])
        yield ("nns_mesh_replicated_dispatches_total", "counter",
               "mesh dispatches whose batch could not shard over the "
               "data axis (input replicated onto every device)", labels,
               row["replicated_dispatches"])
        for i, n in enumerate(row["shard_frames"]):
            yield ("nns_mesh_shard_frames_total", "counter",
                   "useful frames attributed to one shard of the mesh",
                   {**labels, "shard": str(i),
                    "device": shard_device_label(row, i)}, n)


def _placement_overlap_samples() -> Iterable[tuple]:
    """``nns_placement_overlap`` gauges: one series per detected pair
    of overlapping explicit ``devices=`` subsets (value = times the
    overlapping resolution happened).  No series means no overlap."""
    from ..parallel.placement import overlap_snapshot

    for row in overlap_snapshot():
        yield ("nns_placement_overlap", "gauge",
               "explicit device subsets sharing devices (per-shard "
               "attribution is unreliable while this fires)",
               {"platform": row["platform"], "a": row["a"],
                "b": row["b"], "shared": row["shared"]}, row["count"])


def _stage_samples(stages) -> Iterable[tuple]:
    """Flat per-stage samples derived from the structured stages table
    (same single-read rule as :func:`_pipeline_samples`): the
    cross-subset handoff counters + inter-stage depth, and the cascade
    offload ratio of routing ``tensor_if`` elements."""
    for row in stages:
        if row["kind"] == "handoff":
            labels = {"pipeline": row["pipeline"], "stage": row["stage"],
                      "from": row["from"], "to": row["to"]}
            yield ("nns_stage_handoff_frames_total", "counter",
                   "frames handed device-to-device into the stage's "
                   "subset (never a host crossing)", labels,
                   row["frames"])
            yield ("nns_stage_handoff_bytes_total", "counter",
                   "exact payload bytes of the cross-subset handoffs",
                   labels, row["bytes"])
            yield ("nns_stage_depth", "gauge",
                   "inter-stage queue depth: frames handed into the "
                   "stage but not yet emitted by it", labels,
                   row["depth"])
        else:
            labels = {"pipeline": row["pipeline"],
                      "element": row["stage"]}
            yield ("nns_cascade_offload_ratio", "gauge",
                   "fraction of judged frames the conditional cascade "
                   "routed to the heavy (offload) stage", labels,
                   row["ratio"])
            yield ("nns_cascade_offloaded_total", "counter",
                   "frames routed down the offload branch", labels,
                   row["offloaded"])
            yield ("nns_cascade_kept_total", "counter",
                   "frames kept on the local (cheap) branch", labels,
                   row["kept"])


def _control_table() -> dict:
    """The closed-loop controller's decision view (obs/control.py):
    playbooks, action totals, recent audit entries — empty-but-present
    when no controller runs, so the snapshot shape is stable."""
    from .control import control_table

    return control_table()


def _forecast_table() -> dict:
    from .forecast import FORECASTS

    return FORECASTS.snapshot()


def _profile_table() -> dict:
    from .prof import profile_table

    return profile_table()


def alert_health(registry: "MetricsRegistry") -> dict:
    """Cheap alert summary for ``/healthz``: the current
    ``nns_alert_state`` gauge children (exported by an attached
    ``obs/watch.py`` watchdog; empty when none runs) — firing count by
    severity plus the firing rule names, WITHOUT a full snapshot
    walk."""
    with registry._lock:
        fam = registry._families.get("nns_alert_state")
    if fam is None:
        return {"firing": 0, "by_severity": {}, "rules": []}
    by_sev: Dict[str, int] = {}
    rules: List[str] = []
    for labels, value in fam.collect():
        if value:
            sev = labels.get("severity", "warning")
            by_sev[sev] = by_sev.get(sev, 0) + 1
            rules.append(labels.get("rule", "?"))
    return {"firing": len(rules), "by_severity": by_sev,
            "rules": sorted(rules)}


def _control_health() -> dict:
    from .control import control_health

    return control_health()


def _prof_health() -> dict:
    from .prof import prof_health

    return prof_health()


def capacity_health() -> dict:
    """Cheap capacity summary for ``/healthz``: the per-pool headroom
    rows an attached watchdog's forecast tick published (empty when
    none runs) — worst headroom plus the pools predicted to overload,
    WITHOUT a full snapshot walk."""
    from .forecast import FORECASTS

    rows = FORECASTS.snapshot()["capacity"]
    if not rows:
        return {"pools": 0, "min_headroom": None, "at_risk": []}
    worst = min(rows, key=lambda r: r["headroom"])
    return {
        "pools": len(rows),
        "min_headroom": round(worst["headroom"], 4),
        "at_risk": sorted(r["pool"] for r in rows
                          if r["headroom"] <= 0.0),
    }


def _tenant_table() -> List[dict]:
    from .tenantstat import TENANT_STATS

    return TENANT_STATS.snapshot()


def _tenant_samples(tenants) -> Iterable[tuple]:
    """Flat per-(pool, tenant) samples derived from the structured
    tenants table (same single-read rule as :func:`_pipeline_samples`):
    the device-second/frame attribution split EXACTLY out of the
    pool's dispatch clock reads, the scrape-time dollars derivation,
    per-tenant SLO attainment and shed counts."""
    for row in tenants:
        labels = {"pool": row["pool"], "tenant": row["tenant"]}
        yield ("nns_tenant_device_seconds_total", "counter",
               "device time attributed to the tenant's frames (sums "
               "EXACTLY to the pool's nns_invoke_device_seconds)",
               labels, row["device_seconds"])
        yield ("nns_tenant_frames_total", "counter",
               "useful frames the tenant parked in pool windows",
               labels, row["frames"])
        yield ("nns_tenant_dollars_total", "counter",
               "attributed device time priced at the chip-hour rate "
               "(NNS_TPU_TORCH_CHIP_HOUR_USD; 0 when unset)",
               labels, row["dollars"])
        if row["slo_attainment"] is not None:
            yield ("nns_tenant_slo_attainment", "gauge",
                   "fraction of the tenant's demuxed frames inside "
                   "the pool SLO (the admission latency signal)",
                   labels, row["slo_attainment"])
        for reason, n in sorted(row["shed"].items()):
            yield ("nns_tenant_shed_total", "counter",
                   "tenant frames shed at admission, by reason",
                   {**labels, "reason": reason}, n)


def _pool_samples(pools) -> Iterable[tuple]:
    """Flat samples derived from the structured pool table (same
    single-read rule as :func:`_pipeline_samples`)."""
    for row in pools:
        labels = {"pool": row["pool"]}
        s = row["stats"]
        yield ("nns_pool_streams", "gauge",
               "streams attached to the pool entry", labels,
               row["streams"])
        yield ("nns_pool_refcount", "gauge",
               "filters holding the pool entry", labels,
               row["refcount"])
        yield ("nns_pool_dispatches_total", "counter",
               "cross-stream dispatches", labels, s["invokes"])
        yield ("nns_pool_frames_total", "counter",
               "frames carried by pool dispatches", labels, s["frames"])
        if s["latency_us"] >= 0:
            yield ("nns_pool_latency_us", "gauge",
                   "rolling mean pool dispatch latency (sampled)",
                   labels, s["latency_us"])
        yield ("nns_pool_batch_occupancy", "gauge",
               "mean frames per pool dispatch", labels,
               s["avg_batch_occupancy"])
        yield ("nns_pool_stream_occupancy", "gauge",
               "mean distinct streams per pool dispatch", labels,
               s["avg_stream_occupancy"])
        w = row.get("weights")
        if w is not None:
            yield ("nns_model_weight_bytes", "gauge",
                   "params footprint of the pooled model",
                   {**labels, "placement": w["placement"]}, w["bytes"])
        m = row.get("mesh")
        if m is not None:
            # pool-side view of the mesh join (the per-shard detail stays
            # on the nns_mesh_* families keyed by model)
            yield ("nns_pool_shards", "gauge",
                   "data-parallel shards the pool window spreads over",
                   labels, m["shards"])
            yield ("nns_pool_shard_imbalance", "gauge",
                   "max/mean-1 of useful frames across the pool's "
                   "shards", labels, m["imbalance"])
            yield ("nns_pool_pad_frac", "gauge",
                   "fraction of the pool's window slots that were "
                   "padding", labels, m["pad_frac"])
        yield from _cache_samples(labels, row.get("cache"))
        b = row.get("batcher")
        if b is not None:
            yield ("nns_pool_pending", "gauge",
                   "frames parked in the cross-stream window", labels,
                   b["pending"])
            for reason, n in sorted(b["flushes"].items()):
                yield ("nns_pool_flushes_total", "counter",
                       "pool window closes by reason",
                       {**labels, "reason": reason}, n)
        lc = row.get("lifecycle")
        if lc is not None:
            yield ("nns_model_swaps_total", "counter",
                   "hot swaps committed on the pool", labels,
                   lc["swaps"])
            yield ("nns_model_promotions_total", "counter",
                   "canaries promoted to serving", labels,
                   lc["promotes"])
            yield ("nns_model_rollbacks_total", "counter",
                   "canary/swap rollbacks", labels, lc["rollbacks"])
            yield ("nns_model_swap_stall_seconds", "gauge",
                   "flip stall of the last hot swap (window-boundary "
                   "hold)", labels, lc["last_swap_stall_s"])
            yield ("nns_model_canary_streams", "gauge",
                   "streams currently routed to the canary version",
                   labels, lc["canary_streams"])
            if lc.get("canary_n", 0) >= 2:
                # the comparator pair: canary latency vs baseline
                # latency of the SAME pool, same labels
                cl = lc.get("canary_latency_us", -1)
                bl = lc.get("baseline_latency_us", -1)
                if cl is not None and cl >= 0:
                    yield ("nns_model_canary_latency_us", "gauge",
                           "rolling mean dispatch latency of the "
                           "canary version", labels, cl)
                if bl is not None and bl >= 0:
                    yield ("nns_model_baseline_latency_us", "gauge",
                           "rolling mean dispatch latency of the "
                           "baseline while a canary runs", labels, bl)
                yield ("nns_model_canary_errors_total", "counter",
                       "failed dispatches on the canary version",
                       labels, lc.get("canary_errors", 0))
                yield ("nns_model_canary_frames_total", "counter",
                       "frames the canary version served", labels,
                       lc.get("canary_frames", 0))
        a = row.get("admission")
        if a is not None:
            yield ("nns_admission_slo_at_risk", "gauge",
                   "1 while the pool's p99 threatens the SLO "
                   "(load-shedding active)", labels,
                   1 if a["at_risk"] else 0)
            yield ("nns_admission_p99_us", "gauge",
                   "admission controller's rolling p99 serve latency",
                   labels, a["p99_ms"] * 1e3)
            for prio, n in sorted(a["submitted"].items()):
                yield ("nns_admission_submitted_total", "counter",
                       "frames offered to the shared window",
                       {**labels, "priority": prio}, n)
            for prio, n in sorted(a["shed"].items()):
                yield ("nns_admission_shed_total", "counter",
                       "frames shed by the admission controller",
                       {**labels, "priority": prio, "reason": "slo"}, n)
            for prio, n in sorted(a["shed_queue_full"].items()):
                yield ("nns_admission_shed_total", "counter",
                       "frames shed by the admission controller",
                       {**labels, "priority": prio,
                        "reason": "queue-full"}, n)


# -- HTTP endpoint -----------------------------------------------------------


class MetricsServer:
    """stdlib-http scrape endpoint: ``/metrics`` (Prometheus text),
    ``/json`` and ``/snapshot`` (the full snapshot), ``/healthz`` (cheap
    liveness probe: status + pipeline/pool/link counts, the device
    in-use bytes and the alert/control/capacity/profiler summaries, no
    full snapshot walk), ``/prof`` (the host profiler's stacks), ``/dump``
    (a flight-recorder dump).  Runs on a daemon thread; ``port=0`` binds an ephemeral port
    readable back from :attr:`port`."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._registry = registry
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API name
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = reg.exposition().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path in ("/json", "/snapshot"):
                    body = json.dumps(reg.snapshot()).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    # fleet probes need liveness + rough shape, not a
                    # full snapshot parse: counts only, no stats locks
                    # beyond the registries' own — plus the device
                    # in-use bytes (an HBM leak is a health problem)
                    from .devicemem import device_memory_summary

                    body = json.dumps({
                        "status": "ok",
                        "host": _host_tag(),
                        "pipelines": len(reg._live_pipelines()),
                        "pools": len(_pool_table()),
                        "links": len(_link_table())
                        if reg._collect_links else 0,
                        "device_memory": device_memory_summary()
                        if reg._collect_devices else [],
                        # alerting view (obs/watch.py): a fleet
                        # controller probing liveness sees WHAT is
                        # firing, not just that the process answers
                        "alerts": alert_health(reg),
                        # actuation view (obs/control.py): playbooks
                        # loaded, decisions taken, the last action —
                        # whether the loop is CLOSED, not only that
                        # alarms ring
                        "control": _control_health(),
                        # predictive view (obs/forecast.py): whether
                        # arrivals are forecast to outrun capacity —
                        # the probe sees trouble BEFORE alerts fire
                        "capacity": capacity_health(),
                        # host-execution view (obs/prof.py): whether
                        # the sampling profiler runs, its tick/sample
                        # counts and the GIL-pressure proxy
                        "prof": _prof_health(),
                        "time": time.time(),
                    }).encode()
                    ctype = "application/json"
                elif path == "/prof":
                    # host profiler export (obs/prof.py): collapsed-
                    # stack text by default (flamegraph.pl input),
                    # ?format=trace for Perfetto/Chrome trace events,
                    # ?last=S to restrict to the recent-sample ring
                    from .prof import PROFILER

                    query = self.path.split("?", 1)[1] \
                        if "?" in self.path else ""
                    qs = dict(kv.split("=", 1)
                              for kv in query.split("&") if "=" in kv)
                    last = None
                    try:
                        if qs.get("last"):
                            last = float(qs["last"])
                    except ValueError:
                        last = None
                    if qs.get("format") == "trace":
                        body = json.dumps(
                            PROFILER.chrome_trace()).encode()
                        ctype = "application/json"
                    else:
                        text = PROFILER.ring_collapsed(last) \
                            if last is not None else PROFILER.collapsed()
                        body = (text + "\n").encode()
                        ctype = "text/plain; charset=utf-8"
                elif path == "/dump":
                    # flight recorder: explicit black-box dump — the
                    # response carries the trace + snapshot, and when
                    # the recorder is armed the same dump also lands
                    # on disk (obs/flightrec.py)
                    from .flightrec import FLIGHT

                    body = json.dumps(
                        FLIGHT.trigger_dump("endpoint")).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet scrapes
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        from . import prof as _prof

        self._thread = _prof.named_thread(
            "metrics", "http", self._httpd.serve_forever)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        # deregister so a later serve() starts a fresh listener instead
        # of handing back this dead one
        reg = self._registry
        with reg._lock:
            if reg._server is self:
                reg._server = None


#: the process-wide registry every Pipeline registers with on start();
#: the only registry that pulls the (equally process-wide) link,
#: transfer, device-memory, executable, mesh, stage and tenant stores
REGISTRY = MetricsRegistry(collect_stages=True, collect_links=True,
                           collect_transfers=True, collect_devices=True,
                           collect_executables=True, collect_mesh=True,
                           collect_tenants=True, collect_prof=True)


# -- dispatch cost attribution (nns_invoke_*) ---------------------------------

#: phase histogram bounds (seconds): 10µs CPU-backend dispatches up to
#: multi-second remote-tunnel round trips
INVOKE_PHASE_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, .001,
                        .0025, .005, .01, .025, .05, .1, .25, .5, 1.0,
                        2.5, float("inf"))

_INVOKE_DEVICE = REGISTRY.histogram(
    "nns_invoke_device_seconds",
    "device phase of one sampled dispatch (issue -> block_until_ready)",
    labelnames=("kind", "source", "bucket"),
    buckets=INVOKE_PHASE_BUCKETS)
_INVOKE_HOST = REGISTRY.histogram(
    "nns_invoke_host_seconds",
    "host phases of one sampled dispatch (phase=prep: input "
    "gather/convert/place; phase=drain: output wrap/demux)",
    labelnames=("kind", "source", "bucket", "phase"),
    buckets=INVOKE_PHASE_BUCKETS)


def observe_invoke_phases(kind: str, source: str, bucket: int,
                          prep_s: float, device_s: float,
                          drain_s: float) -> None:
    """Feed one sampled dispatch's host/device split into the global
    registry.  ``kind`` is ``element`` (single-filter chain or
    micro-batch window) or ``pool`` (SharedBatcher cross-stream
    dispatch); ``source`` the element name / pool label; ``bucket`` the
    padded batch size (1 for the single-frame chain).  Called only on
    stat-sampled dispatches — the phases need the ``block_until_ready``
    fence, which unsampled async dispatches deliberately skip."""
    labels = {"kind": kind, "source": str(source), "bucket": str(bucket)}
    _INVOKE_DEVICE.labels(**labels).observe(device_s)
    _INVOKE_HOST.labels(**labels, phase="prep").observe(prep_s)
    _INVOKE_HOST.labels(**labels, phase="drain").observe(drain_s)


#: serve-latency histogram bounds (seconds): resolution concentrated in
#: the 1-250 ms band where serving SLOs live, so a p99 derived from the
#: bucket boundaries lands within ~25% of the true value there
ADMISSION_LATENCY_BUCKETS = (.001, .0025, .005, .0075, .01, .015, .02,
                             .03, .05, .075, .1, .15, .25, .5, 1.0,
                             2.5, float("inf"))

_ADMISSION_LATENCY = REGISTRY.histogram(
    "nns_admission_latency_seconds",
    "pool serve latency (window park -> results demuxed) — the SAME "
    "signal the admission controller's shed decision reads",
    labelnames=("pool",),
    buckets=ADMISSION_LATENCY_BUCKETS)


def admission_latency_hist(pool: str):
    """The per-pool serve-latency histogram child the admission
    controller both feeds and READS its p99 from — so an external
    controller scraping the registry sees exactly the signal the
    in-process shedder acts on."""
    return _ADMISSION_LATENCY.labels(pool=str(pool))


def serve_metrics(port: int = 0, host: str = "127.0.0.1") -> MetricsServer:
    """Serve the global registry over HTTP (idempotent; returns the
    running server)."""
    return REGISTRY.serve(port=port, host=host)


_env_checked = False


def maybe_serve_from_env(registry: MetricsRegistry) -> None:
    """``NNS_TPU_TORCH_METRICS_PORT=<port>`` serves the registry when the
    first pipeline starts, so any running process can be scraped
    without touching its code."""
    global _env_checked
    if _env_checked:
        return
    _env_checked = True
    port = os.environ.get(PORT_ENV, "")
    if not port:
        return
    try:
        registry.serve(port=int(port))
    except (OSError, ValueError) as e:
        from ..utils.log import logw

        logw("cannot serve metrics on %s=%s: %s", PORT_ENV, port, e)
