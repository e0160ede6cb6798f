"""The benchmark's driver: resolve a cell by name, set up the program, run
the timed window, profile a stretch, check the results, print one line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``;
its configuration's file (``configs/<config>.json``), whose ``arch``
names the program adapter (``models/<arch>.py``), the plain reference
(``reference/<arch>.py``) and the cost counts (``cost/<arch>.py``); its
traffic file (``traffic/<traffic>.json``), whose ``source`` names the
module that feeds the pipeline (``sources/<source>.py``); and one reader
a metric (``metrics/<metric>.py``).  Nothing here names a cell, a
configuration, a traffic mix, a source or a metric.

A run: set-up (imports, kernels, weights and frames from the seed, the
pipeline built and started, ``warmup_windows`` windows) ends when the
last warm-up window completes; the timed window is the next ``--seconds``
of the running stream; with ``--trace 1`` a profiled stretch of
``profile_windows`` windows follows it.  Then the stream stops, the card's
peak memory is read, the program is freed, and the sampled results are
held against the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import random
import statistics
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "portbench"
#: the program's kernel cache: a fixed directory inside the checkout
KERNEL_CACHE = BENCH / ".cache" / "kernels"
TRITON_CACHE = BENCH / ".cache" / "triton"
#: the cards' data-sheet peaks, by ``torch.cuda.get_device_name()``
PEAKS = BENCH / "peaks.json"
#: top-level modules a run must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "nnstreamer_tpu")
MODEL_NAME = "portbench_model"


def use_checkout_caches() -> None:
    """Point the program's kernel cache (and any Triton cache) at fixed
    directories inside the checkout, so only a checkout's first run
    builds."""
    KERNEL_CACHE.mkdir(parents=True, exist_ok=True)
    TRITON_CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["NNS_TPU_TORCH_COMPILE_CACHE_DIR"] = str(KERNEL_CACHE)
    os.environ["TRITON_CACHE_DIR"] = str(TRITON_CACHE)
    os.environ.setdefault("USE_FLAX", "0")


class SetupError(RuntimeError):
    """The run cannot be made here (no card, an unknown cell)."""


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


# -- resolving a cell ------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str, reported=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def resolve(spec: Dict[str, Any], name: str, root: Path = REPO,
            traffic_dir: Path = BENCH / "traffic") -> Cell:
    """The cell ``name`` of a benchmark description ``spec``; its
    configuration's file is found under ``root``, its traffic file in
    ``traffic_dir``."""
    cells = [w for w in spec["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise SetupError(f"no cell {name!r} in the benchmark")
    w = cells[0]
    conf = [c for c in spec["configs"] if c["name"] == w["config"]]
    if len(conf) != 1:
        raise SetupError(f"cell {name!r}: no configuration {w['config']!r}")
    cfg = load_json(root / conf[0]["file"])
    traffic = load_json(traffic_dir / f"{w['traffic']}.json")
    if not (BENCH / "sources" / f"{traffic['source']}.py").is_file():
        raise SetupError(f"traffic {w['traffic']!r}: no source "
                         f"{traffic['source']!r}")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), cfg, traffic, e2e, per_layer)


def arch(cfg, kind: str):
    """``portbench.<kind>.<arch>``: kind is ``models``, ``reference`` or
    ``cost``."""
    return importlib.import_module(f"portbench.{kind}.{cfg['arch']}")


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark's folder, loaded
    from its file (``kind`` is ``metrics`` or ``sources``)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name}", path)
    if spec is None or not path.is_file():
        raise SetupError(f"no {kind} module {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable:
    """``read(run)`` of ``metrics/<metric>.py``."""
    return plugin("metrics", metric).read


# -- the stream -------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    """The timed window: ``windows`` results completed at the sink in
    ``seconds``, and the ``frames`` done in it, the window under way at
    its close counted by the share of its time that fell inside (so a
    window that ends between two completions counts all its work and
    all its time); each completed one's (creation, completion) on the
    host clock, and its time from the one to the other."""
    seconds: float
    windows: int
    frames: float
    completions: List[tuple]
    latencies_s: List[float]


def frames_done(t_a: float, t_b: float, ends: List[float],
                batch: int) -> float:
    """Frames done in (t_a, t_b]: ``batch`` for each completion in it,
    and of the window under way at ``t_b`` the share of the time from
    the completion before ``t_b`` (or ``t_a``) to the one after it."""
    inside = [t for t in ends if t_a < t <= t_b]
    last = inside[-1] if inside else t_a
    after = [t for t in ends if t > t_b]
    part = (t_b - last) / (after[0] - last) if after else 0.0
    return batch * (len(inside) + part)


class Stream:
    """Times every window of a running pipeline from its creation at the
    source to its result's completion at the sink, and keeps the results
    of ``check`` of the timed window's windows, drawn from the seed.

    A consumer thread pulls each result from the sink, waits for the CUDA
    event the sink recorded behind its work, and stamps the time.  The
    first ``warmup`` completions are set-up; the timed window starts at
    the last of them."""

    def __init__(self, p, batch: int, pool: int, warmup: int, seconds: float,
                 check: int, seed: int, outputs: Callable, trace: bool):
        from portbench.reference.common import sub_seed

        self.p, self.batch, self.pool = p, batch, pool
        self.warmup, self.seconds, self.check = warmup, seconds, check
        self.outputs = outputs
        self.rng = random.Random(sub_seed(seed, "check"))
        self.done: List[tuple] = []          # (seq, created, completed)
        self.samples: List[Dict[str, Any]] = []
        self.t_a: Optional[float] = None
        self.t_b: Optional[float] = None
        self.index = 0
        self.error: Optional[BaseException] = None
        self.cv = threading.Condition()
        self._stop = threading.Event()
        self._seq = 0
        self._trace = trace
        src = p["src"]
        create = src.create
        stamp = self._stamp

        def created():
            buf = create()
            if buf is not None:
                stamp(buf)
            return buf

        src.create = self._span("portbench.source.create", created)
        if trace:
            sink = p["out"]
            sink._fence = self._span("portbench.sink.fence", sink._fence)
        self._thread = threading.Thread(target=self._consume,
                                        name="portbench-consumer",
                                        daemon=True)

    def _span(self, name: str, fn: Callable) -> Callable:
        """``fn`` inside a profiler annotation (``--trace 1`` only)."""
        if not self._trace:
            return fn
        from torch.profiler import record_function

        def spanned(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)

        return spanned

    def _stamp(self, buf) -> None:
        buf.meta["portbench_seq"] = self._seq
        buf.meta["portbench_created"] = time.perf_counter()
        self._seq += 1

    def start(self) -> None:
        self._thread.start()

    def _consume(self) -> None:
        sink = self.p["out"]
        try:
            while not self._stop.is_set():
                buf = sink.pull(timeout=0.05)
                if buf is not None:
                    self._record(buf)
        except Exception as e:  # noqa: BLE001 - reported by the run
            with self.cv:
                self.error = e
                self.cv.notify_all()

    def _record(self, buf) -> None:
        ev = buf.meta.get("device_done")
        if ev is not None:
            # with the interpreter lock released
            ev.synchronize()
        t = time.perf_counter()
        seq = buf.meta["portbench_seq"]
        with self.cv:
            self.done.append((seq, buf.meta["portbench_created"], t))
            if self.t_a is None and len(self.done) == self.warmup:
                self.t_a = t
                self.t_b = t + self.seconds
            elif self.t_a is not None and self.t_a < t <= self.t_b:
                # a reservoir: ``check`` windows drawn evenly from all
                # the window's, by the seed
                i, k = self.index, self.check
                j = i if i < k else self.rng.randrange(i + 1)
                if j < k:
                    smp = self.outputs(buf)
                    smp["slot"] = seq % self.pool
                    if j < len(self.samples):
                        self.samples[j] = smp
                    else:
                        self.samples.append(smp)
                self.index += 1
            self.cv.notify_all()

    def wait(self, cond: Callable[[], bool], timeout: float) -> None:
        deadline = time.monotonic() + timeout
        with self.cv:
            while not cond():
                if self.error is not None:
                    raise RuntimeError("result consumer failed") \
                        from self.error
                if self.p.error is not None:
                    raise RuntimeError(f"pipeline error: {self.p.error}")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("the stream stopped producing")
                self.cv.wait(min(left, 0.5))

    def run_window(self, setup_timeout: float) -> Window:
        """Wait out set-up, then the timed window; its record."""
        self.wait(lambda: self.t_a is not None, setup_timeout)
        time.sleep(max(self.t_b - time.perf_counter(), 0.0))
        # every completion at or before t_b is recorded once a later one
        # is (the consumer records them in order)
        self.wait(lambda: self.done[-1][2] > self.t_b, 120.0)
        with self.cv:
            inside = [d for d in self.done if self.t_a < d[2] <= self.t_b]
            ends = [d[2] for d in self.done]
        return Window(seconds=self.t_b - self.t_a, windows=len(inside),
                      frames=frames_done(self.t_a, self.t_b, ends,
                                         self.batch),
                      completions=[(a, c) for _, a, c in inside],
                      latencies_s=[c - a for _, a, c in inside])

    def profile(self, windows: int):
        """Profile a stretch of ``windows`` windows, from one completion
        at the sink to the ``windows``-th after it."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            n0 = len(self.done) + 1
            self.wait(lambda: len(self.done) >= n0, 120.0)
            with record_function(trace.STRETCH):
                self.wait(lambda: len(self.done) >= n0 + windows, 300.0)
        return trace.read_profile(prof, windows)

    def stop(self) -> None:
        """Stop the pipeline while the consumer still drains the sink,
        then the consumer."""
        try:
            self.p.stop()
        finally:
            self._stop.set()
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                raise RuntimeError("result consumer did not stop")


# -- a run --------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What the readers read (``metrics/*.py``)."""
    cell: Cell
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    batch: int
    cost: Any
    peaks: Optional[Dict[str, float]]
    setup_s: float
    window: Window
    trace: Any = None


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def device_of(chips: int, device: str):
    """The run's device.  ``cuda`` needs a card and ``chips`` of them;
    anything else is for the harness's own tests."""
    import torch

    if device != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise SetupError("no CUDA card: the benchmark measures the card and "
                         "has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise SetupError(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             setup_timeout: float = 1100.0, log=None) -> Dict[str, Any]:
    """One run of ``cell``; returns the result line's object."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))

    def phase(what: str) -> None:
        log(f"set-up: {what} at {time.perf_counter() - t_start:.3f} s")

    dev = device_of(cell.chips, device)
    import torch

    from portbench import traffic as gen
    from portbench.reference.common import no_tf32

    cfg, traffic = cell.cfg, cell.traffic
    batch = int(traffic["batch"])
    model, ref, cost = arch(cfg, "models"), arch(cfg, "reference"), \
        arch(cfg, "cost")
    source = plugin("sources", traffic["source"])

    from nnstreamer_tpu_torch.filters.torch_cuda import unregister_model
    from nnstreamer_tpu_torch.runtime import parse_launch

    phase("program imported")
    if dev.type == "cuda":
        from nnstreamer_tpu_torch.ops import build

        build.build_all(list(model.KERNELS))
        phase(f"kernels loaded ({build.nvcc_runs} nvcc runs)")
    tree = ref.make_tree(cfg, seed, dev)
    model.register(MODEL_NAME, tree, cfg, batch)
    del tree
    host = gen.frame_pool(cfg, traffic, seed, dev)
    phase("weights and frames made")
    norm = cfg["normalize"]
    desc = source.head(traffic) + " ! " + model.pipeline(
        cfg, MODEL_NAME, f"typecast:float32,add:{-norm['sub']},"
        f"div:{norm['div']}")
    p = parse_launch(desc, device=str(dev))
    stop_source = source.attach(p, host, traffic)
    stream = Stream(p, batch, len(host), int(traffic["warmup_windows"]),
                    seconds, int(traffic["check_windows"]), seed,
                    model.outputs, trace)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stream.start()
    p.start()
    phase("pipeline started")
    summary = None
    try:
        window = stream.run_window(setup_timeout)
        setup_s = stream.t_a - t_start
        if trace:
            summary = stream.profile(int(traffic["profile_windows"]))
    finally:
        if stop_source is not None:
            stop_source()
        stream.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lat = sorted(window.latencies_s)
    if len(lat) >= 2:
        p95 = statistics.quantiles(lat, n=100, method="inclusive")[94]
        log(f"latency: median {statistics.median(lat) * 1e3:.3f} ms, "
            f"p95 {p95 * 1e3:.3f} ms, largest {lat[-1] * 1e3:.3f} ms, "
            f"over {len(lat)} windows of the timed window")
        ends = [stream.t_a] + [c for _, c in window.completions]
        gaps = sorted(((b - a, a - stream.t_a)
                       for a, b in zip(ends, ends[1:])), reverse=True)[:3]
        log("longest waits between completions: " + ", ".join(
            f"{g * 1e3:.3f} ms at {at:.3f} s" for g, at in gaps))
    samples = stream.samples
    del p, stream
    unregister_model(MODEL_NAME)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    no_tf32()
    t_check = time.perf_counter()
    ref_tree = ref.make_tree(cfg, seed, dev)
    numbers = ref.judge(ref_tree, cfg, samples,
                        lambda slot: torch.from_numpy(host[slot]), dev)
    log(f"check: {len(samples)} windows against the reference in "
        f"{time.perf_counter() - t_check:.3f} s: {numbers}")
    limits = cfg["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = bool(samples) and all(
        numbers[k] <= lim for k, lim in limits.items())

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = load_json(PEAKS)["devices"].get(kind)
    run = Run(cell, cfg, traffic, batch, cost, peaks, setup_s, window,
              summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    if trace and summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
    result: Dict[str, Any] = {"correct": correct,
                              "attempted": window.windows * batch,
                              "failed": 0,
                              "metrics": metrics, "device": device_info}
    if trace and summary is not None:
        from portbench.trace import breakdown

        result["breakdown"] = breakdown(summary)
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return result
