"""The program's own spans over a second traced stretch → the card's
kernel time by the layer that launched it.

The program names where its work happens with ``nns:<kind>:<name>``
spans (``nnstreamer_tpu_torch/utils/profile.py``), recorded on every
thread by its own session, ``pipeline_trace``.  After a ``--trace 1``
run has checked its results, :func:`of` sets the cell's pipeline up once
more, lets ``warmup_windows`` windows complete, opens ``pipeline_trace``,
lets two more complete, then spans ``profile_windows`` windows with a
``portbench.spans`` annotation; it reads the written trace back, deletes
it and keeps :func:`reduce`'s summary on the run (``run.spans``), where
the per-layer readers find it.

:func:`reduce`: every kernel overlapping the stretch, clipped to it as
``metrics/device_ms_per_window.py`` counts, joins its runtime launch by
``correlation``, and the launch the innermost span open on its thread
that is not a container (``nns:chain``, ``nns:invoke``, ``nns:frames``
hold others).  A kernel whose launch the trace lacks, or whose launch
lies in no such span, is unspanned.  The stretch's longest idle gaps are
named by the innermost ``nns:`` span open at their start on any thread
and the runtime call covering it, on that span's thread where one does.

A program without the spans (one whose ``utils/profile.py`` has no
``span``) is not set up again: every reader of the summary returns None.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from portbench.trace import DEVICE_CATS, _union, short_name

STRETCH = "portbench.spans"
PREFIX = "nns:"
CONTAINERS = ("nns:chain:", "nns:invoke:", "nns:frames:")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: windows that complete inside the session before the stretch opens
SETTLE_WINDOWS = 2
#: idle gaps printed
GAPS = 5
#: kernels printed a span
KERNELS = 4


@dataclasses.dataclass
class SpanSummary:
    """The stretch's kernel time in µs: ``by_span`` by innermost leaf
    span, ``unspanned`` the rest, ``kernel_us`` all; ``windows`` windows
    completed in it, ``seconds`` long; ``spanned`` whether the trace held
    any ``nns:`` span; ``gaps``: (start µs from the stretch's start,
    length µs, what the host was doing) of the longest idle gaps;
    ``by_kernel``: µs by (leaf span or ``unspanned``, kernel name)."""
    windows: int
    seconds: float
    kernel_us: float
    by_span: Dict[str, float]
    unspanned_us: float
    spanned: bool
    gaps: List[Tuple[float, float, str]]
    by_kernel: Dict[Tuple[str, str], float]

    def ms_per_window(self, names) -> Optional[float]:
        """Kernel ms a window under the leaf spans ``names``; None when
        the trace held no span or no kernel."""
        if not self.spanned or self.kernel_us <= 0 or not self.windows:
            return None
        return sum(self.by_span.get(n, 0.0) for n in names) / 1e3 \
            / self.windows

    def unspanned_pct(self) -> Optional[float]:
        if not self.spanned or self.kernel_us <= 0:
            return None
        return 100.0 * self.unspanned_us / self.kernel_us


class _Innermost:
    """The spans of one thread, which nest: the innermost one open at a
    time."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float) -> Optional[Tuple[float, str]]:
        """(start, name) of the innermost span open at ``t``: of the open
        ones, the one that started last."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            a, b, name = self.spans[i]
            if b >= t:
                return a, name
            i -= 1
        return None


def _tid(e) -> Tuple:
    return (e.get("pid"), e.get("tid"))


def reduce(trace: Dict, windows: int) -> Optional[SpanSummary]:
    """The summary of a Chrome trace of the stretch; None when it holds
    no ``portbench.spans`` annotation."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    marks = [e for e in evs if e.get("name") == STRETCH
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    leaf: Dict[Tuple, List] = {}
    every: Dict[Tuple, List] = {}
    launches: Dict[int, Tuple[float, Tuple]] = {}
    runtime: List[Tuple[float, float, str, Tuple]] = []
    device: List[Tuple[float, float]] = []
    kernels = []
    for e in evs:
        cat, name = e.get("cat"), e.get("name", "")
        ts = float(e["ts"])
        end = ts + float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            every.setdefault(_tid(e), []).append((ts, end, name))
            if not name.startswith(CONTAINERS):
                leaf.setdefault(_tid(e), []).append((ts, end, name))
        elif cat in LAUNCH_CATS:
            runtime.append((ts, end, name, _tid(e)))
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[int(corr)] = (ts, _tid(e))
        elif cat in DEVICE_CATS:
            a, b = max(ts, t0), min(end, t1)
            if b > a:
                device.append((a, b))
                if cat == "kernel":
                    kernels.append((b - a, (e.get("args") or {})
                                    .get("correlation"), name))
    leaf_at = {k: _Innermost(v) for k, v in leaf.items()}
    by_span: Dict[str, float] = {}
    by_kernel: Dict[Tuple[str, str], float] = {}
    unspanned = 0.0
    for dur, corr, kernel in kernels:
        launch = launches.get(int(corr)) if corr is not None else None
        inner = None
        if launch is not None and launch[1] in leaf_at:
            inner = leaf_at[launch[1]].at(launch[0])
        if inner is None:
            unspanned += dur
            span = "unspanned"
        else:
            span = inner[1]
            by_span[span] = by_span.get(span, 0.0) + dur
        key = (span, short_name(kernel))
        by_kernel[key] = by_kernel.get(key, 0.0) + dur
    return SpanSummary(
        windows=windows, seconds=(t1 - t0) / 1e6,
        kernel_us=sum(k[0] for k in kernels), by_span=by_span,
        unspanned_us=unspanned, spanned=bool(every),
        gaps=_named_gaps(t0, t1, device, every, runtime),
        by_kernel=by_kernel)


def _named_gaps(t0, t1, device, spans, runtime):
    edges = [(t0, t0)] + _union(device) + [(t1, t1)]
    gaps = sorted(((a, b - a) for (_, a), (b, _) in zip(edges, edges[1:])
                   if b > a), key=lambda g: -g[1])[:GAPS]
    inner = {tid: _Innermost(v) for tid, v in spans.items()}
    out = []
    for a, length in gaps:
        # of each thread's innermost span, the one that opened last; the
        # runtime call covering the start on its thread, else on any
        open_ = [(s[0], s[1], tid) for tid, s in
                 ((tid, i.at(a)) for tid, i in inner.items()) if s is not None]
        first = max(open_) if open_ else (0.0, "no span", None)
        calls = sorted((tid != first[2], -s, n)
                       for s, e, n, tid in runtime if s <= a <= e)
        call = calls[0][2] if calls else "no runtime call"
        out.append((a - t0, length, f"{first[1]} / {call}"))
    return out


# -- the second stretch ---------------------------------------------------------


def _seed() -> int:
    """The run's ``--seed`` (0 outside ``run.py``)."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def _program_spans() -> bool:
    from nnstreamer_tpu_torch.utils import profile

    return hasattr(profile, "span")


def of(run, device: str = "cuda", log=None) -> Optional[SpanSummary]:
    """The span summary of ``run`` (``harness.Run``), measured on first
    use and kept as ``run.spans``; None where the program has no spans
    or the stretch could not be measured (said on standard error).
    ``device`` is the run's, as ``harness.run_cell`` takes it: anything
    but ``cuda`` is for the benchmark's own tests."""
    if "spans" in vars(run):
        return run.spans
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    run.spans = None
    if not _program_spans():
        log("spans: the program has no nns: spans; no second stretch")
        return None
    t = time.perf_counter()
    try:
        run.spans = measure(run, device, log)
    except Exception as e:  # noqa: BLE001 - the metrics are left out
        log(f"spans: the second stretch failed: {type(e).__name__}: {e}")
        return None
    report(run, run.spans, time.perf_counter() - t, log)
    return run.spans


def measure(run, device: str, log) -> Optional[SpanSummary]:
    """Set the cell up again and trace a stretch of it with the
    program's ``pipeline_trace`` (module docstring)."""
    import gc

    import torch
    from torch.profiler import record_function

    from nnstreamer_tpu_torch.filters.torch_cuda import unregister_model
    from nnstreamer_tpu_torch.runtime import parse_launch
    from nnstreamer_tpu_torch.utils.profile import TRACE_FILE, pipeline_trace

    from portbench import harness
    from portbench import traffic as gen

    dev = harness.device_of(run.cell.chips, device)
    cfg, traffic, seed = run.cfg, run.traffic, _seed()
    model = harness.arch(cfg, "models")
    source = harness.plugin("sources", traffic["source"])
    name = harness.MODEL_NAME + "_spans"
    model.register(name, harness.arch(cfg, "reference").make_tree(
        cfg, seed, dev), cfg, run.batch)
    frames = gen.frame_pool(cfg, traffic, seed, dev)
    norm = cfg["normalize"]
    p = parse_launch(source.head(traffic) + " ! " + model.pipeline(
        cfg, name, f"typecast:float32,add:{-norm['sub']},"
        f"div:{norm['div']}"), device=str(dev))
    stop_source = source.attach(p, frames, traffic)
    warmup = int(traffic["warmup_windows"])
    windows = int(traffic["profile_windows"])
    stream = harness.Stream(p, run.batch, len(frames), warmup, 0.0, 0, seed,
                            model.outputs, False)
    out = tempfile.mkdtemp(prefix="portbench-spans-")
    try:
        stream.start()
        p.start()
        stream.wait(lambda: len(stream.done) >= warmup, 600.0)
        with pipeline_trace(out):
            n0 = len(stream.done) + SETTLE_WINDOWS
            stream.wait(lambda: len(stream.done) >= n0, 300.0)
            with record_function(STRETCH):
                stream.wait(lambda: len(stream.done) >= n0 + windows, 300.0)
        with open(os.path.join(out, TRACE_FILE)) as f:
            trace = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
        if stop_source is not None:
            stop_source()
        stream.stop()
        del p, stream
        unregister_model(name)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
    return reduce(trace, windows)


def report(run, s: Optional[SpanSummary], seconds: float, log) -> None:
    """The stretch's split on standard error: kernel time by leaf span,
    the sum against the stretch's kernel time, the idle gaps, and what
    the session cost."""
    log(f"spans: second stretch set up, traced and read in {seconds:.3f} s")
    if s is None:
        log("spans: the trace held no portbench.spans annotation")
        return
    frames_s = s.windows * run.batch / s.seconds if s.seconds > 0 else 0.0
    timed = run.window.frames / run.window.seconds \
        if run.window.seconds > 0 else 0.0
    log(f"spans: {s.windows} windows in {s.seconds:.6f} s under the session: "
        f"{frames_s:.3f} frames/s (timed window {timed:.3f} frames/s)")
    if not s.spanned:
        log("spans: the trace held no nns: span")
        return
    leaf = sum(s.by_span.values())
    log(f"spans: kernel time {s.kernel_us / 1e3:.3f} ms = leaf spans "
        f"{leaf / 1e3:.3f} ms + unspanned {s.unspanned_us / 1e3:.3f} ms")
    per = 1e3 * max(s.windows, 1)
    for name, us in sorted(s.by_span.items(), key=lambda kv: -kv[1]):
        top = sorted(((k, v) for (sp, k), v in s.by_kernel.items()
                      if sp == name), key=lambda kv: -kv[1])[:KERNELS]
        log(f"spans: {name}: {us / per:.3f} ms a window; " + "; ".join(
            f"{k[:72]} {v / per:.3f}" for k, v in top))
    for at, length, what in s.gaps:
        log(f"spans: idle gap {length / 1e3:.6f} ms at {at / 1e6:.6f} s: "
            f"{what}")
