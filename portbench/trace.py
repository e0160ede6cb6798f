"""A profiled stretch of windows → what the per-layer readers read.

``torch.profiler`` (CPU and CUDA activity) runs over a stretch that
starts and ends at a window's completion at the sink; a user annotation
``portbench.stretch`` spans it, so its bounds are in the trace's own
clock.  The Chrome trace the profiler writes is read back: the device's
kernels, copies and sets, and the host's operations, each clipped to the
stretch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STRETCH = "portbench.stretch"


@dataclasses.dataclass
class DeviceEvent:
    """A device operation clipped to the stretch; ``whole`` when it lies
    inside it from start to end."""
    name: str
    cat: str
    start_us: float
    dur_us: float
    bytes: Optional[float]
    whole: bool


@dataclasses.dataclass
class TraceSummary:
    """The stretch's device activity; ``windows`` windows completed in
    it, ``window_s`` long."""
    windows: int
    window_s: float
    events: List[DeviceEvent]
    busy_s: float
    gaps: List[Tuple[float, float]]          # (start us, length us)
    host: List[Dict]                         # host events of the trace

    def kernels(self, names=("",)) -> List[DeviceEvent]:
        """Kernels wholly inside the stretch whose name contains any of
        ``names``."""
        return [e for e in self.events if e.cat == "kernel" and e.whole
                and any(n in e.name for n in names)]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(trace: Dict, windows: int) -> Optional[TraceSummary]:
    """The summary of an exported Chrome trace; None when it holds no
    stretch annotation or no device activity."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    marks = [e for e in evs if e.get("name") == STRETCH]
    if not marks:
        return None
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    dev: List[DeviceEvent] = []
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(ts, t0), min(end, t1)
        if b <= a:
            continue
        nbytes = (e.get("args") or {}).get("bytes")
        dev.append(DeviceEvent(e["name"], e["cat"], a, b - a,
                               None if nbytes is None else float(nbytes),
                               whole=ts >= t0 and end <= t1))
    if not dev:
        return None
    busy = _union([(e.start_us, e.start_us + e.dur_us) for e in dev])
    host = [e for e in evs if e.get("cat") in HOST_CATS
            and e.get("name") != STRETCH]
    edges = [(t0, t0)] + busy + [(t1, t1)]
    gaps = sorted(((a, b - a) for (_, a), (b, _) in zip(edges, edges[1:])
                   if b > a), key=lambda g: -g[1])
    return TraceSummary(
        windows=windows, window_s=(t1 - t0) / 1e6, events=dev,
        busy_s=sum(b - a for a, b in busy) / 1e6, gaps=gaps, host=host)


def _host_at(host, t: float) -> str:
    """What the host was doing at ``t``: the benchmark's own span there
    (``portbench.*``) and the innermost operation, or ``idle``."""
    covering = [e for e in host
                if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
    if not covering:
        return "idle"
    inner = max(covering, key=lambda e: float(e["ts"]))["name"]
    spans = [e["name"] for e in covering
             if e["name"].startswith("portbench.")]
    return inner if not spans or spans[-1] == inner \
        else f"{spans[-1]} / {inner}"


def read_profile(prof, windows: int) -> Optional[TraceSummary]:
    """Export ``prof``'s trace to a temporary file, summarize it, and
    remove the file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return summarize(trace, windows)


#: noise stripped from the profiler's demangled kernel names
_NOISE = re.compile(r"void |at::native::|\(anonymous namespace\)::|"
                    r"c10::|, std::array<char\*, \d+ul>|std::array<char\*, "
                    r"\d+ul>")


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without namespaces and launch boilerplate."""
    return _NOISE.sub("", name)[:limit]


def breakdown(summary: TraceSummary, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, in seconds."""
    by_name: Dict[str, float] = {}
    for e in summary.events:
        n = short_name(e.name)
        by_name[n] = by_name.get(n, 0.0) + e.dur_us / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_host_at(summary.host, a), d / 1e6]
                          for a, d in summary.gaps[:top]]}
