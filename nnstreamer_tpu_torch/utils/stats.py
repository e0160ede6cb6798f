"""Per-filter and per-pool invoke statistics.

Counterpart of the JAX package's ``utils/stats.py`` ``InvokeStats`` (parity
target: the reference's tensor_filter.c:366-468 — a rolling window of
recent invoke latencies, overflow-safe accumulators, throughput as
1000×FPS, and the thresholded LATENCY bus report).  The metrics registry
pulls :meth:`InvokeStats.snapshot` at scrape time (``obs/metrics.py``).
The JAX package's process-wide XLA compile counters have no counterpart:
the port compiles no programs.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, Optional, Tuple

from ..obs import hooks as _hooks
from .device import block_all

STAT_MAX_RECENT = 10
LATENCY_REPORT_HEADROOM = 1.05   # 5% headroom on reported latency
LATENCY_REPORT_THRESHOLD = 0.25  # re-report when moving beyond ±25%
#: at most one blocking stats sample per this many seconds, by default
#: (``tensor_filter stat-sample-interval-ms`` overrides it)
STAT_SAMPLE_INTERVAL = 1.0


class InvokeStats:
    """Thread-safe rolling invoke statistics.

    With micro-batching (``runtime/batching.py``) one *invoke* (device
    dispatch) can carry several *frames*; ``record``/``count`` take the
    per-invoke frame count so the stats report both frames/s
    (:attr:`throughput_milli_fps`) and dispatches/s
    (:attr:`dispatch_milli_fps`), plus the realized batch occupancy.
    Unbatched callers (frames=1) see the exact pre-batching numbers.

    With the shared-model serving pool (``runtime/serving.py``) one
    dispatch can additionally carry frames from several *pipelines*:
    ``streams`` is the number of distinct streams contributing to the
    dispatch, accumulated into :attr:`avg_stream_occupancy` (the
    cross-stream coalescing measure), and :attr:`attached_streams` is a
    gauge of how many streams are currently attached to the pool entry.
    """

    def __init__(self, window: int = STAT_MAX_RECENT):
        self._lock = threading.Lock()
        self._recent = collections.deque(maxlen=window)
        self.total_invoke_num = 0   # dispatches
        self.total_frame_num = 0    # frames carried by those dispatches
        self.total_stream_num = 0   # distinct streams, summed per dispatch
        self.attached_streams = 0   # gauge: streams on the pool entry
        self.total_invoke_latency_us = 0  # accumulated, overflow-free (py int)
        self._first_ts: Optional[float] = None
        self._first_frames = 0  # frames carried by the first dispatch
        self._last_ts: Optional[float] = None
        # dispatch cost attribution (sampled dispatches only): rolling
        # window of (host-prep, device, host-drain) seconds plus
        # cumulative totals — the boundaries are device synchronizations,
        # so prep + device equals the recorded invoke latency
        # and prep + device + drain partitions the whole dispatch
        self._phase_recent = collections.deque(maxlen=window)
        self.phase_samples = 0
        self.total_host_prep_s = 0.0
        self.total_device_s = 0.0
        self.total_host_drain_s = 0.0
        self._last_reported_us: Optional[float] = None

    def _tick(self, frames: int, streams: int) -> None:
        """Bump invoke count + first/last timestamps (callers hold _lock)."""
        now = time.monotonic()
        self.total_invoke_num += 1
        self.total_frame_num += max(int(frames), 1)
        self.total_stream_num += max(int(streams), 1)
        if self._first_ts is None:
            self._first_ts = now
            self._first_frames = max(int(frames), 1)
        self._last_ts = now

    def record(self, latency_s: float, frames: int = 1,
               streams: int = 1) -> None:
        us = latency_s * 1e6
        with self._lock:
            self._recent.append(us)
            self.total_invoke_latency_us += int(us)
            self._tick(frames, streams)

    def count(self, frames: int = 1, streams: int = 1) -> None:
        """Count an invoke without a latency sample (async dispatch whose
        execution time is unknown) so throughput stays accurate while
        latency reflects only sampled, device-synchronized invokes."""
        with self._lock:
            self._tick(frames, streams)

    def record_phases(self, prep_s: float, device_s: float,
                      drain_s: float) -> None:
        """Record one sampled dispatch's host/device phase split:
        host-prep (input gather/convert/place), device (dispatch →
        device synchronize) and host-drain (output wrap/demux).
        Phases come from consecutive clock reads around one dispatch,
        so their sum IS the dispatch's wall time by construction."""
        with self._lock:
            self._phase_recent.append((prep_s, device_s, drain_s))
            self.phase_samples += 1
            self.total_host_prep_s += prep_s
            self.total_device_s += device_s
            self.total_host_drain_s += drain_s

    # -- unlocked readers (callers hold _lock) -------------------------------

    def _latency_us_locked(self) -> int:
        if not self._recent:
            return -1
        return int(sum(self._recent) / len(self._recent))

    def _throughput_milli_fps_locked(self) -> int:
        if (self.total_invoke_num < 2 or self._first_ts is None
                or self._last_ts is None or self._last_ts <= self._first_ts):
            return -1
        fps = (self.total_frame_num - self._first_frames) \
            / (self._last_ts - self._first_ts)
        return int(fps * 1000)

    def _dispatch_milli_fps_locked(self) -> int:
        if (self.total_invoke_num < 2 or self._first_ts is None
                or self._last_ts is None or self._last_ts <= self._first_ts):
            return -1
        dps = (self.total_invoke_num - 1) / (self._last_ts - self._first_ts)
        return int(dps * 1000)

    def _avg_batch_occupancy_locked(self) -> float:
        if self.total_invoke_num == 0:
            return 0.0
        return self.total_frame_num / self.total_invoke_num

    def _avg_stream_occupancy_locked(self) -> float:
        if self.total_invoke_num == 0:
            return 0.0
        return self.total_stream_num / self.total_invoke_num

    def _phase_means_us_locked(self):
        """Rolling-window mean of each phase in µs, or (-1,-1,-1) before
        the first sampled dispatch (same "no data yet" sentinel as
        :attr:`latency_us`)."""
        if not self._phase_recent:
            return -1, -1, -1
        n = len(self._phase_recent)
        prep = sum(p for p, _, _ in self._phase_recent) / n
        dev = sum(d for _, d, _ in self._phase_recent) / n
        drain = sum(d for _, _, d in self._phase_recent) / n
        return int(prep * 1e6), int(dev * 1e6), int(drain * 1e6)

    # -- public readers ------------------------------------------------------

    @property
    def latency_us(self) -> int:
        """Average invoke latency over the recent window, µs (parity:
        'latency' property, tensor_filter_common.c:982-988)."""
        with self._lock:
            return self._latency_us_locked()

    @property
    def throughput_milli_fps(self) -> int:
        """1000×FPS over the whole run, in FRAMES (parity: 'throughput'
        property, tensor_filter_common.c:989-996; identical to the
        dispatch rate when every invoke carries one frame).  The first
        dispatch's frames are excluded, mirroring the unbatched (N-1)
        events over (N-1) intervals accounting — else a 2-dispatch
        batched run would report nearly double its true rate."""
        with self._lock:
            return self._throughput_milli_fps_locked()

    @property
    def dispatch_milli_fps(self) -> int:
        """1000×dispatches/s — with micro-batching, the device dispatch rate
        (< frame rate when coalescing is happening)."""
        with self._lock:
            return self._dispatch_milli_fps_locked()

    @property
    def avg_batch_occupancy(self) -> float:
        """Mean frames per dispatch (1.0 unbatched)."""
        with self._lock:
            return self._avg_batch_occupancy_locked()

    @property
    def avg_stream_occupancy(self) -> float:
        """Mean distinct streams contributing to one dispatch (1.0 for a
        single-pipeline filter; >1 exactly when the serving pool is
        coalescing across pipelines)."""
        with self._lock:
            return self._avg_stream_occupancy_locked()

    def snapshot(self) -> dict:
        """Every derived statistic as ONE consistent dict, read under a
        single lock acquisition — the poller API.  Reading the
        individual properties instead takes the lock once per field, so
        a dispatch landing between
        reads yields e.g. a frame total from one dispatch and a latency
        from the next."""
        with self._lock:
            prep_us, dev_us, drain_us = self._phase_means_us_locked()
            return {
                "invokes": self.total_invoke_num,
                "frames": self.total_frame_num,
                "latency_us": self._latency_us_locked(),
                "throughput_milli_fps": self._throughput_milli_fps_locked(),
                "dispatch_milli_fps": self._dispatch_milli_fps_locked(),
                "avg_batch_occupancy": self._avg_batch_occupancy_locked(),
                "avg_stream_occupancy": self._avg_stream_occupancy_locked(),
                "attached_streams": self.attached_streams,
                "host_prep_us": prep_us,
                "device_us": dev_us,
                "host_drain_us": drain_us,
                "phase": {
                    "samples": self.phase_samples,
                    "host_prep_s": self.total_host_prep_s,
                    "device_s": self.total_device_s,
                    "host_drain_s": self.total_host_drain_s,
                },
            }


    def latency_to_report(self) -> Optional[int]:
        """µs to report on the bus if it moved past the threshold, else
        None (parity: track_latency, tensor_filter.c:480-506).  The
        window mean and the last-reported compare-and-swap run under one
        lock acquisition."""
        with self._lock:
            cur = self._latency_us_locked()
            if cur < 0:
                return None
            last = self._last_reported_us
            if last is None or \
                    abs(cur - last) > last * LATENCY_REPORT_THRESHOLD:
                self._last_reported_us = cur
                return int(cur * LATENCY_REPORT_HEADROOM)
        return None


class DispatchSampler:
    """The time-based gate on blocking stats samples, shared by the
    filter element and the serving pool.  PyTorch launches work
    asynchronously, so a dispatch's time is known only if the host waits
    for it: at most one dispatch per ``interval_s`` (and the first) is a
    sample, which first drains the backlog of earlier dispatches — so
    its time covers ONE dispatch — and then waits for its own outputs.
    The others are only counted.  Callers serialize their dispatches.

    Under the obs kill switch (``NNS_TPU_TORCH_OBS_DISABLE``) no dispatch
    is a sample — the dispatch path never waits for the card — and no
    output is kept alive for a next sample."""

    def __init__(self, stats: InvokeStats):
        self.stats = stats
        self._seq = 0
        self._last_ts = 0.0
        self._last_out: Any = None  # the previous dispatch's last output

    def begin(self, interval_s: float,
              force: bool = False) -> Tuple[bool, float]:
        """Whether this dispatch is a sample, and its start time.
        ``force`` makes every dispatch a sample (``latency=1``)."""
        if _hooks.DISABLED:
            return False, time.monotonic()
        self._seq += 1
        sample = (force or self._seq == 1 or
                  time.monotonic() - self._last_ts >= interval_s)
        if sample and self._last_out is not None:
            block_all([self._last_out])
        return sample, time.monotonic()

    def end(self, outs: List[Any], t0: float, sample: bool, frames: int = 1,
            streams: int = 1) -> float:
        """Record (sample) or count the dispatch that started at ``t0``;
        returns the time its outputs were done (a sample) or queued."""
        if sample:
            block_all(outs)
            t2 = time.monotonic()
            self.stats.record(t2 - t0, frames=frames, streams=streams)
            self._last_ts = t2
        else:
            t2 = time.monotonic()
            self.stats.count(frames=frames, streams=streams)
        self._last_out = (outs[-1] if outs else None) \
            if not _hooks.DISABLED else None
        return t2
