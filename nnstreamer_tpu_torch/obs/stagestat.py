"""Per-stage attribution: cascade offload rows and cross-subset handoffs.

Counterpart of the JAX package's ``obs/stagestat.py``:

- **offload rows** (one per routing ``tensor_if``): how many frames the
  conditional cascade sent down the offload (heavy-stage) branch vs kept
  local — ``nns_cascade_offload_ratio`` is offloaded/total.
  ``tensor_if offload=`` records each routing decision here.
- **handoff rows** (one per receiving stage filter): frames and exact
  bytes that crossed INTO a stage from another device subset (the
  canonical source/destination subset labels,
  ``parallel.placement.subset_label``), and the inter-stage depth —
  frames handed off but not yet emitted by the stage.  The filter's
  stage ingress (``tensor_filter devices=``) records the handoff; the
  stage's emit seams record the depth's decrement.

Pulled by the metrics registry at scrape time: the snapshot's ``stages``
table and the ``nns_stage_handoff_{bytes,frames}_total`` /
``nns_stage_depth`` / ``nns_cascade_*`` families.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import hooks as _hooks

#: fast-path flag (same contract as obs/transfer.py)
ACTIVE = not _hooks.DISABLED


class _HandoffRow:
    __slots__ = ("src", "dst", "frames", "bytes", "emits")

    def __init__(self, src: str, dst: str):
        self.src = src
        self.dst = dst
        self.frames = 0
        self.bytes = 0
        self.emits = 0


class _OffloadRow:
    __slots__ = ("dst", "offloaded", "kept")

    def __init__(self, dst: str):
        self.dst = dst
        self.offloaded = 0
        self.kept = 0


class StageStats:
    """Process-wide, thread-safe per-stage handoff/offload store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._handoff: Dict[Tuple[str, str], _HandoffRow] = {}
        self._offload: Dict[Tuple[str, str], _OffloadRow] = {}

    def record_handoff(self, pipeline: str, stage: str, src: str,
                       dst: str, frames: int, nbytes: int) -> None:
        """Count one cross-subset handoff INTO ``stage``: ``frames``
        frames, ``nbytes`` exact payload bytes, moving from subset
        ``src`` to subset ``dst``."""
        key = (str(pipeline), str(stage))
        with self._lock:
            row = self._handoff.get(key)
            if row is None or row.src != src or row.dst != dst:
                prev = row
                row = self._handoff[key] = _HandoffRow(str(src), str(dst))
                if prev is not None:  # subset changed: keep the totals
                    row.frames, row.bytes = prev.frames, prev.bytes
                    row.emits = prev.emits
            row.frames += int(frames)
            row.bytes += int(nbytes)

    def record_emit(self, pipeline: str, stage: str,
                    frames: int = 1) -> None:
        """A handed-off frame left the stage (the depth decrement)."""
        key = (str(pipeline), str(stage))
        with self._lock:
            row = self._handoff.get(key)
            if row is not None:
                row.emits += int(frames)

    def record_offload(self, pipeline: str, element: str,
                       offloaded: bool, dst: str = "") -> None:
        """Count one cascade routing decision at ``element`` (a
        ``tensor_if`` with the ``offload=`` property): ``offloaded``
        frames go to the heavy stage, the rest stay local."""
        key = (str(pipeline), str(element))
        with self._lock:
            row = self._offload.get(key)
            if row is None:
                row = self._offload[key] = _OffloadRow(str(dst))
            elif dst and row.dst != dst:
                row.dst = str(dst)
            if offloaded:
                row.offloaded += 1
            else:
                row.kept += 1

    # -- pull side -----------------------------------------------------------

    def snapshot(self) -> List[dict]:
        """Rows for the registry's ``stages`` table (v8), sorted:
        ``kind="handoff"`` rows per receiving stage, ``kind="offload"``
        rows per routing tensor_if."""
        out: List[dict] = []
        with self._lock:
            handoff = [(k, r.src, r.dst, r.frames, r.bytes, r.emits)
                       for k, r in sorted(self._handoff.items())]
            offload = [(k, r.dst, r.offloaded, r.kept)
                       for k, r in sorted(self._offload.items())]
        for (pl, stage), src, dst, frames, nbytes, emits in handoff:
            out.append({
                "kind": "handoff", "pipeline": pl, "stage": stage,
                "from": src, "to": dst,
                "frames": frames, "bytes": nbytes,
                # frames that crossed into the stage but have not left
                # it yet: the inter-stage queue depth
                "depth": max(frames - emits, 0),
            })
        for (pl, el), dst, offed, kept in offload:
            total = offed + kept
            out.append({
                "kind": "offload", "pipeline": pl, "stage": el,
                "to": dst, "offloaded": offed, "kept": kept,
                "ratio": (offed / total) if total else 0.0,
            })
        return out

    def get(self, pipeline: str, stage: str) -> Optional[dict]:
        for row in self.snapshot():
            if row["pipeline"] == str(pipeline) \
                    and row["stage"] == str(stage):
                return row
        return None

    def reset(self) -> None:
        """Tests only: drop every row."""
        with self._lock:
            self._handoff.clear()
            self._offload.clear()


#: the process-wide store the handoff/offload seams feed
STAGE_STATS = StageStats()


def record_handoff(pipeline: str, stage: str, src: str, dst: str,
                   frames: int, nbytes: int) -> None:
    """Module-level shim (inert under the global obs kill switch;
    never raises into the hot path)."""
    if not ACTIVE:
        return
    try:
        STAGE_STATS.record_handoff(pipeline, stage, src, dst,
                                   frames, nbytes)
    except Exception:  # noqa: BLE001 - telemetry must not kill a dispatch
        pass


def record_emit(pipeline: str, stage: str, frames: int = 1) -> None:
    if not ACTIVE:
        return
    try:
        STAGE_STATS.record_emit(pipeline, stage, frames)
    except Exception:  # noqa: BLE001 - telemetry must not kill a dispatch
        pass


def record_offload(pipeline: str, element: str, offloaded: bool,
                   dst: str = "") -> None:
    if not ACTIVE:
        return
    try:
        STAGE_STATS.record_offload(pipeline, element, offloaded, dst)
    except Exception:  # noqa: BLE001 - telemetry must not kill a dispatch
        pass
