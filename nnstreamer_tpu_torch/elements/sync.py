"""Time synchronization for N-input collect elements (mux/merge/crop).

Counterpart of the JAX package's ``elements/sync.py`` (parity target: the
reference's time-sync engine over GstCollectPads and
``gst_tensor_time_sync_buffer_from_collectpad``), with the four policies
of the reference's synchronization-policies-at-mux-merge.md:

- ``nosync``   — no timestamp logic; emit whenever every pad has a buffer.
- ``slowest``  — base time is the *oldest* head timestamp among pads (the
  slowest stream); faster pads drop buffers older than the base.
- ``basepad``  — base time comes from a designated pad (option
  ``<pad_index>:<duration_ns>``); other pads match within the duration.
- ``refresh``  — emit on every arrival on any pad, reusing the most recent
  buffer of the quieter pads.

The runtime difference from GStreamer: collection runs inside ``chain()``
on the depositing thread (no dedicated collect thread).  ``deposit()``
returns zero or more complete buffer-sets to emit, so a fast pad can drain
several sets at once.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

from ..core import Buffer


@dataclasses.dataclass(frozen=True)
class SyncPolicy:
    mode: str = "nosync"  # nosync | slowest | basepad | refresh
    base_pad: int = 0
    duration_ns: Optional[int] = None  # basepad match window

    @classmethod
    def parse(cls, mode: str, option: str = "") -> "SyncPolicy":
        mode = (mode or "nosync").strip().lower()
        if mode not in ("nosync", "slowest", "basepad", "refresh"):
            raise ValueError(f"unknown sync mode {mode!r}")
        base_pad, duration = 0, None
        if mode == "basepad" and option:
            head, _, dur = str(option).partition(":")
            base_pad = int(head or 0)
            duration = int(dur) if dur else None
        return cls(mode=mode, base_pad=base_pad, duration_ns=duration)


class Collector:
    """Per-element collect state: one FIFO per sink pad + the sync policy."""

    def __init__(self, policy: SyncPolicy, pad_names: List[str]):
        self.policy = policy
        self._lock = threading.Lock()
        self._queues: Dict[str, Deque[Buffer]] = {
            n: deque() for n in pad_names}
        self._last: Dict[str, Optional[Buffer]] = {n: None for n in pad_names}
        self._eos: set = set()
        self._order: List[str] = list(pad_names)

    def add_pad(self, name: str) -> None:
        with self._lock:
            if name not in self._queues:
                self._queues[name] = deque()
                self._last[name] = None
                self._order.append(name)

    # -- deposit → complete sets ---------------------------------------------

    def deposit(self, pad_name: str, buf: Buffer
                ) -> List[Dict[str, Buffer]]:
        """Add a buffer; return every now-complete synchronized set, in
        emit order.  Each set maps pad name → Buffer."""
        with self._lock:
            self._queues[pad_name].append(buf)
            out = []
            while True:
                s = self._try_collect(arrived=pad_name)
                if s is None:
                    break
                out.append(s)
                if self.policy.mode == "refresh":
                    break  # refresh emits exactly one set per arrival
            return out

    def mark_eos(self, pad_name: str) -> bool:
        """Returns True when every pad has seen EOS."""
        with self._lock:
            self._eos.add(pad_name)
            return self._eos >= set(self._queues)

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    # -- policy cores (call with lock held) ----------------------------------

    def _heads(self) -> Optional[Dict[str, Buffer]]:
        if any(not q for n, q in self._queues.items() if n not in self._eos):
            return None
        heads = {n: q[0] for n, q in self._queues.items() if q}
        return heads or None

    def _try_collect(self, arrived: str) -> Optional[Dict[str, Buffer]]:
        mode = self.policy.mode
        if mode == "refresh":
            # Every pad must have seen at least one buffer; reuse stale ones.
            q = self._queues[arrived]
            if not q:
                return None
            self._last[arrived] = q.popleft()
            if any(self._last[n] is None for n in self._queues):
                return None
            return dict(self._last)

        heads = self._heads()
        if heads is None:
            return None
        if mode == "nosync":
            return {n: self._queues[n].popleft() for n in heads}

        # timestamped modes: pick base time, then per-pad the newest buffer
        # not newer than base (dropping the older ones it supersedes)
        def pts(b: Buffer) -> int:
            return b.pts if b.pts is not None else 0

        if mode == "slowest":
            base = max(pts(b) for b in heads.values())
        else:  # basepad
            idx = min(self.policy.base_pad, len(self._order) - 1)
            base_name = self._order[idx]
            if base_name not in heads:
                return None  # base pad at EOS with empty queue: stop
            base = pts(heads[base_name])
        limit = base if self.policy.duration_ns is None \
            else base + self.policy.duration_ns
        out = {}
        for n, q in self._queues.items():
            if not q:
                continue  # pad at EOS, queue drained: skip it
            # drop buffers superseded by a newer one still within the limit
            while len(q) > 1 and pts(q[1]) <= limit:
                q.popleft()
            if pts(q[0]) <= limit:
                out[n] = q.popleft()
            else:
                # pad ran ahead of the base: contribute its pending buffer
                # without consuming it (it pairs again with the next base)
                out[n] = q[0]
        return out
