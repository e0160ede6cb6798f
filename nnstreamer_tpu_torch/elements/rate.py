"""``tensor_rate`` — framerate control + QoS throttling.

Counterpart of the JAX package's ``elements/rate.py`` (parity: the
reference's gsttensor_rate.c, properties ``framerate``, ``throttle``,
``silent`` and the in/out/duplicate/drop counters): adjusts the stream to
a target framerate by dropping or duplicating frames against the PTS
clock, and — with ``throttle=true`` — sends a QoS event upstream that
``tensor_filter`` and the sources honor by skipping work.  A frame with no
pts passes through.

No tensor is read: a frame on the device stays there.  Every frame is
pushed as its own handles, marked shared (``Tensor.shared_view``), since
a later slot may push the same frame again as a duplicate.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

from ..core import SECOND, Buffer, Caps
from ..runtime.element import NegotiationError, Pad, TransformElement
from ..runtime.events import Event
from ..runtime.registry import register_element


@register_element("tensor_rate")
class TensorRate(TransformElement):
    FACTORY = "tensor_rate"

    def __init__(self, name=None, framerate: str = "0/1",
                 throttle: bool = False, silent: bool = True, **props):
        self.framerate = framerate
        self.throttle = throttle
        self.silent = silent
        super().__init__(name, **props)
        self.in_count = 0
        self.out_count = 0
        self.dup_count = 0
        self.drop_count = 0
        self._next_ts: Optional[int] = None
        self._prev: Optional[Buffer] = None

    def _target(self) -> Fraction:
        s = str(self.framerate)
        if "/" in s:
            n, d = s.split("/")
            return Fraction(int(n), int(d or 1))
        return Fraction(s)

    def propose_src_caps(self, pad: Pad) -> Caps:
        in_spec = self.sinkpad.spec
        if in_spec is None:
            raise NegotiationError(f"{self.name}: no input caps")
        target = self._target()
        return Caps.from_spec(
            in_spec.with_rate(target if target else in_spec.rate))

    def start(self) -> None:
        if self.throttle and self._target():
            # ask upstream to not produce faster than the target
            self.sinkpad.push_upstream_event(
                Event.qos_throttle(self._target()))

    def _emit(self, src: Buffer, pts: int, interval: int) -> None:
        self.push(Buffer(tensors=[t.shared_view() for t in src.tensors],
                         pts=pts, duration=interval, offset=src.offset,
                         meta=dict(src.meta)))
        self.out_count += 1

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        self.in_count += 1
        target = self._target()
        if not target or buf.pts is None:
            self.out_count += 1
            return buf  # passthrough without a clock
        interval = int(SECOND / target)
        if self._next_ts is None:
            self._next_ts = buf.pts
        # fill slots the stream skipped over with whichever of the
        # previous/current frame is closer to the slot time (videorate /
        # gsttensor_rate semantics — always using prev would hand buffers
        # arriving just after a slot boundary one-frame-stale output)
        while self._prev is not None and self._next_ts < buf.pts:
            src = self._prev
            if (self._prev.pts is not None
                    and abs(buf.pts - self._next_ts)
                    < abs(self._next_ts - self._prev.pts)):
                src = buf
            self._emit(src, self._next_ts, interval)
            self._next_ts += interval
            self.dup_count += 1
        if buf.pts >= self._next_ts:
            self._emit(buf, self._next_ts, interval)
            self._next_ts += interval
        else:
            self.drop_count += 1  # more input frames than slots
        self._prev = buf
        return None
