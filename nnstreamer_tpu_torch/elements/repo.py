"""``tensor_reposink`` / ``tensor_reposrc`` — cyclic streams via an
out-of-band tensor repository.

Counterpart of the JAX package's ``elements/repo.py`` (parity: the
reference's gsttensor_repo.c global slot table, gsttensor_reposink.c,
gsttensor_reposrc.c): dataflow graphs forbid cycles, so recurrence
(RNN/LSTM state feedback) goes through a shared slot keyed by ``slot``
index: reposink writes, reposrc reads (blocking with timeout, with an
initial "dummy" zero frame so the loop can start).

The port keeps its own slot table (``REPO``), never the JAX package's.
Slots hold Buffers as they are: a recurrent loop on the card keeps its
state in device memory across iterations.  The dummy first frame is made
on the pipeline's device.
"""

from __future__ import annotations

import queue as _q
import threading
from typing import Dict, Optional

import torch

from ..core import Buffer, Tensor, TensorsSpec
from ..runtime.element import NegotiationError, SinkElement, SourceElement
from ..runtime.registry import register_element


class _Repo:
    """Global slot table (parity: gsttensor_repo.c TensorRepo singleton)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: Dict[int, "_q.Queue"] = {}

    def slot(self, index: int) -> "_q.Queue":
        with self._lock:
            if index not in self._slots:
                self._slots[index] = _q.Queue(maxsize=2)
            return self._slots[index]

    def reset(self) -> None:
        with self._lock:
            self._slots.clear()


REPO = _Repo()


@register_element("tensor_reposink")
class TensorRepoSink(SinkElement):
    FACTORY = "tensor_reposink"

    def __init__(self, name=None, slot: int = 0, silent: bool = True,
                 **props):
        self.slot = slot
        self.silent = silent
        super().__init__(name, **props)

    def _put(self, item) -> None:
        """Bounded, non-wedging put: if the paired reposrc stopped reading
        (e.g. it hit num_buffers), displace the oldest entry instead of
        blocking the upstream streaming thread forever."""
        q = REPO.slot(int(self.slot))
        while True:
            try:
                q.put(item, timeout=0.5)
                return
            except _q.Full:
                try:
                    displaced = q.get_nowait()  # leaky: keep newest
                except _q.Empty:
                    continue
                if displaced is None:
                    # Never drop the EOS sentinel — the paired reposrc
                    # must still observe end-of-stream after this data
                    # buffer, or it blocks until timeout.
                    try:
                        q.put(item, timeout=0.5)
                    except _q.Full:
                        # another producer on the same slot refilled it;
                        # retry the whole sequence so EOS still lands last
                        self._put(item)
                    if item is not None:
                        self._put(None)  # re-append EOS after the data
                    return

    def render(self, buf: Buffer) -> None:
        self._put(buf)

    def on_eos(self) -> None:
        self._put(None)


@register_element("tensor_reposrc")
class TensorRepoSrc(SourceElement):
    """Reads slot ``slot``; emits an initial zero frame (``dummy``
    behavior) so a feedback loop has a first input."""

    FACTORY = "tensor_reposrc"

    def __init__(self, name=None, slot: int = 0, caps=None,
                 spec: Optional[TensorsSpec] = None, num_buffers: int = -1,
                 timeout: float = 10.0, dummy_first: bool = True, **props):
        self.slot = slot
        self.caps = caps
        self.spec = spec
        self.num_buffers = num_buffers
        self.timeout = timeout
        self.dummy_first = dummy_first
        super().__init__(name, **props)
        if isinstance(self.caps, str):
            from ..runtime.parser import parse_caps_string

            self.caps = parse_caps_string(self.caps)
        self._count = 0

    def output_spec(self):
        if self.spec is None and self.caps is not None:
            self.spec = self.caps.to_spec()
        if self.spec is None:
            raise NegotiationError(f"{self.name}: reposrc needs caps/spec")
        return self.spec

    def create(self) -> Optional[Buffer]:
        if 0 <= self.num_buffers <= self._count:
            return None
        self._count += 1
        if self._count == 1 and self.dummy_first:
            spec = self.output_spec()
            return Buffer(tensors=[
                Tensor(torch.zeros(t.shape, dtype=t.dtype.torch_dtype,
                                   device=self.device), t)
                for t in spec.tensors], pts=0)
        import time

        q = REPO.slot(int(self.slot))
        deadline = time.monotonic() + float(self.timeout)
        while self._running.is_set():
            try:
                return q.get(timeout=0.1)
            except _q.Empty:
                if time.monotonic() > deadline:
                    raise
        return None
