"""``device_src`` — a source whose frames are staged in device memory.

Counterpart of the JAX package's ``elements/devicesrc.py``.  Frames are
staged onto the pipeline's device once (a bounded pool) and the streaming
loop never touches the host again — each created Buffer references a pool
slot.  The right source for benchmarks and for any pipeline whose ingest
can be prefetched (replay, synthetic load, camera DMA staging).

Patterns: ``noise`` (seeded numpy uint8 / normal noise), ``gradient``,
``frames`` (a user-supplied ndarray pool, uploaded at start).  The noise is
drawn on the host with the same numpy generator and seed sequence as the
JAX package, so both packages stage the same bytes.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np

from ..core import Buffer, Tensor, TensorsSpec
from ..core.buffer import from_numpy
from ..obs import transfer as _xfer
from ..runtime.element import NegotiationError, SourceElement
from ..runtime.registry import register_element

_stage_seed = itertools.count(1)


@register_element("device_src")
class DeviceSrc(SourceElement):
    FACTORY = "device_src"

    def __init__(self, name=None, spec: Optional[TensorsSpec] = None,
                 pattern: str = "noise", frames: Optional[Sequence] = None,
                 pool_size: int = 4, num_buffers: int = -1,
                 fps: Optional[float] = None, **props):
        self.spec = spec
        self.pattern = pattern
        self.frames = frames
        self.pool_size = pool_size
        self.num_buffers = num_buffers
        self.fps = fps
        super().__init__(name, **props)
        self._pool: List[List[object]] = []  # pool[i] = per-tensor tensors
        self._i = 0

    def output_spec(self):
        if isinstance(self.spec, str):
            # pipeline-string form: `spec=3:224:224:64` or
            # `spec=3:224:224:1/float32,1000:1/float32` — dims[/type] per
            # tensor, type defaulting to the pattern dtype (uint8)
            dims, types = [], []
            for part in self.spec.split(","):
                d, _, t = part.partition("/")
                dims.append(d.strip())
                types.append(t.strip() or "uint8")
            self.spec = TensorsSpec.parse(",".join(dims), ",".join(types))
        if self.spec is None and self.frames is not None:
            first = self.frames[0]
            arrays = first if isinstance(first, (list, tuple)) else [first]
            self.spec = TensorsSpec.from_shapes(
                [a.shape for a in arrays], [np.dtype(a.dtype) for a in arrays])
        return self.spec

    def start(self) -> None:
        # the staging uploads are this source's crossings in the ledger
        xctx = _xfer.push_context(
            self.pipeline.name if self.pipeline is not None else "",
            self.name)
        try:
            self._stage_pool()
        finally:
            _xfer.pop_context(xctx)
        super().start()

    def _stage_pool(self) -> None:
        spec = self.output_spec()
        if spec is None:
            raise NegotiationError(f"{self.name}: no spec/frames given")
        dev = self.device
        self._pool = []
        if self.frames is not None:
            for f in self.frames[:min(self.pool_size, len(self.frames))]:
                arrays = f if isinstance(f, (list, tuple)) else [f]
                self._pool.append([from_numpy(np.asarray(a), dev)
                                   for a in arrays])
            return
        # a fresh seed per staging: two pipeline instantiations must not
        # stage byte-identical pools (same sequence as the JAX package)
        rng = np.random.default_rng(next(_stage_seed))
        for k in range(self.pool_size):
            staged = []
            for t in spec.tensors:
                if self.pattern == "gradient":
                    flat = np.arange(t.num_elements, dtype=np.int64)
                    host = ((flat + k) % 256).astype(
                        t.dtype.np_dtype).reshape(t.shape)
                else:  # noise
                    if t.dtype.np_dtype == np.uint8:
                        host = rng.integers(
                            0, 256, t.shape, dtype=np.uint8)
                    else:
                        host = rng.standard_normal(t.shape).astype(
                            t.dtype.np_dtype)
                staged.append(from_numpy(host, dev))
            self._pool.append(staged)

    def create(self) -> Optional[Buffer]:
        if 0 <= self.num_buffers <= self._i:
            return None
        slot = self._pool[self._i % len(self._pool)]
        pts = duration = None
        if self.fps:
            pts = int(self._i * 1_000_000_000 / self.fps)
            duration = int(1_000_000_000 / self.fps)
        buf = Buffer(tensors=[Tensor(a) for a in slot], pts=pts,
                     duration=duration, offset=self._i)
        self._i += 1
        return buf
