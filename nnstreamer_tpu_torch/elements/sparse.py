"""``tensor_sparse_enc`` / ``tensor_sparse_dec`` — static⇄sparse format.

Counterpart of the JAX package's ``elements/sparse.py`` (parity: the
reference's gsttensor_sparseenc.c / gsttensor_sparsedec.c with the codec
of gsttensor_sparseutil.c): sparse wire layout = meta header + nnz + u32
index list + values (``core/buffer.py`` sparse codec).  For shrinking the
wire of mostly-zero tensors (one-hot outputs, masks, overlays) before a
hop off the machine.

The encoder finds a device tensor's nonzeros on the device and copies
only the indices and values to the host, in one copy a tensor; the
decoder makes host tensors, as the JAX element does.
"""

from __future__ import annotations

import numpy as np

from ..core import Buffer, Caps, Tensor, TensorFormat, TensorSpec, TensorsSpec
from ..core.buffer import sparse_from_dense, sparse_to_dense
from ..core.caps import CapsStruct
from ..core.types import MIMETYPE_TENSORS
from ..runtime.element import NegotiationError, Pad, TransformElement
from ..runtime.registry import register_element


@register_element("tensor_sparse_enc")
class TensorSparseEnc(TransformElement):
    FACTORY = "tensor_sparse_enc"

    def propose_src_caps(self, pad: Pad) -> Caps:
        in_spec = self.sinkpad.spec
        if in_spec is None:
            raise NegotiationError(f"{self.name}: no input caps")
        return Caps.from_spec(TensorsSpec(
            format=TensorFormat.SPARSE, rate=in_spec.rate))

    def transform(self, buf: Buffer) -> Buffer:
        payloads = [sparse_from_dense(t) for t in buf.tensors]
        tensors = [
            Tensor(np.frombuffer(p, np.uint8),
                   TensorSpec.from_shape((len(p),), np.uint8))
            for p in payloads]
        return Buffer(tensors=tensors, pts=buf.pts, duration=buf.duration,
                      offset=buf.offset, format=TensorFormat.SPARSE,
                      meta=dict(buf.meta))


@register_element("tensor_sparse_dec")
class TensorSparseDec(TransformElement):
    FACTORY = "tensor_sparse_dec"

    def pad_template_caps(self, pad: Pad) -> Caps:
        if pad.direction.value == "sink":
            return Caps.new(CapsStruct.make(
                MIMETYPE_TENSORS, format="sparse"))
        return Caps.any_tensors()

    def propose_src_caps(self, pad: Pad) -> Caps:
        in_spec = self.sinkpad.spec
        rate = in_spec.rate if in_spec is not None else None
        # payload schema travels per-buffer in the sparse meta header
        return Caps.from_spec(TensorsSpec(
            format=TensorFormat.FLEXIBLE,
            rate=rate if rate is not None else 0))

    def transform(self, buf: Buffer) -> Buffer:
        tensors = [sparse_to_dense(t.tobytes()) for t in buf.tensors]
        return Buffer(tensors=tensors, pts=buf.pts, duration=buf.duration,
                      offset=buf.offset, format=TensorFormat.FLEXIBLE,
                      meta=dict(buf.meta))
