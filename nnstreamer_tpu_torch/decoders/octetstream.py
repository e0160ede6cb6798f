"""``octet_stream`` decoder: tensors → raw byte stream.

Counterpart of the JAX package's ``decoders/octetstream.py`` (parity
target: the reference's tensordec-octetstream.c): concatenates tensor
payloads into an ``application/octet-stream`` buffer (the inverse of the
converter's octet ingestion).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import Buffer, Caps, CapsStruct, Tensor, TensorSpec, TensorsSpec
from . import Decoder, register_decoder


@register_decoder
class OctetStream(Decoder):
    MODE = "octet_stream"

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        return Caps.new(CapsStruct.make(
            "application/octet-stream", framerate=in_spec.rate))

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        payload = b"".join(t.tobytes() for t in buf.tensors)
        arr = np.frombuffer(payload, np.uint8)
        return Buffer(
            tensors=[Tensor(arr, TensorSpec.from_shape(arr.shape, np.uint8))],
            pts=buf.pts, duration=buf.duration, meta=dict(buf.meta))
