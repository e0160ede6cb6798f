"""Wire-format decoders: tensors → flatbuf / protobuf payload streams.

Counterpart of the JAX package's ``decoders/wirefmt.py`` (parity
targets: the reference's tensordec-flatbuf.cc, mime
``other/flatbuf-tensor``, and tensordec-protobuf.cc, mime
``other/protobuf-tensor``).

Each serializes the whole tensor frame (schema + payloads) into one
self-describing byte buffer — the encode direction of the corresponding
converter sub-plugin in ``converters/wirefmt.py`` (codecs shared via
``converters/codecs.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..converters.codecs import flatbuf_encode, protobuf_encode
from ..core import Buffer, Caps, CapsStruct, Tensor, TensorSpec, TensorsSpec
from . import Decoder, register_decoder


class _WireDecoder(Decoder):
    MIME = ""
    ENCODE: Callable[[Buffer, Optional[TensorsSpec]], bytes] = None

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        return Caps.new(CapsStruct.make(
            type(self).MIME, framerate=in_spec.rate))

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        payload = type(self).ENCODE(buf, in_spec)
        arr = np.frombuffer(payload, np.uint8)
        return Buffer(
            tensors=[Tensor(arr, TensorSpec.from_shape(arr.shape, np.uint8))],
            pts=buf.pts, duration=buf.duration, meta=dict(buf.meta))


@register_decoder
class FlatbufDecoder(_WireDecoder):
    MODE = "flatbuf"
    MIME = "other/flatbuf-tensor"
    ENCODE = staticmethod(flatbuf_encode)


@register_decoder
class ProtobufDecoder(_WireDecoder):
    MODE = "protobuf"
    MIME = "other/protobuf-tensor"
    ENCODE = staticmethod(protobuf_encode)
