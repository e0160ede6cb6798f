"""Wire-format converter sub-plugins: flexbuf / flatbuf / protobuf.

Counterpart of the JAX package's ``converters/wirefmt.py`` (parity
targets: the reference's tensor_converter_flexbuf.cc (mime
``other/flexbuf``), tensor_converter_flatbuf.cc
(``other/flatbuf-tensor``) and tensor_converter_protobuf.cc
(``other/protobuf-tensor``)).

Each converts one self-describing wire payload into a tensor buffer.
Because the schema rides inside the payload, the negotiated out-caps are
``format=flexible``; the emitted buffers carry fully-typed tensors, so a
downstream ``tensor_converter`` (flexible→static) or any flexible-capable
element consumes them directly.
"""

from __future__ import annotations

from typing import Callable, Tuple

from ..core import (
    Buffer,
    CapsStruct,
    TensorFormat,
    TensorsSpec,
)
from . import ExternalConverter, register_converter
from .codecs import flatbuf_decode, flexbuf_decode, protobuf_decode


class _WireConverter(ExternalConverter):
    DECODE: Callable[[bytes], Tuple[Buffer, TensorsSpec]] = None

    def get_out_config(self, caps: CapsStruct) -> TensorsSpec:
        rate = caps.get("framerate", None) if caps is not None else None
        return TensorsSpec(format=TensorFormat.FLEXIBLE,
                           rate=rate or TensorsSpec().rate)

    def convert(self, buf: Buffer, caps: CapsStruct) -> Buffer:
        payload = buf.tensors[0].tobytes()
        out, _spec = type(self).DECODE(payload)
        out.pts, out.duration = buf.pts, buf.duration
        out.meta.update(buf.meta)
        out.format = TensorFormat.FLEXIBLE
        return out


@register_converter
class FlexbufConverter(_WireConverter):
    NAME = "flexbuf"
    MIMES = ("other/flexbuf",)
    DECODE = staticmethod(flexbuf_decode)


@register_converter
class FlatbufConverter(_WireConverter):
    NAME = "flatbuf"
    MIMES = ("other/flatbuf-tensor",)
    DECODE = staticmethod(flatbuf_decode)


@register_converter
class ProtobufConverter(_WireConverter):
    NAME = "protobuf"
    MIMES = ("other/protobuf-tensor",)
    DECODE = staticmethod(protobuf_decode)
