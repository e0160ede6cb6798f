"""Wire codecs shared by the converter (decode) and decoder (encode)
sub-plugins: FlexBuffers, FlatBuffers, and protobuf tensor frames.

Counterpart of the JAX package's ``converters/codecs.py``; the payloads
are byte-equal to its pure-Python path.  Parity targets:

- flexbuf map layout — the reference's tensor_converter_flexbuf.cc (keys
  ``num_tensors``/``rate_n``/``rate_d``/``format``/``tensor_#``;
  per-tensor vector of [name, type, dims, blob]).
- flatbuf schema — the reference's nnstreamer.fbs (``Tensors`` root
  table: num_tensor, frame_rate struct, [Tensor], format; ``Tensor``:
  name, type, [uint32] dimension, [ubyte] data).
- protobuf schema — the reference's nnstreamer.proto (same logical
  layout; field numbers are the wire contract and are kept identical so
  payloads interoperate).

The dtype enum on all three wires is the reference's ``Tensor_type``
ordering, which :class:`~nnstreamer_tpu_torch.core.types.DType`
preserves — ``int(DType)`` IS the wire value.  Dimensions travel in
nnstreamer dim order (innermost-first), converted at the edges via
``dims_to_shape``/``shape_to_dims``.

The protobuf codec is hand-rolled proto3 wire format (varints +
length-delimited fields), so neither a schema compiler nor a package is
needed; it accepts packed and unpacked repeated dimensions.  FlexBuffers
and FlatBuffers need the ``flatbuffers`` package, imported when a
payload is first encoded or decoded: without it they raise an
``ImportError`` naming the package, and protobuf goes on working.  The
JAX package first tries a C++ mirror of the protobuf loops
(``nnstreamer_tpu/native/nns_wire.cc``); the port has only the Python
path.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import (
    Buffer,
    DType,
    Tensor,
    TensorFormat,
    TensorSpec,
    TensorsSpec,
    shape_to_dims,
)

__all__ = [
    "flexbuf_encode", "flexbuf_decode",
    "flatbuf_encode", "flatbuf_decode",
    "protobuf_encode", "protobuf_decode",
]


def _frame(buf: Buffer, spec: Optional[TensorsSpec]):
    """(arrays, names, rate, format) for one outgoing buffer."""
    arrays = [t.np() for t in buf.tensors]
    names = []
    for i, t in enumerate(buf.tensors):
        sp = t.spec
        names.append(sp.name or "")
    rate = spec.rate if spec is not None and spec.rate else Fraction(0, 1)
    fmt = buf.format if buf.format is not None else TensorFormat.STATIC
    return arrays, names, rate, fmt


def _rebuild(arrays: List[np.ndarray], names: List[str], rate_n: int,
             rate_d: int, fmt: int) -> Tuple[Buffer, TensorsSpec]:
    tensors = []
    for arr, nm in zip(arrays, names):
        sp = TensorSpec(dtype=DType.from_np(arr.dtype),
                        dims=shape_to_dims(arr.shape), name=nm or None)
        tensors.append(Tensor(arr, sp))
    rate = Fraction(rate_n, rate_d) if rate_d else Fraction(0, 1)
    spec = TensorsSpec.of(*[t.spec for t in tensors],
                          format=TensorFormat(fmt), rate=rate)
    return Buffer(tensors=tensors, format=TensorFormat(fmt)), spec


def _wire_dims(arr: np.ndarray) -> Sequence[int]:
    # The reference writers always emit RANK_LIMIT (16) entries, zero-
    # filled beyond the rank, and its readers unconditionally read all 16
    # (e.g. tensor_converter_flatbuf.cc:121) — pad for interop.
    dims = list(shape_to_dims(arr.shape))
    return dims + [0] * (16 - len(dims))


def _np_from_wire(dtype_val: int, dims: Sequence[int],
                  payload: bytes) -> np.ndarray:
    dt = DType(dtype_val)
    shape = tuple(reversed([d for d in dims if d > 0])) or (0,)
    n = int(np.prod(shape)) if shape else 0
    arr = np.frombuffer(payload, dtype=dt.np_dtype, count=n)
    return arr.reshape(shape)


# flatbuffers is imported lazily so the protobuf codec and everything
# upstream of it (decoder lookup, elements) keeps working without it.

def _require_flatbuffers():
    try:
        import flatbuffers  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the flexbuf and flatbuf wire formats need the 'flatbuffers' "
            "package, which is not installed (protobuf needs nothing)"
        ) from e


def _flexbuffers():
    _require_flatbuffers()
    from flatbuffers import flexbuffers

    return flexbuffers


def _flatbuffers():
    _require_flatbuffers()
    import flatbuffers
    from flatbuffers import number_types

    return flatbuffers, number_types


# -- FlexBuffers -------------------------------------------------------------

def flexbuf_encode(buf: Buffer, spec: Optional[TensorsSpec] = None) -> bytes:
    flexbuffers = _flexbuffers()
    arrays, names, rate, fmt = _frame(buf, spec)
    fbb = flexbuffers.Builder()
    with fbb.Map():
        fbb.Key("num_tensors")
        fbb.UInt(len(arrays))
        fbb.Key("rate_n")
        fbb.Int(int(rate.numerator))
        fbb.Key("rate_d")
        fbb.Int(int(rate.denominator))
        fbb.Key("format")
        fbb.Int(int(fmt.value))
        for i, (arr, nm) in enumerate(zip(arrays, names)):
            fbb.Key(f"tensor_{i}")
            with fbb.Vector():
                fbb.String(nm)
                fbb.Int(int(DType.from_np(arr.dtype).value))
                fbb.TypedVectorFromElements(
                    [int(d) for d in _wire_dims(arr)])
                fbb.Blob(np.ascontiguousarray(arr).tobytes())
    return bytes(fbb.Finish())


def flexbuf_decode(data: bytes) -> Tuple[Buffer, TensorsSpec]:
    flexbuffers = _flexbuffers()
    m = flexbuffers.GetRoot(bytes(data)).AsMap
    num = m["num_tensors"].AsInt
    rate_n, rate_d = m["rate_n"].AsInt, m["rate_d"].AsInt
    try:
        fmt = m["format"].AsInt
    except KeyError:
        fmt = int(TensorFormat.STATIC.value)
    arrays, names = [], []
    for i in range(num):
        tv = m[f"tensor_{i}"].AsVector
        names.append(tv[0].AsString)
        arrays.append(_np_from_wire(
            tv[1].AsInt, [d.AsInt for d in tv[2].AsTypedVector],
            bytes(tv[3].AsBlob)))
    return _rebuild(arrays, names, rate_n, rate_d, fmt)


# -- FlatBuffers (hand-built tables; no flatc/codegen) -----------------------

_T_NAME, _T_TYPE, _T_DIMS, _T_DATA = 0, 1, 2, 3           # Tensor slots
_TS_NUM, _TS_FR, _TS_VEC, _TS_FMT = 0, 1, 2, 3            # Tensors slots
_NNS_END = 11  # Tensor_type default in nnstreamer.fbs


def flatbuf_encode(buf: Buffer, spec: Optional[TensorsSpec] = None) -> bytes:
    flatbuffers, _N = _flatbuffers()
    arrays, names, rate, fmt = _frame(buf, spec)
    b = flatbuffers.Builder(1024)
    tensor_offs = []
    for arr, nm in zip(arrays, names):
        name_off = b.CreateString(nm)
        data_off = b.CreateByteVector(np.ascontiguousarray(arr).tobytes())
        dims = [int(d) for d in _wire_dims(arr)]
        b.StartVector(4, len(dims), 4)
        for d in reversed(dims):
            b.PrependUint32(d)
        dims_off = b.EndVector()
        b.StartObject(4)
        b.PrependUOffsetTRelativeSlot(_T_NAME, name_off, 0)
        b.PrependInt32Slot(_T_TYPE, int(DType.from_np(arr.dtype).value),
                           _NNS_END)
        b.PrependUOffsetTRelativeSlot(_T_DIMS, dims_off, 0)
        b.PrependUOffsetTRelativeSlot(_T_DATA, data_off, 0)
        tensor_offs.append(b.EndObject())
    b.StartVector(4, len(tensor_offs), 4)
    for off in reversed(tensor_offs):
        b.PrependUOffsetTRelative(off)
    vec_off = b.EndVector()
    b.StartObject(4)
    b.PrependInt32Slot(_TS_NUM, len(arrays), 0)
    b.Prep(4, 8)
    b.PrependInt32(int(rate.denominator))
    b.PrependInt32(int(rate.numerator))
    b.PrependStructSlot(_TS_FR, b.Offset(), 0)
    b.PrependUOffsetTRelativeSlot(_TS_VEC, vec_off, 0)
    b.PrependInt32Slot(_TS_FMT, int(fmt.value), 0)
    b.Finish(b.EndObject())
    return bytes(b.Output())


def _fb_slot(k: int) -> int:
    return 4 + 2 * k


def flatbuf_decode(data: bytes) -> Tuple[Buffer, TensorsSpec]:
    flatbuffers, _N = _flatbuffers()
    buf = bytes(data)
    pos = flatbuffers.encode.Get(flatbuffers.packer.uoffset, buf, 0)
    tab = flatbuffers.table.Table(buf, pos)
    o = tab.Offset(_fb_slot(_TS_NUM))
    num = tab.Get(_N.Int32Flags, o + tab.Pos) if o else 0
    o = tab.Offset(_fb_slot(_TS_FR))
    rate_n = rate_d = 0
    if o:
        rate_n = tab.Get(_N.Int32Flags, o + tab.Pos)
        rate_d = tab.Get(_N.Int32Flags, o + tab.Pos + 4)
    o = tab.Offset(_fb_slot(_TS_FMT))
    fmt = tab.Get(_N.Int32Flags, o + tab.Pos) if o \
        else int(TensorFormat.STATIC.value)
    arrays, names = [], []
    o = tab.Offset(_fb_slot(_TS_VEC))
    if o:
        vec = tab.Vector(o)
        for i in range(min(num, tab.VectorLen(o))):
            tt = flatbuffers.table.Table(buf, tab.Indirect(vec + 4 * i))
            no = tt.Offset(_fb_slot(_T_NAME))
            names.append(
                tt.String(no + tt.Pos).decode() if no else "")
            ty = tt.Offset(_fb_slot(_T_TYPE))
            ty = tt.Get(_N.Int32Flags, ty + tt.Pos) if ty else _NNS_END
            do = tt.Offset(_fb_slot(_T_DIMS))
            dims = []
            if do:
                dv = tt.Vector(do)
                dims = [tt.Get(_N.Uint32Flags, dv + 4 * j)
                        for j in range(tt.VectorLen(do))]
            po = tt.Offset(_fb_slot(_T_DATA))
            payload = b""
            if po:
                pv, pn = tt.Vector(po), tt.VectorLen(po)
                payload = buf[pv:pv + pn]
            arrays.append(_np_from_wire(ty, dims, payload))
    return _rebuild(arrays, names, rate_n, rate_d, fmt)


# -- protobuf (hand-rolled proto3 wire; field numbers = nnstreamer.proto) ----

def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def protobuf_encode(buf: Buffer, spec: Optional[TensorsSpec] = None) -> bytes:
    arrays, names, rate, fmt = _frame(buf, spec)
    out = bytearray()
    out += _tag(1, 0) + _varint(len(arrays))                  # num_tensor
    fr = _tag(1, 0) + _varint(int(rate.numerator)) \
        + _tag(2, 0) + _varint(int(rate.denominator))
    out += _ld(2, fr)                                         # fr
    for arr, nm in zip(arrays, names):                        # tensor
        t = bytearray()
        if nm:
            t += _ld(1, nm.encode())
        t += _tag(2, 0) + _varint(int(DType.from_np(arr.dtype).value))
        dims = b"".join(_varint(int(d)) for d in _wire_dims(arr))
        t += _ld(3, dims)                                     # packed dims
        t += _ld(4, np.ascontiguousarray(arr).tobytes())
        out += _ld(3, bytes(t))
    if int(fmt.value):
        out += _tag(4, 0) + _varint(int(fmt.value))           # format
    return bytes(out)


def _skip(data: bytes, i: int, wire: int) -> int:
    if wire == 0:
        _, i = _read_varint(data, i)
    elif wire == 1:
        i += 8
    elif wire == 2:
        ln, i = _read_varint(data, i)
        i += ln
    elif wire == 5:
        i += 4
    else:
        raise ValueError(f"protobuf: unsupported wire type {wire}")
    return i


def _decode_tensor(data: bytes) -> Tuple[str, int, List[int], bytes]:
    name, ty, dims, payload = "", _NNS_END, [], b""
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 2:
            ln, i = _read_varint(data, i)
            name = data[i:i + ln].decode()
            i += ln
        elif field == 2 and wire == 0:
            ty, i = _read_varint(data, i)
        elif field == 3 and wire == 2:          # packed dims
            ln, i = _read_varint(data, i)
            end = i + ln
            while i < end:
                d, i = _read_varint(data, i)
                dims.append(d)
        elif field == 3 and wire == 0:          # unpacked dim
            d, i = _read_varint(data, i)
            dims.append(d)
        elif field == 4 and wire == 2:
            ln, i = _read_varint(data, i)
            payload = data[i:i + ln]
            i += ln
        else:
            i = _skip(data, i, wire)
    return name, ty, dims, payload


def protobuf_decode(data: bytes) -> Tuple[Buffer, TensorsSpec]:
    data = bytes(data)
    rate_n = rate_d = 0
    fmt = int(TensorFormat.STATIC.value)
    arrays, names = [], []
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 0:
            _, i = _read_varint(data, i)        # num_tensor (len(tensor) wins)
        elif field == 2 and wire == 2:
            ln, i = _read_varint(data, i)
            sub, j = data[i:i + ln], 0
            i += ln
            while j < len(sub):
                k2, j = _read_varint(sub, j)
                f2, w2 = k2 >> 3, k2 & 7
                if f2 == 1 and w2 == 0:
                    rate_n, j = _read_varint(sub, j)
                elif f2 == 2 and w2 == 0:
                    rate_d, j = _read_varint(sub, j)
                else:
                    j = _skip(sub, j, w2)
        elif field == 3 and wire == 2:
            ln, i = _read_varint(data, i)
            nm, ty, dims, payload = _decode_tensor(data[i:i + ln])
            i += ln
            names.append(nm)
            arrays.append(_np_from_wire(ty, dims, payload))
        elif field == 4 and wire == 0:
            fmt, i = _read_varint(data, i)
        else:
            i = _skip(data, i, wire)
    return _rebuild(arrays, names, rate_n, rate_d, fmt)
