"""Per-tensor binary meta header for flexible / sparse streams (copied
from the JAX package's ``core/meta.py``; same wire layout and magic).

Parity target: ``GstTensorMetaInfo`` and its ser/de helpers
(nnstreamer:gst/nnstreamer/include/tensor_typedef.h:310-326,
nnstreamer_plugin_api_util_impl.c:1447 ``gst_tensor_meta_info_get_header_size``
and :1496 ``gst_tensor_meta_info_update_header``).

Wire layout (little-endian u32 fields):

    magic | version | dtype | dims[16] | format | media_type [| nnz]

``nnz`` (number of non-zero elements) is appended only for SPARSE format.
The header self-describes a tensor payload so a flexible stream can change
shape per buffer and a receiver can reconstruct it without negotiated caps.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

from .spec import TensorSpec, dims_to_shape
from .types import DType, MediaType, TensorFormat, TENSOR_RANK_LIMIT

META_MAGIC = 0x545055AA  # "TPU" + marker; differs from the reference's magic
META_VERSION = 1

_BASE_FMT = "<" + "I" * (4 + TENSOR_RANK_LIMIT + 1)  # magic..media_type
_BASE_SIZE = struct.calcsize(_BASE_FMT)
_NNZ_FMT = "<I"
_NNZ_SIZE = struct.calcsize(_NNZ_FMT)


@dataclasses.dataclass
class MetaInfo:
    """Self-describing header of one tensor payload."""

    dtype: DType
    dims: Tuple[int, ...]
    format: TensorFormat = TensorFormat.FLEXIBLE
    media_type: MediaType = MediaType.TENSOR
    nnz: int = 0  # sparse only: number of stored (non-zero) elements
    version: int = META_VERSION

    @classmethod
    def from_spec(cls, spec: TensorSpec,
                  format: TensorFormat = TensorFormat.FLEXIBLE,
                  media_type: MediaType = MediaType.TENSOR,
                  nnz: int = 0) -> "MetaInfo":
        return cls(dtype=spec.dtype, dims=spec.dims, format=format,
                   media_type=media_type, nnz=nnz)

    def to_spec(self, name: Optional[str] = None) -> TensorSpec:
        return TensorSpec(dtype=self.dtype, dims=self.dims, name=name)

    @property
    def shape(self) -> Tuple[int, ...]:
        return dims_to_shape(self.dims)

    @property
    def header_size(self) -> int:
        return header_size(self.format)

    def data_nbytes(self) -> int:
        """Size of the payload that follows the header."""
        if self.format == TensorFormat.SPARSE:
            # values + u32 indices per stored element
            return self.nnz * (self.dtype.size + 4)
        n = 1
        for d in self.dims:
            n *= d
        return n * self.dtype.size

    def pack(self) -> bytes:
        if len(self.dims) > TENSOR_RANK_LIMIT:
            raise ValueError(
                f"rank {len(self.dims)} exceeds {TENSOR_RANK_LIMIT}")
        if any(not (0 < d < 2 ** 32) for d in self.dims):
            raise ValueError(f"dimension out of u32 range: {self.dims}")
        dims16 = list(self.dims) + [0] * (TENSOR_RANK_LIMIT - len(self.dims))
        hdr = struct.pack(
            _BASE_FMT, META_MAGIC, self.version, self.dtype.value, *dims16,
            self.format.value, _media_u32(self.media_type))
        if self.format == TensorFormat.SPARSE:
            hdr += struct.pack(_NNZ_FMT, self.nnz)
        return hdr

    @classmethod
    def unpack(cls, data: bytes) -> "MetaInfo":
        if len(data) < _BASE_SIZE:
            raise ValueError(f"meta header truncated: {len(data)} < {_BASE_SIZE}")
        fields = struct.unpack_from(_BASE_FMT, data)
        magic, version, dtype_v = fields[0], fields[1], fields[2]
        if magic != META_MAGIC:
            raise ValueError(f"bad meta magic: 0x{magic:08x}")
        if not (1 <= version <= META_VERSION):
            raise ValueError(f"unsupported meta version {version}")
        dims16 = fields[3:3 + TENSOR_RANK_LIMIT]
        fmt_v, media_v = fields[3 + TENSOR_RANK_LIMIT], fields[4 + TENSOR_RANK_LIMIT]
        dims = []
        for d in dims16:
            if d == 0:
                break
            dims.append(d)
        fmt = TensorFormat(fmt_v)
        nnz = 0
        if fmt == TensorFormat.SPARSE:
            if len(data) < _BASE_SIZE + _NNZ_SIZE:
                raise ValueError("sparse meta header truncated")
            (nnz,) = struct.unpack_from(_NNZ_FMT, data, _BASE_SIZE)
        return cls(dtype=DType(dtype_v), dims=tuple(dims) or (1,), format=fmt,
                   media_type=_media_from_u32(media_v), nnz=nnz,
                   version=version)


def header_size(format: TensorFormat) -> int:
    """Parity: gst_tensor_meta_info_get_header_size
    (nnstreamer_plugin_api_util_impl.c:1447)."""
    if format == TensorFormat.SPARSE:
        return _BASE_SIZE + _NNZ_SIZE
    return _BASE_SIZE


def _media_u32(m: MediaType) -> int:
    # OCTET is -1 in the enum; store as two's complement u32.
    return m.value & 0xFFFFFFFF


def _media_from_u32(v: int) -> MediaType:
    if v == 0xFFFFFFFF:
        return MediaType.OCTET
    return MediaType(v)
