"""Tensor core (L1): type system, specs, caps, buffers, meta headers."""

from .types import (
    DType,
    MediaType,
    TensorFormat,
    TensorLayout,
    MIMETYPE_TENSOR,
    MIMETYPE_TENSORS,
    TENSOR_COUNT_LIMIT,
    TENSOR_RANK_LIMIT,
    dtype_range,
)
from .spec import (
    TensorSpec,
    TensorsSpec,
    dims_equal,
    dims_to_shape,
    format_dimension,
    parse_dimension,
    shape_to_dims,
)
from .meta import MetaInfo, header_size, META_MAGIC, META_VERSION
from .buffer import (
    Buffer,
    DonatedTensorError,
    Tensor,
    SECOND,
    MSECOND,
    USECOND,
)
from .caps import ANY, Caps, CapsStruct, Range

__all__ = [
    "DType", "MediaType", "TensorFormat", "TensorLayout",
    "MIMETYPE_TENSOR", "MIMETYPE_TENSORS",
    "TENSOR_COUNT_LIMIT", "TENSOR_RANK_LIMIT", "dtype_range",
    "TensorSpec", "TensorsSpec", "dims_equal", "dims_to_shape",
    "format_dimension", "parse_dimension", "shape_to_dims",
    "MetaInfo", "header_size", "META_MAGIC", "META_VERSION",
    "Buffer", "DonatedTensorError", "Tensor",
    "SECOND", "MSECOND", "USECOND",
    "ANY", "Caps", "CapsStruct", "Range",
]
