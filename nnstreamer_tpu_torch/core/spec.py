"""Tensor specs: shapes, dtypes, and the dim-string grammar (copied from
the JAX package's ``core/spec.py``).

Parity targets:
- dim string parse/print ``"3:224:224:1"`` —
  nnstreamer:gst/nnstreamer/nnstreamer_plugin_api_util_impl.c:1031
  (``gst_tensor_parse_dimension``) and :529
  (``gst_tensors_info_parse_dimensions_string``).
- rank-flexible dimension comparison (trailing 1s are insignificant) —
  nnstreamer_plugin_api_util_impl.c (``gst_tensor_dimension_is_equal``).

Convention: ``dims`` is stored innermost-first like the reference grammar
(``3:224:224:1`` = channel:width:height:batch), while ``shape`` is the
reversed, rank-trimmed tuple handed to PyTorch/numpy (batch, height, width,
channel).  All device math uses ``shape``; all wire/config text uses ``dims``.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Iterable, Optional, Sequence, Tuple

from .types import (
    DType,
    TensorFormat,
    TENSOR_COUNT_LIMIT,
    TENSOR_RANK_LIMIT,
)


def split_tensor_list(v: str) -> list:
    """Split a multi-tensor dims/types list into per-tensor strings.
    Both tensor separators are accepted: "," (property grammar) and "."
    (caps-string grammar, where "," already separates caps fields —
    reference caps use ``dimensions=(string)1:1:784:1.1:1:10:1``)."""
    return [d for d in v.replace(".", ",").split(",") if d.strip()]


def parse_dimension(dim_str: str) -> Tuple[int, ...]:
    """Parse ``"3:224:224:1"`` into an innermost-first dim tuple.

    Rank is the number of specified components (≤16).  A trailing component of
    0 terminates the dimension (reference uses 0 as "rank end" marker).
    """
    parts = dim_str.strip().split(":")
    if len(parts) > TENSOR_RANK_LIMIT:
        raise ValueError(
            f"dimension rank {len(parts)} exceeds limit {TENSOR_RANK_LIMIT}: {dim_str!r}"
        )
    dims = []
    for p in parts:
        p = p.strip()
        if p in ("", "0"):
            break
        v = int(p)
        if v < 0:
            raise ValueError(f"negative dimension in {dim_str!r}")
        dims.append(v)
    if not dims:
        raise ValueError(f"empty dimension string: {dim_str!r}")
    return tuple(dims)


def format_dimension(dims: Sequence[int]) -> str:
    return ":".join(str(d) for d in dims)


def dims_equal(a: Sequence[int], b: Sequence[int]) -> bool:
    """Rank-flexible comparison: trailing 1s are insignificant."""
    n = max(len(a), len(b))
    for i in range(n):
        da = a[i] if i < len(a) else 1
        db = b[i] if i < len(b) else 1
        if da != db:
            return False
    return True


def dims_to_shape(dims: Sequence[int]) -> Tuple[int, ...]:
    """Innermost-first dims → numpy/PyTorch row-major shape."""
    return tuple(reversed(dims))


def shape_to_dims(shape: Sequence[int]) -> Tuple[int, ...]:
    if len(shape) == 0:
        return (1,)
    return tuple(reversed(shape))


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One tensor's static schema (parity: GstTensorInfo,
    tensor_typedef.h:261-268)."""

    dtype: DType
    dims: Tuple[int, ...]
    name: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        if len(self.dims) > TENSOR_RANK_LIMIT:
            raise ValueError(f"rank {len(self.dims)} exceeds {TENSOR_RANK_LIMIT}")
        if any(d <= 0 for d in self.dims):
            raise ValueError(f"non-positive dimension: {self.dims}")

    @classmethod
    def from_shape(cls, shape: Sequence[int], dtype, name: Optional[str] = None
                   ) -> "TensorSpec":
        if not isinstance(dtype, DType):
            dtype = DType.from_np(dtype) if not isinstance(dtype, str) \
                else DType.from_string(dtype)
        return cls(dtype=dtype, dims=shape_to_dims(shape), name=name)

    @classmethod
    def parse(cls, dim_str: str, type_str: str, name: Optional[str] = None
              ) -> "TensorSpec":
        return cls(dtype=DType.from_string(type_str),
                   dims=parse_dimension(dim_str), name=name)

    @property
    def shape(self) -> Tuple[int, ...]:
        return dims_to_shape(self.dims)

    @property
    def rank(self) -> int:
        return len(self.dims)

    @property
    def num_elements(self) -> int:
        return math.prod(self.dims)

    @property
    def nbytes(self) -> int:
        return self.num_elements * self.dtype.size

    def dim_string(self) -> str:
        return format_dimension(self.dims)

    def is_compatible(self, other: "TensorSpec") -> bool:
        """dtype match + rank-flexible dim match (ignores name)."""
        return self.dtype == other.dtype and dims_equal(self.dims, other.dims)

    def with_dims(self, dims: Sequence[int]) -> "TensorSpec":
        return dataclasses.replace(self, dims=tuple(dims))

    def with_dtype(self, dtype: DType) -> "TensorSpec":
        return dataclasses.replace(self, dtype=dtype)

    def __str__(self) -> str:
        n = f" name={self.name}" if self.name else ""
        return f"{self.dim_string()}/{self.dtype}{n}"


@dataclasses.dataclass(frozen=True)
class TensorsSpec:
    """Schema of one stream frame: N tensors + format + framerate.

    Parity: GstTensorsInfo + GstTensorsConfig (tensor_typedef.h:273-296).
    Framerate is an exact fraction; rate 0/1 means "unknown/any" as in the
    reference's ``[0, max]`` fraction range.
    """

    tensors: Tuple[TensorSpec, ...] = ()
    format: TensorFormat = TensorFormat.STATIC
    rate: Fraction = Fraction(0, 1)

    def __post_init__(self):
        object.__setattr__(self, "tensors", tuple(self.tensors))
        if len(self.tensors) > TENSOR_COUNT_LIMIT:
            raise ValueError(
                f"{len(self.tensors)} tensors exceeds limit {TENSOR_COUNT_LIMIT}")
        if not isinstance(self.rate, Fraction):
            object.__setattr__(self, "rate", Fraction(self.rate))

    # -- construction -------------------------------------------------------

    @classmethod
    def parse(cls, dimensions: str, types: str,
              format: str = "static", rate=None) -> "TensorsSpec":
        """Parse dims/types lists (parity:
        gst_tensors_info_parse_dimensions_string,
        nnstreamer_plugin_api_util_impl.c:529); see
        :func:`split_tensor_list` for the separator grammar."""
        dim_list = split_tensor_list(dimensions)
        type_list = split_tensor_list(types)
        if len(dim_list) != len(type_list):
            raise ValueError(
                f"dims count {len(dim_list)} != types count {len(type_list)}")
        tensors = tuple(
            TensorSpec.parse(d, t) for d, t in zip(dim_list, type_list))
        return cls(tensors=tensors, format=TensorFormat.from_string(format),
                   rate=Fraction(rate) if rate is not None else Fraction(0, 1))

    @classmethod
    def of(cls, *specs: TensorSpec, format=TensorFormat.STATIC,
           rate=Fraction(0, 1)) -> "TensorsSpec":
        return cls(tensors=tuple(specs), format=format, rate=Fraction(rate))

    @classmethod
    def from_shapes(cls, shapes: Iterable[Sequence[int]], dtypes,
                    rate=Fraction(0, 1)) -> "TensorsSpec":
        shapes = list(shapes)
        if not isinstance(dtypes, (list, tuple)):
            dtypes = [dtypes] * len(shapes)
        if len(dtypes) != len(shapes):
            raise ValueError(
                f"{len(shapes)} shapes but {len(dtypes)} dtypes")
        return cls(tensors=tuple(
            TensorSpec.from_shape(s, d) for s, d in zip(shapes, dtypes)),
            rate=Fraction(rate))

    # -- accessors ----------------------------------------------------------

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def __len__(self) -> int:
        return len(self.tensors)

    def __getitem__(self, i: int) -> TensorSpec:
        return self.tensors[i]

    def dimensions_string(self, sep: str = ",") -> str:
        return sep.join(t.dim_string() for t in self.tensors)

    def types_string(self, sep: str = ",") -> str:
        return sep.join(str(t.dtype) for t in self.tensors)

    @property
    def frame_nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors)

    def is_static(self) -> bool:
        return self.format == TensorFormat.STATIC

    def is_compatible(self, other: "TensorsSpec") -> bool:
        """Frame-level compatibility: same format; for static streams, same
        tensor count and per-tensor compatibility. Flexible/sparse streams
        accept any payload schema (the schema travels per-buffer in meta)."""
        if self.format != other.format:
            return False
        if self.format != TensorFormat.STATIC:
            return True
        if len(self.tensors) != len(other.tensors):
            return False
        return all(a.is_compatible(b)
                   for a, b in zip(self.tensors, other.tensors))

    def with_rate(self, rate) -> "TensorsSpec":
        return dataclasses.replace(self, rate=Fraction(rate))

    def with_tensors(self, tensors: Iterable[TensorSpec]) -> "TensorsSpec":
        return dataclasses.replace(self, tensors=tuple(tensors))

    def with_format(self, format: TensorFormat) -> "TensorsSpec":
        return dataclasses.replace(self, format=format)

    def __str__(self) -> str:
        body = ",".join(str(t) for t in self.tensors)
        r = f"@{self.rate}" if self.rate else ""
        return f"tensors[{self.format}]({body}){r}"
