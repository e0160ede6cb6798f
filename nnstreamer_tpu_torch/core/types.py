"""Tensor type system (copied from the JAX package's ``core/types.py``).

11 element dtypes of the reference, rank limit 16, up to 256 tensors per
frame, three stream formats (static / flexible / sparse), NHWC/NCHW layout
tags, plus ``bfloat16`` appended past the reference's range.

Changed for PyTorch: every dtype maps onto a ``torch.dtype``
(:attr:`DType.torch_dtype`), and the numpy bfloat16 type (which needs
``ml_dtypes``) is imported only when a host numpy bf16 array is really
built (:attr:`DType.np_dtype` of ``BFLOAT16``).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

# Limits — parity with tensor_typedef.h:33-57.
TENSOR_RANK_LIMIT = 16
TENSOR_COUNT_LIMIT = 256
TENSOR_MEMORY_MAX = 16

MIMETYPE_TENSOR = "other/tensor"
MIMETYPE_TENSORS = "other/tensors"


class DType(enum.Enum):
    """Element types of a tensor stream (tensor_typedef.h:138-153).

    Values keep the reference's enum ordering so serialized meta headers are
    cross-readable; BFLOAT16 is appended past the reference's range.
    """

    INT32 = 0
    UINT32 = 1
    INT16 = 2
    UINT16 = 3
    INT8 = 4
    UINT8 = 5
    FLOAT64 = 6
    FLOAT32 = 7
    INT64 = 8
    UINT64 = 9
    FLOAT16 = 10
    BFLOAT16 = 32

    @property
    def np_dtype(self) -> np.dtype:
        if self is DType.BFLOAT16:
            return _bfloat16_np()
        return _NP_DTYPES[self]

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self]

    @property
    def size(self) -> int:
        """Bytes per element."""
        return _SIZES[self]

    @classmethod
    def from_string(cls, s: str) -> "DType":
        try:
            return _STR_TO_DTYPE[s.strip().lower()]
        except KeyError:
            raise ValueError(f"unknown tensor dtype string: {s!r}") from None

    @classmethod
    def from_np(cls, dt) -> "DType":
        if getattr(dt, "name", None) == "bfloat16" or \
                (isinstance(dt, str) and dt.strip().lower() == "bfloat16"):
            return cls.BFLOAT16
        dt = np.dtype(dt)
        for k, v in _NP_DTYPES.items():
            if v == dt:
                return k
        raise ValueError(f"unsupported numpy dtype: {dt!r}")

    @classmethod
    def from_torch(cls, dt: torch.dtype) -> "DType":
        for k, v in _TORCH_DTYPES.items():
            if v == dt:
                return k
        raise ValueError(f"unsupported torch dtype: {dt!r}")

    def __str__(self) -> str:
        return _DTYPE_TO_STR[self]


def _bfloat16_np() -> np.dtype:
    # numpy has no bfloat16: ml_dtypes provides it.  If it is absent,
    # fail loudly rather than alias bfloat16 to another dtype (which
    # would corrupt wire headers that claim 2-byte elements).
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16)


_NP_DTYPES = {
    DType.INT32: np.dtype(np.int32),
    DType.UINT32: np.dtype(np.uint32),
    DType.INT16: np.dtype(np.int16),
    DType.UINT16: np.dtype(np.uint16),
    DType.INT8: np.dtype(np.int8),
    DType.UINT8: np.dtype(np.uint8),
    DType.FLOAT64: np.dtype(np.float64),
    DType.FLOAT32: np.dtype(np.float32),
    DType.INT64: np.dtype(np.int64),
    DType.UINT64: np.dtype(np.uint64),
    DType.FLOAT16: np.dtype(np.float16),
}

_TORCH_DTYPES = {
    DType.INT32: torch.int32,
    DType.UINT32: torch.uint32,
    DType.INT16: torch.int16,
    DType.UINT16: torch.uint16,
    DType.INT8: torch.int8,
    DType.UINT8: torch.uint8,
    DType.FLOAT64: torch.float64,
    DType.FLOAT32: torch.float32,
    DType.INT64: torch.int64,
    DType.UINT64: torch.uint64,
    DType.FLOAT16: torch.float16,
    DType.BFLOAT16: torch.bfloat16,
}

_SIZES = {d: (2 if d is DType.BFLOAT16 else _NP_DTYPES[d].itemsize)
          for d in DType}

_DTYPE_TO_STR = {
    DType.INT32: "int32",
    DType.UINT32: "uint32",
    DType.INT16: "int16",
    DType.UINT16: "uint16",
    DType.INT8: "int8",
    DType.UINT8: "uint8",
    DType.FLOAT64: "float64",
    DType.FLOAT32: "float32",
    DType.INT64: "int64",
    DType.UINT64: "uint64",
    DType.FLOAT16: "float16",
    DType.BFLOAT16: "bfloat16",
}
_STR_TO_DTYPE = {v: k for k, v in _DTYPE_TO_STR.items()}


class TensorFormat(enum.Enum):
    """Data format of a tensor stream (tensor_typedef.h:158-166)."""

    STATIC = 0
    FLEXIBLE = 1
    SPARSE = 2

    @classmethod
    def from_string(cls, s: str) -> "TensorFormat":
        try:
            return cls[s.strip().upper()]
        except KeyError:
            raise ValueError(f"unknown tensor format: {s!r}") from None

    def __str__(self) -> str:
        return self.name.lower()


class TensorLayout(enum.Enum):
    """Memory layout hint (tensor_typedef.h:188-196)."""

    ANY = 0
    NHWC = 1
    NCHW = 2
    NONE = 3

    def __str__(self) -> str:
        return self.name.lower()


class MediaType(enum.Enum):
    """Source media type carried in flexible-tensor meta
    (tensor_typedef.h:171-183)."""

    OCTET = -1
    TENSOR = 0
    VIDEO = 1
    AUDIO = 2
    TEXT = 3

    @classmethod
    def from_mime(cls, mime: str) -> "MediaType":
        return _MIME_TO_MEDIA.get(mime, cls.OCTET)


_MIME_TO_MEDIA = {
    MIMETYPE_TENSOR: MediaType.TENSOR,
    MIMETYPE_TENSORS: MediaType.TENSOR,
    "video/x-raw": MediaType.VIDEO,
    "audio/x-raw": MediaType.AUDIO,
    "text/x-raw": MediaType.TEXT,
    "application/octet-stream": MediaType.OCTET,
}


def dtype_range(dtype: DType) -> Optional[tuple]:
    """(min, max) representable values for integer dtypes, None for floats."""
    if dtype is DType.BFLOAT16:
        return None
    np_dt = dtype.np_dtype
    if np_dt.kind in "iu":
        info = np.iinfo(np_dt)
        return (info.min, info.max)
    return None
