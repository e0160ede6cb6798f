"""``python3`` converter sub-plugin: user script → tensors.

Counterpart of the JAX package's ``converters/python3.py`` (parity
target: the reference's tensor_converter_python3.cc and the script
contract of its custom_converter.py): the script defines a class
``CustomConverter`` whose ``convert(input_arrays)`` receives the raw
input payload(s) as numpy arrays and returns the converted tensors.

Accepted return shapes (most to least structured):
- a :class:`~nnstreamer_tpu_torch.core.Buffer`;
- a list of numpy arrays (specs inferred from dtype/shape);
- the reference 4-tuple ``(tensors_info, raw_data, rate_n, rate_d)``
  where each ``tensors_info[i]`` is ``(dims, np_dtype)`` (nnstreamer
  innermost-first dims) and ``raw_data[i]`` a uint8 payload array.

Reached through ``tensor_converter mode=custom-script:FILE.py``.
"""

from __future__ import annotations

import importlib.util
import os
from fractions import Fraction
from typing import List

import numpy as np

from ..core import (
    Buffer,
    CapsStruct,
    DType,
    Tensor,
    TensorFormat,
    TensorSpec,
    TensorsSpec,
    dims_to_shape,
)
from . import ExternalConverter


def _load_script(path: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"python3 converter script not found: {path}")
    name = "nns_torch_conv_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "CustomConverter"):
        raise AttributeError(
            f"{path}: script must define class CustomConverter")
    return mod.CustomConverter()


class Python3Converter(ExternalConverter):
    NAME = "python3"

    def __init__(self, script: str):
        self._obj = _load_script(script)
        self._script = script

    def get_out_config(self, caps: CapsStruct) -> TensorsSpec:
        if hasattr(self._obj, "get_out_config"):
            return self._obj.get_out_config(caps)
        rate = caps.get("framerate", None) if caps is not None else None
        return TensorsSpec(format=TensorFormat.FLEXIBLE,
                           rate=rate or Fraction(0, 1))

    def convert(self, buf: Buffer, caps: CapsStruct) -> Buffer:
        # scripts always see flat uint8 payload views (parity: the
        # reference's tensor_converter_python3.cc passes 1-D uint8 arrays)
        arrays = [np.frombuffer(t.tobytes(), np.uint8) for t in buf.tensors]
        res = self._obj.convert(arrays)
        out = self._coerce(res)
        out.pts, out.duration = buf.pts, buf.duration
        out.meta.update(buf.meta)
        return out

    @staticmethod
    def _coerce(res) -> Buffer:
        if isinstance(res, Buffer):
            return res
        if isinstance(res, (list, tuple)) and len(res) == 4 \
                and isinstance(res[2], int):
            infos, raw, rate_n, rate_d = res
            tensors: List[Tensor] = []
            for info, payload in zip(infos, raw):
                dims, np_dt = (info if isinstance(info, (tuple, list))
                               else (info.dims, info.dtype))
                dt = DType.from_np(np.dtype(np_dt))
                shape = dims_to_shape(dims)
                arr = np.frombuffer(
                    np.ascontiguousarray(payload).tobytes(),
                    dtype=dt.np_dtype).reshape(shape)
                tensors.append(Tensor(arr, TensorSpec.from_shape(shape, dt)))
            return Buffer(tensors=tensors, format=TensorFormat.FLEXIBLE)
        if isinstance(res, (list, tuple)):
            return Buffer.of(*[np.asarray(a) for a in res])
        raise TypeError(
            "CustomConverter.convert must return Buffer, list of arrays, "
            "or (tensors_info, raw_data, rate_n, rate_d)")
