"""``tensorflow-lite`` filter framework: .tflite files imported into PyTorch.

Counterpart of the JAX package's ``filters/tflite.py`` (parity target:
the reference's flagship sub-plugin, tensor_filter_tensorflow_lite.cc —
TFLiteInterpreter/TFLiteCore).  The model file is *imported* rather than
interpreted (filters/tflite_import.py): the graph becomes one PyTorch
function that runs on the ``torch-cuda`` machinery — the fused transform
prologue, ``is-updatable`` hot reload, ``share-model`` pooling and
``mesh=`` placement.

``custom=qmode:<auto|bf16|dequant|float>``; ``auto`` (the default) runs a
quantized graph in ``bf16``, which rounds real values to bf16 and so is
approximate — ``dequant`` is the exact integer mode.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..core import TensorsSpec
from .api import FilterError
from .registry import register_filter
from .torch_cuda import ModelDef, TorchCudaFilter


@register_filter
class TFLiteFilter(TorchCudaFilter):
    NAME = "tensorflow-lite"

    def _load_file(self, path: str) -> ModelDef:
        ext = os.path.splitext(path)[1].lower()
        if ext != ".tflite":
            return super()._load_file(path)
        from .importer_util import parse_custom_prop
        from .tflite_import import TFLiteModel, build_fn

        qmode = parse_custom_prop(self.props.custom, "qmode", "auto")
        try:
            fn, weights, in_shape, in_dtype = build_fn(TFLiteModel(path),
                                                       qmode=qmode)
        except (ValueError, NotImplementedError, IndexError, KeyError,
                struct.error) as e:
            raise FilterError(f"tensorflow-lite: {path}: {e}") from e
        in_spec = TensorsSpec.from_shapes([in_shape], np.dtype(in_dtype))
        return ModelDef(fn, weights, in_spec, name=path)


@register_filter
class TFLite2Filter(TFLiteFilter):
    """Alias: the reference registers both tensorflow-lite and
    tensorflow2-lite names for the same engine."""

    NAME = "tensorflow2-lite"
