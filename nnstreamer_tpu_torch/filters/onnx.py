"""``onnx`` filter framework: .onnx files imported into PyTorch.

Counterpart of the JAX package's ``filters/onnx.py`` (parity target: the
reference's onnxruntime sub-plugin, which registers framework
"onnxruntime"; its test drives the in-tree mobilenet_v2_quant.onnx to the
label "orange").  The model file is *imported* rather than run through
ORT (filters/onnx_import.py): the graph, its QLinear quantized operator
set included, becomes one PyTorch function with uint8-resident weights
that runs on the ``torch-cuda`` machinery — the fused transform
prologue, ``is-updatable`` hot reload, ``share-model`` pooling and
``mesh=`` placement.

``custom=qmode:<bf16|dequant|int8|float>`` selects the quantized
execution mode (onnx_import module doc); ``bf16`` is the default.
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
class OnnxFilter(TorchCudaFilter):
    NAME = "onnx"

    def _load_file(self, path: str) -> ModelDef:
        ext = os.path.splitext(path)[1].lower()
        if ext != ".onnx":
            return super()._load_file(path)
        from .importer_util import parse_custom_prop
        from .onnx_import import OnnxModel, build_fn

        qmode = parse_custom_prop(self.props.custom, "qmode", "bf16")
        try:
            fn, weights, in_shape, in_dtype = build_fn(
                OnnxModel(path), qmode=qmode)
        except (ValueError, NotImplementedError, IndexError, KeyError,
                struct.error) as e:
            raise FilterError(f"onnx: {path}: {e}") from e
        in_spec = TensorsSpec.from_shapes([in_shape], np.dtype(in_dtype))
        # weights ride as params (placed on the device once per device),
        # not as constants of the function
        return ModelDef(fn, weights, in_spec, name=path)


@register_filter
class OnnxRuntimeAlias(OnnxFilter):
    """Alias: the reference's framework name for the same engine, so
    reference pipeline strings run unchanged."""

    NAME = "onnxruntime"
