"""``tensorflow`` filter framework: frozen .pb graphs imported into PyTorch.

Counterpart of the JAX package's ``filters/tensorflow.py`` (parity
target: the reference's tensorflow sub-plugin, tensor_filter_tensorflow.cc
— a TF C-API session over a frozen GraphDef).  The graph is *imported*
(filters/tf_import.py): a hand-rolled protobuf walk rebuilds the network
as one PyTorch function, so frozen classifiers and the speech-command
graph (DecodeWav → AudioSpectrogram → Mfcc → convnet) run on the card
with no TF runtime, on the ``torch-cuda`` machinery.  DecodeWav becomes a
host-side container parse
(:func:`nnstreamer_tpu_torch.filters.tf_import.decode_wav_bytes`); the
function starts at PCM.
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
class TensorFlowFilter(TorchCudaFilter):
    NAME = "tensorflow"

    def _load_file(self, path: str) -> ModelDef:
        ext = os.path.splitext(path)[1].lower()
        if ext != ".pb":
            return super()._load_file(path)
        from .tf_import import TFGraph, build_fn

        try:
            fn, weights, in_shape, in_dtype = build_fn(TFGraph(path))
        except (ValueError, NotImplementedError, IndexError, KeyError,
                struct.error) as e:
            raise FilterError(f"tensorflow: {path}: {e}") from e
        in_spec = None
        if in_shape is not None:
            in_spec = TensorsSpec.from_shapes([in_shape],
                                              np.dtype(in_dtype))
        return ModelDef(fn, weights, in_spec, name=path)


@register_filter
class TensorFlow2Filter(TensorFlowFilter):
    """Alias (the reference registers tensorflow2-savedmodel separately;
    frozen-graph import is the shared core)."""

    NAME = "tensorflow2"
