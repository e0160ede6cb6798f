"""nnstreamer_tpu_torch — the PyTorch/CUDA port of ``nnstreamer_tpu``.

The same streaming-inference pipeline framework (typed tensor streams, a
dataflow runtime with caps negotiation, a filter sub-plugin layer, decoders)
written in PyTorch for an NVIDIA H100.  Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas becomes a kernel written by hand for
Hopper (``ops/``).  Module names and layout follow the JAX package, so each
module has a counterpart there.  Entry points (``Pipeline``,
``parse_launch``) run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from .core import (  # noqa: F401
    Buffer,
    Caps,
    CapsStruct,
    DType,
    MediaType,
    MetaInfo,
    Tensor,
    TensorFormat,
    TensorSpec,
    TensorsSpec,
)
