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

import os as _os

if _os.environ.get("NNS_TPU_TORCH_LOCKDEP", "") in ("1", "true", "on"):
    # the lock-order witness must patch the lock constructors BEFORE
    # the package's modules build their locks (utils/lockdep.py), and
    # after torch is imported: torch's import breaks when its
    # module-level locks are wrapped under _LOCKDEP_SCOPE=all.  A plain
    # environment check keeps the common path free
    import torch as _torch  # noqa: F401

    from .utils import lockdep as _lockdep

    _lockdep.maybe_enable_from_env()

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
