"""Hand-written CUDA kernels for the port's hot ops.

Every kernel has a plain PyTorch version beside it; the wrapper takes the
plain version only for a CPU tensor and launches the kernel (or raises)
for a CUDA tensor.  ``build`` compiles the kernels' sources with nvcc.
"""

from .kernels import (
    flash_attention,
    flash_attention_available,
    flash_attention_reference,
    layer_norm,
    layer_norm_available,
    layer_norm_reference,
    scale_bias_cast,
    scale_bias_cast_available,
    scale_bias_cast_reference,
)

__all__ = [
    "flash_attention", "flash_attention_available",
    "flash_attention_reference",
    "layer_norm", "layer_norm_available", "layer_norm_reference",
    "scale_bias_cast", "scale_bias_cast_available",
    "scale_bias_cast_reference",
]
