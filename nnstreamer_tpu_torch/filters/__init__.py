"""Filter sub-plugin layer (L2/L3): ABI, registry, the torch-cuda framework."""

from .api import FilterError, FilterProps, FilterSubplugin
from .registry import (
    detect_framework,
    find_filter,
    list_filters,
    register_filter,
)
from .torch_cuda import TorchCudaFilter, register_model, unregister_model

__all__ = [
    "FilterError", "FilterProps", "FilterSubplugin",
    "detect_framework", "find_filter", "list_filters", "register_filter",
    "TorchCudaFilter", "register_model", "unregister_model",
]
