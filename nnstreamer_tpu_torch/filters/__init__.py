"""Filter sub-plugin layer (L2/L3): ABI, registry, frameworks (torch-cuda,
pytorch, custom-easy/custom, python3, and the model-file importers onnx,
tensorflow-lite and tensorflow, which the registry loads on first use)."""

from .api import FilterError, FilterProps, FilterSubplugin
from .registry import (
    detect_framework,
    find_filter,
    list_filters,
    register_filter,
)
from .torch_cuda import TorchCudaFilter, register_model, unregister_model
from .custom import (
    CustomEasyFilter,
    Python3Filter,
    register_custom_easy,
    unregister_custom_easy,
)
from .pytorch import PyTorchFilter

__all__ = [
    "FilterError", "FilterProps", "FilterSubplugin",
    "detect_framework", "find_filter", "list_filters", "register_filter",
    "TorchCudaFilter", "register_model", "unregister_model",
    "CustomEasyFilter", "Python3Filter", "register_custom_easy",
    "unregister_custom_easy", "PyTorchFilter",
]
