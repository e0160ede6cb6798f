"""Filter framework registry + auto-detection (counterpart of the JAX
package's ``filters/registry.py``).

Parity target: nnstreamer_filter_probe/find
(nnstreamer:gst/nnstreamer/nnstreamer_subplugin.c:141,225) and
``framework=auto`` detection.  This slice of the port loads no model files,
so auto-detection knows in-process registered models only.
"""

from __future__ import annotations

import threading
from typing import Dict, Type

from .api import FilterSubplugin

_lock = threading.Lock()
_frameworks: Dict[str, Type[FilterSubplugin]] = {}


def register_filter(cls: Type[FilterSubplugin]) -> Type[FilterSubplugin]:
    """Class decorator (parity: nnstreamer_filter_probe self-registration)."""
    if not cls.NAME:
        raise ValueError(f"{cls.__name__} has empty NAME")
    with _lock:
        _frameworks[cls.NAME] = cls
    return cls


def find_filter(name: str) -> Type[FilterSubplugin]:
    _ensure_builtin()
    with _lock:
        try:
            return _frameworks[name]
        except KeyError:
            known = ", ".join(sorted(_frameworks))
            raise KeyError(
                f"no filter framework {name!r}; known: {known}") from None


def list_filters():
    _ensure_builtin()
    with _lock:
        return sorted(_frameworks)


def detect_framework(model) -> str:
    """framework="auto": a name registered with the torch-cuda filter."""
    _ensure_builtin()
    from .torch_cuda import get_model

    if isinstance(model, str) and get_model(model) is not None:
        return "torch-cuda"
    raise ValueError(f"cannot auto-detect framework for model {model!r}")


_builtin_done = False
_builtin_lock = threading.Lock()


def _ensure_builtin() -> None:
    global _builtin_done
    if _builtin_done:
        return
    with _builtin_lock:
        if _builtin_done:
            return
        from . import torch_cuda  # noqa: F401  self-registering

        _builtin_done = True
