"""Filter framework registry + auto-detection (counterpart of the JAX
package's ``filters/registry.py``).

Parity target: nnstreamer_filter_probe/find
(nnstreamer:gst/nnstreamer/nnstreamer_subplugin.c:141,225) and
``framework=auto`` detection from a model file's extension with the
conf-driven priority (gst_tensor_filter_detect_framework).
"""

from __future__ import annotations

import os
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
    """framework="auto": a callable (``custom-easy``); a model file by its
    extension, the candidates ordered by ``utils/conf.py``'s
    ``framework_priority_<ext>`` (a file of a type the torch-cuda filter
    refuses goes to it, which names the format); else a name registered
    with the torch-cuda filter or as a custom-easy model."""
    _ensure_builtin()
    from ..utils.conf import get_conf
    from .custom import easy_model_registered
    from .modeluri import resolve_model_uri
    from .torch_cuda import XLA_PROGRAM_TYPES, get_model

    if callable(model):
        return "custom-easy"
    if isinstance(model, str) and get_model(model) is not None:
        return "torch-cuda"
    try:
        path = resolve_model_uri(model)
    except (ValueError, KeyError):
        path = None
    if isinstance(path, (str, os.PathLike)):
        ext = os.path.splitext(str(path))[1].lower()
        candidates = get_conf().framework_priority(ext)
        if not candidates and ext in (XLA_PROGRAM_TYPES + (".msgpack",)):
            candidates = ["torch-cuda"]   # which refuses, naming the format
        with _lock:
            for c in candidates:
                if c in _frameworks:
                    return c
    if isinstance(model, str) and easy_model_registered(model):
        return "custom-easy"
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
        from . import custom, pytorch, torch_cuda  # noqa: F401

        _builtin_done = True
