"""Element factory registry (near-copy of the JAX package's
``runtime/registry.py``).

Parity target: the reference's name→factory table
(nnstreamer:gst/nnstreamer/nnstreamer_subplugin.c:225, registerer/
nnstreamer.c:92-124).  Discovery imports the port's built-in element
modules once, lazily, on the first factory lookup.
"""

from __future__ import annotations

import importlib
import logging
import threading
from typing import Callable, Dict, Optional, Type

from .element import Element

_lock = threading.Lock()
_scan_lock = threading.Lock()  # held across the builtin imports
_factories: Dict[str, Type[Element]] = {}
_scanned = False


def register_element(name: Optional[str] = None) -> Callable:
    """Class decorator: ``@register_element("tensor_transform")``."""

    def deco(cls: Type[Element]) -> Type[Element]:
        fname = name or cls.FACTORY
        if not fname:
            raise ValueError(f"{cls.__name__} has no factory name")
        cls.FACTORY = fname
        with _lock:
            _factories[fname] = cls
        return cls

    return deco


def element_factory(name: str) -> Type[Element]:
    _ensure_scanned()
    with _lock:
        try:
            return _factories[name]
        except KeyError:
            known = ", ".join(sorted(_factories))
            raise KeyError(
                f"no element factory {name!r}; known: {known}") from None


def make(name: str, el_name: Optional[str] = None, **props) -> Element:
    """Parity: gst_element_factory_make."""
    return element_factory(name)(name=el_name, **props)


def list_elements():
    _ensure_scanned()
    with _lock:
        return sorted(_factories)


_BUILTIN_MODULES = [
    "nnstreamer_tpu_torch.elements",
    "nnstreamer_tpu_torch.filters",
    "nnstreamer_tpu_torch.decoders",
    "nnstreamer_tpu_torch.edge",
]


def _ensure_scanned() -> None:
    """Lazy one-shot import of the built-in element modules plus any
    extra modules configured through ``utils/conf.py``
    (``NNS_TPU_TORCH_COMMON_PLUGINS``)."""
    global _scanned
    if _scanned:
        return
    # Concurrent callers block here until the import pass completes; the
    # flag is only set on success so a failed pass retries next call.
    with _scan_lock:
        if _scanned:
            return
        from ..utils.conf import get_conf

        for m in _BUILTIN_MODULES + get_conf().extra_plugin_modules:
            try:
                # nns-lint: disable=NNS303 -- intentional: concurrent
                # factory lookups must block until the one-shot builtin
                # import pass completes, or they'd see a partial registry
                importlib.import_module(m)
            except ImportError as e:
                # built-ins must import; configured extras may be absent
                if m in _BUILTIN_MODULES:
                    raise
                logging.getLogger("nnstreamer_tpu_torch").warning(
                    "plugin module %s failed to import: %s", m, e)
        _scanned = True
