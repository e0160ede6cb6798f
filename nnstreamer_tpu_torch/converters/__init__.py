"""External converter sub-plugins (L3).

Counterpart of the JAX package's ``converters/__init__.py`` (parity
target: the reference's ``NNStreamerExternalConverter`` ABI,
``query_caps``/``get_out_config``/``convert``, keyed by mimetype).

Built-ins (registered on import, from ``wirefmt.py``): ``flexbuf``
(other/flexbuf, FlexBuffers map), ``flatbuf`` (other/flatbuf-tensor,
FlatBuffers ``Tensors`` table), ``protobuf`` (other/protobuf-tensor,
proto3 wire) — codecs in ``codecs.py``.  User converters:
``register_custom`` callables (the reference's
``nnstreamer_converter_custom_register``) and ``python3`` script classes
(``python3.py``), both reached through ``tensor_converter``'s
``mode=custom-code:NAME`` / ``mode=custom-script:FILE.py`` property.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ..core import Buffer, CapsStruct, TensorsSpec

_lock = threading.Lock()
_converters: Dict[str, "ExternalConverter"] = {}
_custom: Dict[str, Callable[[Buffer], Buffer]] = {}


class ExternalConverter:
    """Sub-plugin converting foreign-mimetype payloads into tensor buffers."""

    NAME = ""
    MIMES: tuple = ()

    def get_out_config(self, caps: CapsStruct) -> TensorsSpec:
        raise NotImplementedError

    def convert(self, buf: Buffer, caps: CapsStruct) -> Buffer:
        raise NotImplementedError


def register_converter(conv) -> "ExternalConverter":
    """Register a converter sub-plugin (class or instance) by mime + name."""
    inst = conv() if isinstance(conv, type) else conv
    with _lock:
        for m in inst.MIMES:
            _converters[m] = inst
        if inst.NAME:
            _converters[inst.NAME] = inst
    return conv


def find_converter(mime_or_name: str) -> Optional["ExternalConverter"]:
    with _lock:
        return _converters.get(mime_or_name)


def list_converters():
    with _lock:
        return sorted({c.NAME for c in _converters.values()})


def registered_mimes():
    """All mimetypes any registered converter sub-plugin accepts."""
    with _lock:
        return sorted({m for c in _converters.values() for m in c.MIMES})


def register_custom(name: str, fn: Callable[[Buffer], Buffer]) -> None:
    """Register a callable as a ``mode=custom-code:name`` converter.

    Parity: the reference's ``nnstreamer_converter_custom_register``.
    ``fn(buf) -> Buffer`` receives the raw
    input buffer and returns the converted tensor buffer.
    """
    with _lock:
        _custom[name] = fn


def unregister_custom(name: str) -> bool:
    with _lock:
        return _custom.pop(name, None) is not None


def find_custom(name: str) -> Optional[Callable[[Buffer], Buffer]]:
    with _lock:
        return _custom.get(name)


from . import wirefmt  # noqa: E402,F401  (registers flexbuf/flatbuf/protobuf)
from .python3 import Python3Converter  # noqa: E402,F401
