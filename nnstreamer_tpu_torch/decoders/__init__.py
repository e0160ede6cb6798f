"""Decoder sub-plugins (L3): tensor streams → media/semantic streams.

Counterpart of the JAX package's ``decoders/__init__.py`` (parity target:
the reference's decoder sub-plugin ABI, init/setOption/getOutCaps/decode
registered under a mode string).  Every mode the JAX package registers
is here: ``bounding_boxes``, ``image_labeling``, ``direct_video``,
``image_segment``, ``pose_estimation``, ``tensor_region``,
``octet_stream``, ``flexbuf``, ``flatbuf``, ``protobuf`` and ``python3``.

The JAX package keeps a bounded cache of jitted helper programs
(``JitFnCache``) for its packed drain and pre-reductions.  The port has
no counterpart: eager torch ops compile nothing, so there is nothing to
cache.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Type

import numpy as np
import torch

from ..core import Buffer, Caps, Tensor, TensorsSpec
from ..obs import transfer as _xfer

_lock = threading.Lock()
_decoders: Dict[str, Type["Decoder"]] = {}


def drain_once(tensors: List[Tensor]) -> List[np.ndarray]:
    """Drain N device-resident tensors with ONE device→host copy; returns
    their host arrays (and seeds each tensor's host cache, so later
    ``.np()`` reads are free).  The tensors' bytes are packed into one
    uint8 tensor on the device, copied once, and split on the host.
    Tensors already host-resident pass through untouched; with one (or
    zero) device tensors the plain ``.np()`` path is already optimal."""
    dev = [t for t in tensors if t.is_device]
    if len(dev) <= 1:
        return [t.np() for t in tensors]
    packed = torch.cat([t.torch().detach().contiguous().reshape(-1)
                        .view(torch.uint8) for t in dev])
    flat = _xfer.to_host(packed).numpy()  # the one device→host copy
    off = 0
    for t in dev:
        n = t.spec.nbytes
        t.seed_host(flat[off:off + n].view(t.spec.dtype.np_dtype))
        off += n
    return [t.np() for t in tensors]


class Decoder:
    """One decode mode (e.g. bounding_boxes)."""

    MODE = ""

    def __init__(self):
        self.options: List[str] = [""] * 9

    def set_option(self, index: int, value: str) -> None:
        """Parity: option1..option9 properties of tensor_decoder."""
        while len(self.options) <= index:
            self.options.append("")
        self.options[index] = value
        self.options_updated()

    def options_updated(self) -> None:
        pass

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        raise NotImplementedError

    def wants_host_input(self) -> bool:
        """Whether decode() reads the input tensors on the host.  True for
        every reference decoder (they are CPU rasterizers); a decoder that
        renders on the device returns False so ``tensor_decoder`` makes no
        device→host copy for it."""
        return True

    def prereduce_active(self, buf: Buffer) -> bool:
        """Whether decode() reduces THIS buffer on its device first (an
        argmax, a top-k, its own packed drain), so only a small result
        crosses to the host.  When true, ``tensor_decoder`` makes no copy
        of its own: copying the whole input would move what the
        reduction discards."""
        return False

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        raise NotImplementedError


def register_decoder(cls: Type[Decoder]) -> Type[Decoder]:
    if not cls.MODE:
        raise ValueError(f"{cls.__name__} has empty MODE")
    with _lock:
        _decoders[cls.MODE] = cls
    return cls


def find_decoder(mode: str) -> Type[Decoder]:
    _ensure_builtin()
    with _lock:
        try:
            return _decoders[mode]
        except KeyError:
            known = ", ".join(sorted(_decoders))
            raise KeyError(
                f"no decoder mode {mode!r}; known: {known}") from None


def list_decoders():
    _ensure_builtin()
    with _lock:
        return sorted(_decoders)


_builtin_done = False
_builtin_lock = threading.Lock()


def _ensure_builtin() -> None:
    global _builtin_done
    if _builtin_done:
        return
    with _builtin_lock:
        if _builtin_done:
            return
        from . import directvideo, imagelabel  # noqa: F401
        for mod in ("boundingbox", "imagesegment", "pose", "tensorregion",
                    "octetstream", "flexbuf", "wirefmt", "python3"):
            __import__(f"{__name__}.{mod}")
        _builtin_done = True
