"""``python3`` decoder: user script serializes tensors however it wants.

Counterpart of the JAX package's ``decoders/python3.py`` (parity target:
the reference's tensordec-python3.cc and the script contract of its
custom_decoder.py): the script defines class ``CustomDecoder`` with

- ``getOutCaps() -> str|bytes`` — the output mimetype / caps string;
- ``decode(raw_data, in_info, rate_n, rate_d) -> bytes`` — serialize the
  frame; ``raw_data`` is a list of per-tensor uint8 payload arrays and
  ``in_info`` a list of info objects exposing ``dims`` (innermost-first)
  and ``np_dtype`` (plus reference-style ``getDims()``/``getType()``).

Usage: ``tensor_decoder mode=python3 option1=FILE.py``.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Optional

import numpy as np

from ..core import (
    Buffer,
    Caps,
    CapsStruct,
    Tensor,
    TensorSpec,
    TensorsSpec,
)
from . import Decoder, register_decoder


class _TensorInfoView:
    """Per-tensor schema handed to the user script."""

    def __init__(self, spec: TensorSpec):
        self.dims = list(spec.dims)
        self.np_dtype = spec.dtype.np_dtype
        self.type_value = int(spec.dtype.value)

    # reference-style accessors (custom_decoder.py calls these)
    def getDims(self):
        return list(self.dims)

    def getType(self):
        return self.np_dtype


def _load_script(path: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"python3 decoder script not found: {path}")
    name = "nns_torch_dec_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "CustomDecoder"):
        raise AttributeError(f"{path}: script must define class CustomDecoder")
    return mod.CustomDecoder()


@register_decoder
class Python3Decoder(Decoder):
    MODE = "python3"

    def __init__(self):
        super().__init__()
        self._obj = None

    def options_updated(self) -> None:
        path = self.options[0]
        if path:
            self._obj = _load_script(path)

    def _require(self):
        if self._obj is None:
            raise RuntimeError(
                "python3 decoder needs option1=<script.py>")
        return self._obj

    def out_caps(self, in_spec: TensorsSpec) -> Caps:
        caps = self._require().getOutCaps()
        if isinstance(caps, bytes):
            caps = caps.decode()
        if "," in caps or "=" in caps:
            from ..runtime.parser import parse_caps_string

            return parse_caps_string(caps)
        return Caps.new(CapsStruct.make(caps, framerate=in_spec.rate))

    def decode(self, buf: Buffer, in_spec: Optional[TensorsSpec]) -> Buffer:
        obj = self._require()
        raw = [np.frombuffer(t.tobytes(), np.uint8) for t in buf.tensors]
        infos = [_TensorInfoView(t.spec) for t in buf.tensors]
        rate = in_spec.rate if in_spec is not None and in_spec.rate else None
        rate_n = int(rate.numerator) if rate else 0
        rate_d = int(rate.denominator) if rate else 1
        out = obj.decode(raw, infos, rate_n, rate_d)
        arr = np.frombuffer(bytes(out), np.uint8)
        return Buffer(
            tensors=[Tensor(arr, TensorSpec.from_shape(arr.shape, np.uint8))],
            pts=buf.pts, duration=buf.duration, meta=dict(buf.meta))
