"""``tensor_converter`` — media streams → tensor streams.

Counterpart of the JAX package's ``elements/converter.py`` (parity
target: the reference's gsttensor_converter.c): per-media parsers
(video, audio, text, octet, flexible tensors), the zero-copy rule for
video rows whose stride needs no 4-byte padding, ``frames-per-tensor``
batching, and external converter sub-plugins for other mimetypes
(``converters/``).

A converted frame keeps its payload where it is: a host frame stays on
the host, zero-copy (a numpy view) whenever the source layout is tight,
and moves to the card once, at the first device element; a media frame
already on the device (a device-rendered overlay) stays there, reshaped.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import (
    Buffer,
    Caps,
    CapsStruct,
    DType,
    Tensor,
    TensorFormat,
    TensorSpec,
    TensorsSpec,
)
from ..converters import find_converter
from ..core.buffer import to_numpy
from ..runtime.element import Element, NegotiationError, Pad, StreamError
from ..runtime.registry import register_element

# format string → (channels, dtype); parity: video caps handling in the
# reference's gsttensor_converter.c
VIDEO_FORMATS: Dict[str, Tuple[int, DType]] = {
    "RGB": (3, DType.UINT8), "BGR": (3, DType.UINT8),
    "RGBx": (4, DType.UINT8), "BGRx": (4, DType.UINT8),
    "xRGB": (4, DType.UINT8), "xBGR": (4, DType.UINT8),
    "RGBA": (4, DType.UINT8), "BGRA": (4, DType.UINT8),
    "ARGB": (4, DType.UINT8), "ABGR": (4, DType.UINT8),
    "GRAY8": (1, DType.UINT8),
    "GRAY16_LE": (1, DType.UINT16),
}

AUDIO_FORMATS: Dict[str, DType] = {
    "S8": DType.INT8, "U8": DType.UINT8,
    "S16LE": DType.INT16, "U16LE": DType.UINT16,
    "S32LE": DType.INT32, "U32LE": DType.UINT32,
    "F32LE": DType.FLOAT32, "F64LE": DType.FLOAT64,
}

_MEDIA_MIMES = ("video/x-raw", "audio/x-raw", "text/x-raw",
                "application/octet-stream", "other/tensors", "other/tensor")


@register_element("tensor_converter")
class TensorConverter(Element):
    FACTORY = "tensor_converter"

    def __init__(self, name=None, frames_per_tensor: int = 1,
                 input_dim: str = "", input_type: str = "",
                 set_timestamp: bool = True, mode: str = "", **props):
        self.frames_per_tensor = frames_per_tensor
        self.input_dim = input_dim
        self.input_type = input_type
        self.set_timestamp = set_timestamp
        # mode=custom-code:NAME | custom-script:FILE.py (parity:
        # gsttensor_converter.c "mode" property + tensor_converter_custom.c)
        self.mode = mode
        super().__init__(name, **props)
        self.add_sink_pad()
        self.add_src_pad()
        self._media: Optional[CapsStruct] = None
        self._frame_spec: Optional[TensorSpec] = None  # single-frame schema
        self._out_spec: Optional[TensorsSpec] = None
        self._pending: List[np.ndarray] = []  # frames-per-tensor aggregation
        self._pending_pts: Optional[int] = None
        self._frame_count = 0
        self._stride_pad = 0  # bytes of row padding to strip (video)
        self._ext = None  # external converter sub-plugin
        self._mode_ext = None  # resolved mode= converter (cached)
        self._mode_key = None

    # -- negotiation ---------------------------------------------------------

    def pad_template_caps(self, pad: Pad) -> Caps:
        if pad.direction.value == "sink":
            from ..converters import registered_mimes

            mimes = _MEDIA_MIMES + tuple(
                m for m in registered_mimes() if m not in _MEDIA_MIMES)
            structs = [CapsStruct.make(m) for m in mimes]
            return Caps(structs=tuple(structs))
        return Caps.any_tensors()

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        if pad.direction.value == "sink":
            self._configure_from_media(caps.first())
        super().set_caps(pad, caps)

    def _configure_from_media(self, s: CapsStruct) -> None:
        n = int(self.frames_per_tensor)
        rate = s.get("framerate", Fraction(0, 1))
        mime = s.mime
        self._stride_pad = 0
        self._ext = None
        if self.mode:
            # resolve once per mode value: custom scripts must not be
            # re-executed (losing state) on every renegotiation
            if self._mode_ext is None or self._mode_key != str(self.mode):
                self._mode_ext = self._resolve_mode(str(self.mode))
                self._mode_key = str(self.mode)
            self._ext = self._mode_ext
            self._media = s
            self._frame_spec = None
            self._out_spec = self._ext.get_out_config(s)
            return
        if mime == "video/x-raw":
            fmt = str(s.get("format", "RGB"))
            if fmt not in VIDEO_FORMATS:
                raise NegotiationError(
                    f"{self.name}: unsupported video format {fmt!r}")
            ch, dt = VIDEO_FORMATS[fmt]
            w, h = int(s.get("width", 0)), int(s.get("height", 0))
            if w <= 0 or h <= 0:
                raise NegotiationError(
                    f"{self.name}: video caps need width/height")
            row = w * ch * dt.size
            if fmt in ("RGB", "BGR", "GRAY8") and row % 4 != 0:
                # GStreamer pads these rows to 4 bytes: per-frame copy
                # needed (parity: zero-copy rule, gsttensor_converter.md)
                self._stride_pad = 4 - row % 4
            self._frame_spec = TensorSpec(dtype=dt, dims=(ch, w, h, 1))
            self._media = s
        elif mime == "audio/x-raw":
            fmt = str(s.get("format", "S16LE"))
            if fmt not in AUDIO_FORMATS:
                raise NegotiationError(
                    f"{self.name}: unsupported audio format {fmt!r}")
            dt = AUDIO_FORMATS[fmt]
            if self.input_dim:
                # explicit per-buffer schema override (channels:samples)
                self._frame_spec = TensorSpec(
                    dtype=dt,
                    dims=TensorSpec.parse(self.input_dim, str(dt)).dims)
            else:
                chans = int(s.get("channels", 1))
                # samples per incoming buffer from caps; the reference
                # errors on buffers whose size mismatches the negotiated
                # frame (gsttensor_converter.c audio path) — same here via
                # the chain-time size check.
                samples = int(s.get("samples", 1))
                self._frame_spec = TensorSpec(dtype=dt, dims=(chans, samples))
            self._media = s
        elif mime == "text/x-raw":
            size = self._explicit_dims_or_fail("text")
            self._frame_spec = size
            self._media = s
        elif mime == "application/octet-stream":
            self._frame_spec = self._explicit_dims_or_fail("octet")
            self._media = s
        elif mime in ("other/tensors", "other/tensor"):
            # flexible → static passthrough reconfig (chain validates)
            self._media = s
            self._frame_spec = None
            if self.input_dim and self.input_type:
                self._frame_spec = TensorSpec.parse(
                    self.input_dim.split(",")[0],
                    self.input_type.split(",")[0])
        else:
            self._ext = find_converter(mime)
            if self._ext is None:
                raise NegotiationError(
                    f"{self.name}: no converter for mime {mime!r}")
            self._media = s
            self._frame_spec = None
        # out spec
        if self._frame_spec is not None:
            dims = list(self._frame_spec.dims)
            if n > 1:
                # batch along the outermost dim (parity: 30fps d=300:300 →
                # 15fps d=300:300:2, gsttensor_aggregator.md analog)
                if len(dims) >= 4 and dims[-1] == 1:
                    dims[-1] = n  # implicit batch slot (video 3:w:h:1)
                else:
                    dims = dims + [n]
            out_rate = Fraction(rate) / n if rate else Fraction(0, 1)
            self._out_spec = TensorsSpec.of(
                self._frame_spec.with_dims(dims), rate=out_rate)
        elif self._ext is not None:
            self._out_spec = self._ext.get_out_config(s)
        else:
            self._out_spec = TensorsSpec(
                format=TensorFormat.FLEXIBLE, rate=Fraction(rate))

    def _resolve_mode(self, mode: str):
        from ..converters import ExternalConverter, find_custom

        kind, _, arg = mode.partition(":")
        if kind == "custom-code":
            fn = find_custom(arg)
            if fn is None:
                raise NegotiationError(
                    f"{self.name}: no custom converter registered as "
                    f"{arg!r}")

            class _CallableConverter(ExternalConverter):
                def get_out_config(self, caps):
                    return TensorsSpec(format=TensorFormat.FLEXIBLE,
                                       rate=caps.get("framerate",
                                                     Fraction(0, 1))
                                       if caps is not None
                                       else Fraction(0, 1))

                def convert(self, buf, caps):
                    return fn(buf)

            return _CallableConverter()
        if kind == "custom-script":
            from ..converters.python3 import Python3Converter

            return Python3Converter(arg)
        raise NegotiationError(
            f"{self.name}: unknown converter mode {mode!r} "
            "(expected custom-code:NAME or custom-script:FILE.py)")

    def _explicit_dims_or_fail(self, kind: str) -> TensorSpec:
        if not self.input_dim:
            raise NegotiationError(
                f"{self.name}: {kind} input needs input-dim"
                f"{'' if kind == 'text' else '/input-type'} property")
        dt = DType.from_string(self.input_type) if self.input_type \
            else DType.UINT8
        return TensorSpec(dtype=dt,
                          dims=TensorSpec.parse(self.input_dim, str(dt)).dims)

    def propose_src_caps(self, pad: Pad) -> Caps:
        if self._out_spec is None:
            raise NegotiationError(f"{self.name}: input caps not set")
        return Caps.from_spec(self._out_spec)

    # -- chain ---------------------------------------------------------------

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if self._ext is not None:
            out = self._ext.convert(buf, self._media)
            self.push(out)
            return
        mime = self._media.mime if self._media else "other/tensors"
        if mime in ("other/tensors", "other/tensor"):
            self._chain_flex_to_static(buf)
            return
        arr = self._media_frame_to_array(buf)
        n = int(self.frames_per_tensor)
        if n <= 1:
            self._push_frame([arr], buf.pts)
        else:
            self._pending.append(arr)
            if self._pending_pts is None:
                self._pending_pts = buf.pts
            if len(self._pending) >= n:
                frames, pts = self._pending, self._pending_pts
                self._pending, self._pending_pts = [], None
                self._push_frame(frames, pts)

    def _media_frame_to_array(self, buf: Buffer):
        spec = self._frame_spec
        t = buf.tensors[0]
        if t._host is None and t._dev is not None:
            # a frame already on the device (a device-rendered overlay)
            # stays there: a reshape, no copy
            x = t.torch()
            if x.numel() * x.element_size() != spec.nbytes:
                raise StreamError(
                    f"{self.name}: frame size "
                    f"{x.numel() * x.element_size()} != {spec.nbytes}")
            return x.reshape(spec.shape)
        if t._host is not None or t._dev is not None:
            arr = t.np()
            if arr.size * arr.itemsize != spec.nbytes:
                raise StreamError(
                    f"{self.name}: frame size {arr.nbytes} != {spec.nbytes}")
            return arr.reshape(spec.shape)  # zero-copy reshape
        raw = t.tobytes()
        if self._stride_pad:
            ch, w, h = spec.dims[0], spec.dims[1], spec.dims[2]
            row = w * ch * spec.dtype.size
            padded = row + self._stride_pad
            if len(raw) == padded * h:
                a = np.frombuffer(raw, np.uint8).reshape(h, padded)
                raw = np.ascontiguousarray(a[:, :row]).tobytes()
        if len(raw) != spec.nbytes:
            raise StreamError(
                f"{self.name}: payload {len(raw)}B != expected {spec.nbytes}B")
        return np.frombuffer(raw, dtype=spec.dtype.np_dtype).reshape(spec.shape)

    def _push_frame(self, frames: list, pts: Optional[int]) -> None:
        out_spec = self._out_spec.tensors[0]
        if len(frames) == 1:
            arr = frames[0].reshape(out_spec.shape)
        elif all(isinstance(f, torch.Tensor) for f in frames):
            arr = torch.stack(frames).reshape(out_spec.shape)
        else:
            arr = np.stack([f if isinstance(f, np.ndarray) else to_numpy(f)
                            for f in frames], axis=0).reshape(out_spec.shape)
        if pts is None and self.set_timestamp:
            from ..core import SECOND

            rate = self._out_spec.rate
            pts = int(self._frame_count * SECOND / rate) if rate else 0
        self._frame_count += 1
        self.push(Buffer(tensors=[Tensor(arr, out_spec)], pts=pts))

    def _chain_flex_to_static(self, buf: Buffer) -> None:
        if self._frame_spec is not None:
            tensors = [t.with_spec(self._frame_spec) for t in buf.tensors]
        else:
            tensors = buf.tensors
        self.push(Buffer(tensors=tensors, pts=buf.pts, duration=buf.duration,
                         format=TensorFormat.STATIC, meta=dict(buf.meta)))

    def on_eos(self) -> None:
        # A partial batch at EOS is dropped, matching the reference's
        # GstAdapter behavior (leftover sub-frame data is discarded);
        # chain() has already flushed every complete batch.
        self._pending, self._pending_pts = [], None
