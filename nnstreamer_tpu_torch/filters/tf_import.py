"""Minimal TensorFlow frozen-GraphDef importer: protobuf walk + graph → torch.

Counterpart of the JAX package's ``filters/tf_import.py`` (parity target:
the reference's tensorflow filter sub-plugin, which loads a frozen .pb
through the TF C API session).  No TF runtime: a hand-rolled protobuf walk
(no protoc codegen, like the wire codecs) reads NodeDefs/attrs/const
tensors, copied from the JAX package; the graph is rebuilt as one PyTorch
function that runs eagerly on the card.

Covers the reference's frozen test models (mnist.pb,
conv_actions_frozen.pb): Placeholder, Const, Identity, MatMul,
Add/BiasAdd, Softmax, Reshape, Conv2D, Relu, MaxPool, and the speech
preprocessing ops DecodeWav (host-side WAV container parse — the graph
starts at PCM), AudioSpectrogram and Mfcc (reimplemented from the TF op
semantics: Hann window, pow2 FFT through ``torch.fft.rfft``, HTK-style mel
filterbank, ortho DCT-II).  Anything else raises with the op name.

Precision: no switch of PyTorch's is set here, so a pipeline runs under
its own (by default cuDNN convolutions take TF32 operands, matmuls stay
float32).  The speech graph's softmax on the card lies within 1e-4 of
the CPU's with TF32 off and within 1e-3 under the default (1.7e-4 read on
an H100, ``chip_smoke.py`` phase 21c); mnist has no convolution and
stays within 1e-5 both ways.
"""

from __future__ import annotations

import math
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..converters.codecs import _read_varint as _varint
from .importer_ops import conv2d_nhwc, max_pool_nhwc, pads_of, same_pad
from .importer_util import batch_flex_target

# -- protobuf wire-format walk ------------------------------------------------


def _signed64(v: int) -> int:
    """Protobuf varint ints are 64-bit two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(b: bytes):
    """Yield (field_number, wire_type, value) over a message's bytes;
    value is int for varint/fixed, bytes for length-delimited."""
    p = 0
    n = len(b)
    while p < n:
        tag, p = _varint(b, p)
        f, w = tag >> 3, tag & 7
        if w == 0:
            v, p = _varint(b, p)
        elif w == 1:
            v = struct.unpack_from("<Q", b, p)[0]
            p += 8
        elif w == 2:
            ln, p = _varint(b, p)
            v = b[p:p + ln]
            p += ln
        elif w == 5:
            v = struct.unpack_from("<I", b, p)[0]
            p += 4
        else:
            raise ValueError(f"graphdef: unsupported wire type {w}")
        yield f, w, v


def _f32_of(v: int) -> float:
    return struct.unpack("<f", struct.pack("<I", v & 0xFFFFFFFF))[0]


# TF DataType enum → numpy
_DT_NP = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
          5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_}


def _parse_tensor(b: bytes) -> np.ndarray:
    """TensorProto: dtype=1, tensor_shape=2, tensor_content=4,
    float_val=5, int_val=7, int64_val=10."""
    dtype = np.float32
    dt_code = 1
    shape: List[int] = []
    content = b""
    floats: List[float] = []
    ints: List[int] = []
    for f, w, v in _fields(b):
        if f == 1:
            dt_code = v
            if v not in _DT_NP:
                raise ValueError(
                    f"graphdef: unsupported tensor dtype {v}")
            dtype = _DT_NP[v]
        elif f == 2:
            for f2, _, v2 in _fields(v):
                if f2 == 2:  # Dim
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            shape.append(v3)
        elif f == 4:
            content = v
        elif f == 5:
            if w == 2:  # packed
                floats.extend(np.frombuffer(v, "<f4").tolist())
            else:
                floats.append(_f32_of(v))
        elif f == 6:  # double_val
            if w == 2:
                floats.extend(np.frombuffer(v, "<f8").tolist())
            else:
                floats.append(struct.unpack(
                    "<d", struct.pack("<Q", v))[0])
        elif f in (7, 10):
            if w == 2:
                p = 0
                while p < len(v):
                    x, p = _varint(v, p)
                    ints.append(_signed64(x))
            else:
                ints.append(_signed64(v))
    del dt_code
    if content:
        arr = np.frombuffer(content, dtype)
    elif floats:
        arr = np.asarray(floats, dtype)
    elif ints:
        arr = np.asarray(ints, dtype)
    else:
        arr = np.zeros(0, dtype)
    n = int(np.prod(shape)) if shape else arr.size
    if arr.size == 1 and n > 1:
        arr = np.full(n, arr[0], dtype)
    return arr.reshape(shape) if shape else arr


class _Attr:
    __slots__ = ("s", "i", "f", "b", "type", "tensor", "ints")

    def __init__(self):
        self.s = b""
        self.i = 0
        self.f = 0.0
        self.b = False
        self.type = 0
        self.tensor: Optional[np.ndarray] = None
        self.ints: List[int] = []


def _parse_attr(b: bytes) -> _Attr:
    """AttrValue: list=1, s=2, i=3, f=4, b=5, type=6, shape=7, tensor=8."""
    a = _Attr()
    for f, w, v in _fields(b):
        if f == 2:
            a.s = v
        elif f == 3:
            a.i = _signed64(v)
        elif f == 4:
            a.f = _f32_of(v)
        elif f == 5:
            a.b = bool(v)
        elif f == 6:
            a.type = v
        elif f == 8:
            a.tensor = _parse_tensor(v)
        elif f == 1:  # ListValue: i=3 repeated
            for f2, w2, v2 in _fields(v):
                if f2 == 3:
                    if w2 == 2:
                        p = 0
                        while p < len(v2):
                            x, p = _varint(v2, p)
                            a.ints.append(_signed64(x))
                    else:
                        a.ints.append(_signed64(v2))
    return a


class TFNode:
    __slots__ = ("name", "op", "inputs", "attrs")

    def __init__(self):
        self.name = ""
        self.op = ""
        self.inputs: List[str] = []
        self.attrs: Dict[str, _Attr] = {}


class TFGraph:
    """Parsed frozen GraphDef: name → node, topological walk by need."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            buf = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                buf = f.read()
        self.nodes: Dict[str, TFNode] = {}
        self.order: List[TFNode] = []
        for f, w, v in _fields(buf):
            if f == 1:  # NodeDef
                n = TFNode()
                for f2, w2, v2 in _fields(v):
                    if f2 == 1:
                        n.name = v2.decode("utf-8", "replace")
                    elif f2 == 2:
                        n.op = v2.decode("utf-8", "replace")
                    elif f2 == 3:
                        n.inputs.append(v2.decode("utf-8", "replace"))
                    elif f2 == 5:  # attr map entry {key=1, value=2}
                        key = None
                        val = None
                        for f3, _, v3 in _fields(v2):
                            if f3 == 1:
                                key = v3.decode("utf-8", "replace")
                            elif f3 == 2:
                                val = _parse_attr(v3)
                        if key is not None and val is not None:
                            n.attrs[key] = val
                if not n.name:
                    continue
                self.nodes[n.name] = n
                self.order.append(n)
        if not self.nodes:
            raise ValueError("graphdef: no nodes")

    def placeholders(self) -> List[TFNode]:
        return [n for n in self.order if n.op == "Placeholder"]

    def output(self) -> TFNode:
        """The single node nobody consumes (frozen classifier shape)."""
        consumed = {i.split(":")[0].lstrip("^")
                    for n in self.order for i in n.inputs}
        outs = [n for n in self.order
                if n.name not in consumed and n.op not in
                ("Const", "Placeholder")]
        if len(outs) != 1:
            raise ValueError(
                f"graphdef: expected one output node, found "
                f"{[n.name for n in outs]}")
        return outs[0]


# -- speech preprocessing (TF op semantics) ----------------------------------


def decode_wav_bytes(data: bytes, desired_samples: int = 0,
                     desired_channels: int = 0
                     ) -> Tuple[np.ndarray, int]:
    """Host-side DecodeWav: parse a PCM16 WAV container → (samples,
    channels) float32 in [-1,1] plus sample rate (the reference feeds
    the same wav files through TF's DecodeWav,
    tests/test_models/data/yes.wav).  ``desired_samples`` > 0 trims or
    zero-pads to that length and ``desired_channels`` > 0 selects /
    duplicates channels — the TF op's normalization, so short clips
    still match the graph's declared input shape."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("decode_wav: not a RIFF/WAVE file")
    p = 12
    fmt = None
    pcm = None
    rate = 16000
    while p + 8 <= len(data):
        cid = data[p:p + 4]
        (ln,) = struct.unpack_from("<I", data, p + 4)
        body = data[p + 8:p + 8 + ln]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            rate = fmt[2]
        elif cid == b"data":
            pcm = body
        p += 8 + ln + (ln & 1)
    if fmt is None or pcm is None:
        raise ValueError("decode_wav: missing fmt/data chunk")
    channels, bits = fmt[1], fmt[5]
    if bits != 16:
        raise ValueError(f"decode_wav: only PCM16 supported, got {bits}")
    x = np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0
    x = x.reshape(-1, channels)
    if desired_channels > 0:
        if desired_channels <= x.shape[1]:
            x = x[:, :desired_channels]
        else:
            x = np.repeat(x[:, :1], desired_channels, axis=1)
    if desired_samples > 0:
        if x.shape[0] >= desired_samples:
            x = x[:desired_samples]
        else:
            x = np.pad(x, ((0, desired_samples - x.shape[0]), (0, 0)))
    return x, rate


def _hann(n: int) -> np.ndarray:
    # TF's spectrogram window (periodic Hann)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float32)


def audio_spectrogram(pcm: torch.Tensor, window_size: int, stride: int,
                      magnitude_squared: bool) -> torch.Tensor:
    """TF AudioSpectrogram: frame → periodic Hann → pow2 FFT →
    magnitude (or squared).  ``pcm``: (samples, channels) float32 →
    (channels, frames, fft_bins)."""
    fft_len = 1 << max(int(math.ceil(math.log2(window_size))), 0)
    x = pcm.float().transpose(0, 1)                   # (ch, samples)
    n = x.shape[1]
    if n < window_size:
        # TF emits ZERO frames for clips shorter than one window
        return torch.zeros((x.shape[0], 0, fft_len // 2 + 1),
                           dtype=torch.float32, device=x.device)
    hann = torch.from_numpy(_hann(window_size)).to(x.device)
    windowed = x.unfold(1, window_size, stride) * hann  # (ch, fr, win)
    mag = torch.fft.rfft(windowed, n=fft_len, dim=-1).abs()
    return (mag * mag if magnitude_squared else mag).float()


def _mel_filterbank(channels: int, fft_bins: int, rate: float,
                    lower: float, upper: float) -> np.ndarray:
    """HTK-style triangular mel filterbank, (fft_bins, channels) —
    the TF MfccMelFilterbank construction."""
    def mel(f):
        return 1127.0 * np.log1p(f / 700.0)

    centers = np.linspace(mel(lower), mel(upper), channels + 2)
    freqs = np.arange(fft_bins) * rate / ((fft_bins - 1) * 2.0)
    melf = mel(np.maximum(freqs, 1e-3))
    bank = np.zeros((fft_bins, channels), np.float32)
    for c in range(channels):
        lo, ctr, hi = centers[c], centers[c + 1], centers[c + 2]
        up_slope = (melf - lo) / max(ctr - lo, 1e-6)
        down_slope = (hi - melf) / max(hi - ctr, 1e-6)
        bank[:, c] = np.clip(np.minimum(up_slope, down_slope), 0.0, None)
    bank[0] = 0.0  # TF skips the DC bin
    return bank


def _dct(coeffs: int, channels: int) -> np.ndarray:
    """The ortho DCT-II rows, (coeffs, channels)."""
    k = np.arange(coeffs)[:, None]
    n = np.arange(channels)[None, :]
    return (np.cos(np.pi * k * (2 * n + 1) / (2.0 * channels)) *
            np.sqrt(2.0 / channels)).astype(np.float32)


def mfcc(spec: torch.Tensor, rate: float, upper: float, lower: float,
         channels: int, coeffs: int) -> torch.Tensor:
    """TF Mfcc: squared-magnitude spectrogram → mel energies → log →
    ortho DCT-II, first ``coeffs`` coefficients.
    ``spec``: (ch, frames, fft_bins) → (ch, frames, coeffs)."""
    bank = torch.from_numpy(_mel_filterbank(
        channels, spec.shape[-1], rate, lower, upper)).to(spec.device)
    mel_e = spec @ bank
    log_e = torch.log(torch.clamp(mel_e, min=1e-12))
    return log_e @ torch.from_numpy(_dct(coeffs, channels)).to(
        spec.device).T


# -- graph → torch ------------------------------------------------------------


def build_fn(graph: TFGraph, sample_rate: int = 16000):
    """Compile the frozen graph into ``fn(params, x) -> output``.  Graphs
    whose input is a DecodeWav placeholder take the decoded (samples,
    channels) float PCM instead of wav bytes (DecodeWav is a host-side
    container parse — see :func:`decode_wav_bytes`)."""
    consts: Dict[str, np.ndarray] = {}
    for n in graph.order:
        if n.op == "Const" and n.attrs.get("value") is not None:
            consts[n.name] = n.attrs["value"].tensor
    phs = graph.placeholders()
    if len(phs) != 1:
        raise ValueError("graphdef: expected exactly one Placeholder")
    ph = phs[0]
    out_node = graph.output()

    structural = set()
    for n in graph.order:
        if n.op == "Reshape" and len(n.inputs) > 1:
            structural.add(n.inputs[1].split(":")[0].lstrip("^"))
        if n.op == "Mfcc" and len(n.inputs) > 1:
            structural.add(n.inputs[1].split(":")[0].lstrip("^"))
    weights = {name: arr for name, arr in consts.items()
               if name not in structural}

    # input spec: DecodeWav-fed graphs take PCM
    wav_nodes = [n for n in graph.order if n.op == "DecodeWav"]
    if wav_nodes:
        wn = wav_nodes[0]
        samples = wn.attrs.get("desired_samples")
        ch = wn.attrs.get("desired_channels")
        n_samples = int(samples.i) if samples else 0
        if n_samples <= 0:  # TF default -1 = "whole file"
            n_samples = sample_rate
        in_shape = (n_samples, max(int(ch.i) if ch else 1, 1))
        in_dtype = np.float32
    else:
        # frozen test graphs carry unknown dims; the caller supplies
        # input_spec through the filter layer
        in_shape = None
        in_dtype = _DT_NP.get(ph.attrs.get("dtype", _Attr()).type,
                              np.float32)

    def fn(params, x):
        vals: Dict[str, Any] = {ph.name: x}

        def get(ref):
            name = ref.split(":")[0].lstrip("^")
            if name in vals:
                return vals[name]
            if name in params:  # device-placed weights
                return params[name]
            if name in consts:
                return torch.as_tensor(consts[name], device=x.device)
            node = graph.nodes[name]
            vals[name] = _eval(node)
            return vals[name]

        def _eval(n):
            op = n.op
            if op == "Identity":
                return get(n.inputs[0])
            if op == "Const":
                return get(n.name)
            if op == "DecodeWav":
                return get(n.inputs[0])  # PCM supplied as the input
            if op == "AudioSpectrogram":
                return audio_spectrogram(
                    get(n.inputs[0]),
                    int(n.attrs["window_size"].i),
                    int(n.attrs["stride"].i),
                    bool(n.attrs.get("magnitude_squared",
                                     _Attr()).b))
            if op == "Mfcc":
                a = n.attrs
                rate = float(sample_rate)
                if len(n.inputs) > 1:
                    rname = n.inputs[1].split(":")[0].lstrip("^")
                    if rname in consts:  # rate baked as a const
                        rate = float(np.asarray(consts[rname]).ravel()[0])
                # defaults apply only when the attr key is truly absent
                # — an explicit 0/0.0 value is honored (e.g.
                # lower_frequency_limit=0.0 must not become 20.0)
                return mfcc(
                    get(n.inputs[0]), rate,
                    float(a["upper_frequency_limit"].f)
                    if "upper_frequency_limit" in a else 4000.0,
                    float(a["lower_frequency_limit"].f)
                    if "lower_frequency_limit" in a else 20.0,
                    int(a["filterbank_channel_count"].i)
                    if "filterbank_channel_count" in a else 40,
                    int(a["dct_coefficient_count"].i)
                    if "dct_coefficient_count" in a else 13)
            if op == "MatMul":
                a, b = get(n.inputs[0]), get(n.inputs[1])
                if n.attrs.get("transpose_a", _Attr()).b:
                    a = a.T
                if n.attrs.get("transpose_b", _Attr()).b:
                    b = b.T
                return a @ b
            if op in ("Add", "AddV2", "BiasAdd"):
                return get(n.inputs[0]) + get(n.inputs[1])
            if op == "Softmax":
                return torch.softmax(get(n.inputs[0]), dim=-1)
            if op == "Relu":
                return torch.clamp(get(n.inputs[0]), min=0.0)
            if op == "Reshape":
                v = get(n.inputs[0])
                shape = batch_flex_target(
                    tuple(int(s)
                          for s in np.asarray(consts[
                              n.inputs[1].split(":")[0]])),
                    tuple(v.shape),
                    int(x.shape[0]) if x.dim() else 1)
                return v.reshape(shape)
            if op == "Conv2D":
                xi, w = get(n.inputs[0]), get(n.inputs[1])
                fmt = (n.attrs.get("data_format", _Attr()).s.decode()
                       or "NHWC")
                if fmt != "NHWC":
                    raise NotImplementedError(
                        f"graphdef: Conv2D data_format {fmt}")
                strides = n.attrs["strides"].ints or [1, 1, 1, 1]
                dil = n.attrs.get("dilations", _Attr()).ints or \
                    [1, 1, 1, 1]
                padding = n.attrs["padding"].s.decode() or "SAME"
                kh, kw = int(w.shape[0]), int(w.shape[1])
                pads = ((0, 0), (0, 0)) if padding == "VALID" else (
                    same_pad(xi.shape[1], strides[1], kh, dil[1]),
                    same_pad(xi.shape[2], strides[2], kw, dil[2]))
                return conv2d_nhwc(xi, w.permute(3, 2, 0, 1),  # HWIO→OIHW
                                   strides[1:3], pads, dil[1:3])
            if op == "MaxPool":
                xi = get(n.inputs[0])
                fmt = (n.attrs.get("data_format", _Attr()).s.decode()
                       or "NHWC")
                if fmt != "NHWC":
                    raise NotImplementedError(
                        f"graphdef: MaxPool data_format {fmt}")
                ks = n.attrs["ksize"].ints or [1, 2, 2, 1]
                st = n.attrs["strides"].ints or [1, 2, 2, 1]
                if ks[0] != 1 or ks[3] != 1 or st[0] != 1 or st[3] != 1:
                    raise NotImplementedError(
                        f"graphdef: MaxPool over batch or channels "
                        f"(ksize {ks}, strides {st})")
                padding = n.attrs["padding"].s.decode() or "SAME"
                return max_pool_nhwc(
                    xi, ks[1:3], st[1:3],
                    pads_of(padding, xi, ks[1:3], st[1:3]))
            raise NotImplementedError(
                f"graphdef: unsupported op {op} ({n.name})")

        return get(out_node.name).float()

    return fn, weights, in_shape, in_dtype
