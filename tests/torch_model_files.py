"""Model files for the importer tests, written in pure numpy + struct.

The reference's own model files (mobilenet_v2_quant.onnx,
mobilenet_v2_1.0_224_quant.tflite, mnist.pb, conv_actions_frozen.pb) are
not in the repository, so the importer tests and ``chip_smoke.py`` phase
21 write their own, from seeded weights, in the same layouts:

- :func:`write_onnx_qlinear`: a QLinear MobileNetV2 in the layout of the
  reference's onnxruntime test model — input ``input`` float (1,3,H,W)
  NCHW, ``QuantizeLinear`` → ``QLinearConv``/``QLinearAdd``/
  ``QLinearGlobalAveragePool`` → ``QLinearMatMul`` + ``QLinearAdd``
  classifier → ``DequantizeLinear`` → output ``output`` (1, classes);
  :func:`write_onnx_float` the same network in float (``Conv``, ``Clip``,
  ``Add``, ``GlobalAveragePool``, ``Flatten``, ``Gemm``).
- :func:`write_tflite_quant`: a uint8 MobileNetV2 in the layout of
  mobilenet_v2_1.0_224_quant.tflite (``TFL3``): 65 operators over
  {ADD, AVERAGE_POOL_2D, CONV_2D, DEPTHWISE_CONV_2D, RESHAPE}, fused RELU6,
  uint8 input (1,H,W,3) and output (1, classes).
- :func:`write_speech_pb`: the TF speech-commands ``conv`` graph of
  conv_actions_frozen.pb (DecodeWav → AudioSpectrogram → Mfcc → two
  Conv2D/Relu, MaxPool → MatMul → Add → Softmax over 12 labels);
  :func:`write_mnist_pb` the mnist.pb op set (Placeholder, Const,
  Identity, MatMul, Add, Softmax).

The MobileNetV2 weights come from the port's ``mobilenet_v2_init`` with
seeded batch-norm statistics folded into the convolutions.  Quantization
is per tensor, uint8, asymmetric; every activation range is calibrated on
one seeded batch through the float network (5% headroom), so the codes of
that batch do not saturate.  Only numpy, struct and torch (for the
calibration forward) are imported: the card machine has no TF, onnx or
flatbuffers package.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

#: the speech-commands labels conv_actions_frozen.pb was trained on
SPEECH_LABELS = ["_silence_", "_unknown_", "yes", "no", "up", "down",
                 "left", "right", "on", "off", "stop", "go"]

_BN_EPS = 1e-3
_HEADROOM = 1.05


# -- MobileNetV2: seeded weights, BN folded, ranges calibrated ---------------


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _fold(p: dict, rng: np.random.Generator):
    """A conv of the init tree (w HWIO) with seeded batch-norm statistics
    folded in: (w OIHW float32, b float32)."""
    cout = p["w"].shape[-1]
    scale = (1.0 + 0.1 * rng.standard_normal(cout)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    inv = scale / np.sqrt(var + _BN_EPS)
    w = (p["w"] * inv).astype(np.float32)
    b = (bias - mean * inv).astype(np.float32)
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))), b


def mobilenet_v2_net(seed: int, width: float = 1.0, size: int = 224,
                     classes: int = 1001, calib: int = 2):
    """The network every MobileNetV2 writer serializes: a list of layers
    (``conv``/``add``/``pool``/``fc`` dicts naming their input and output
    tensors) and each tensor's calibrated real range (lo, hi), from one
    seeded batch of ``calib`` images in [-1, 1) through the float
    network."""
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.models.mobilenet import (
        _v2_strides,
        mobilenet_v2_init,
    )

    tree = mobilenet_v2_init(seed, classes, width)
    rng = np.random.default_rng(seed + 1)
    layers: List[dict] = []

    def conv(name, x, p, stride, groups, relu6, hw):
        w, b = _fold(p, rng)
        k = w.shape[-1]
        layers.append(dict(kind="conv", name=name, x=x, y=name, w=w, b=b,
                           stride=stride, groups=groups, relu6=relu6,
                           pads=(_same(hw, k, stride), _same(hw, k, stride))))
        return name, -(-hw // stride)

    t, hw = conv("stem", "input", tree["stem"], 2, 1, True, size)
    for i, (blk, stride) in enumerate(zip(tree["blocks"], _v2_strides())):
        x = t
        if "expand" in blk:
            t, _ = conv(f"b{i}_expand", t, blk["expand"], 1, 1, True, hw)
        mid = blk["dw"]["w"].shape[-1]
        t, hw2 = conv(f"b{i}_dw", t, blk["dw"], stride, mid, True, hw)
        t, _ = conv(f"b{i}_project", t, blk["project"], 1, 1, False, hw2)
        cin = blk["expand"]["w"].shape[2] if "expand" in blk \
            else blk["dw"]["w"].shape[-1]
        if stride == 1 and cin == blk["project"]["w"].shape[-1]:
            layers.append(dict(kind="add", name=f"b{i}_add", a=x, b=t,
                               y=f"b{i}_add"))
            t = f"b{i}_add"
        hw = hw2
    t, _ = conv("last", t, tree["last"], 1, 1, True, hw)
    layers.append(dict(kind="pool", name="pool", x=t, y="pool", hw=hw))
    layers.append(dict(kind="fc", name="logits", x="pool", y="logits",
                       w=np.asarray(tree["head"]["w"], np.float32),
                       b=(0.1 * rng.standard_normal(classes)).astype(
                           np.float32)))

    # calibration: the float network on one seeded batch, NCHW
    img = np.random.default_rng(seed + 2).integers(
        0, 256, (calib, 3, size, size)).astype(np.float32)
    vals = {"input": torch.from_numpy(img / 127.5 - 1.0)}
    # with headroom, as every tensor: a scale of exactly 2/255 would put
    # every normalized camera value on a rounding tie
    ranges = {"input": _range(vals["input"].numpy(), False)}
    with torch.no_grad():
        for ly in layers:
            if ly["kind"] == "conv":
                (pt, pb), (pl, pr) = ly["pads"]
                h = F.pad(vals[ly["x"]], (pl, pr, pt, pb))
                y = F.conv2d(h, torch.from_numpy(ly["w"]),
                             torch.from_numpy(ly["b"]), ly["stride"],
                             groups=ly["groups"])
                if ly["relu6"]:
                    y = y.clamp(0.0, 6.0)
            elif ly["kind"] == "add":
                y = vals[ly["a"]] + vals[ly["b"]]
            elif ly["kind"] == "pool":
                y = vals[ly["x"]].mean(dim=(2, 3), keepdim=True)
            else:
                mm = vals[ly["x"]].flatten(1) @ torch.from_numpy(ly["w"])
                ranges["logits_mm"] = _range(mm.numpy(), False)
                y = mm + torch.from_numpy(ly["b"])
            vals[ly["y"]] = y
            ranges[ly["y"]] = _range(y.numpy(),
                                     ly.get("relu6", False))
    return layers, ranges


def _range(a: np.ndarray, relu6: bool) -> Tuple[float, float]:
    lo, hi = float(a.min()), float(a.max())
    if relu6:
        return 0.0, min(6.0, max(hi * _HEADROOM, 1e-3))
    span = max(hi - lo, 1e-3) * (_HEADROOM - 1.0) / 2
    return min(lo - span, 0.0), max(hi + span, 0.0)


def quant_params(lo: float, hi: float) -> Tuple[float, int]:
    """uint8 asymmetric (scale, zero point) covering [lo, hi] and 0."""
    lo, hi = min(lo, 0.0), max(hi, 0.0)
    scale = max(hi - lo, 1e-8) / 255.0
    zp = int(np.clip(np.round(-lo / scale), 0, 255))
    return float(np.float32(scale)), zp


def quantize(a: np.ndarray, scale: float, zp: int) -> np.ndarray:
    return np.clip(np.round(a / scale) + zp, 0, 255).astype(np.uint8)


def _wq(w: np.ndarray) -> Tuple[np.ndarray, float, int]:
    s, z = quant_params(float(w.min()), float(w.max()))
    return quantize(w, s, z), s, z


# -- protobuf primitives -------------------------------------------------------


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pv(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def _pb(field: int, payload) -> bytes:
    if isinstance(payload, str):
        payload = payload.encode()
    return _key(field, 2) + _varint(len(payload)) + bytes(payload)


def _pf32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _packed(field: int, ints) -> bytes:
    return _pb(field, b"".join(_varint(int(i)) for i in ints))


# -- ONNX ------------------------------------------------------------------------

# TensorProto.DataType
_ONNX_DT = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
            np.dtype(np.int8): 3, np.dtype(np.int32): 6,
            np.dtype(np.int64): 7}


def _onnx_tensor(name: str, a: np.ndarray) -> bytes:
    a = np.asarray(a)
    return (_packed(1, a.shape) + _pv(2, _ONNX_DT[a.dtype]) + _pb(8, name)
            + _pb(9, np.ascontiguousarray(a).tobytes()))


def _onnx_attr(name: str, v) -> bytes:
    """AttributeProto: INT (3), INTS (8), FLOAT (2), STRING (4)."""
    if isinstance(v, float):
        return _pb(1, name) + _pf32(2, v) + _pv(20, 1)
    if isinstance(v, int):
        return _pb(1, name) + _pv(3, v) + _pv(20, 2)
    if isinstance(v, (bytes, str)):
        return _pb(1, name) + _pb(4, v) + _pv(20, 3)
    return _pb(1, name) + b"".join(_pv(8, i) for i in v) + _pv(20, 7)


def _onnx_node(op: str, ins, outs, name: str, domain: str = "",
               **attrs) -> bytes:
    b = b"".join(_pb(1, i) for i in ins) + b"".join(_pb(2, o) for o in outs)
    b += _pb(3, name) + _pb(4, op)
    b += b"".join(_pb(5, _onnx_attr(k, v)) for k, v in attrs.items())
    if domain:
        b += _pb(7, domain)
    return b


def _onnx_value_info(name: str, elem: int, dims) -> bytes:
    shape = b"".join(_pb(1, _pv(1, d)) for d in dims)
    return _pb(1, name) + _pb(2, _pb(1, _pv(1, elem) + _pb(2, shape)))


def _onnx_model(nodes, inits, inputs, outputs) -> bytes:
    graph = b"".join(_pb(1, n) for n in nodes) + _pb(2, "mobilenet_v2")
    graph += b"".join(_pb(5, _onnx_tensor(k, v)) for k, v in inits.items())
    graph += b"".join(_pb(11, v) for v in inputs)
    graph += b"".join(_pb(12, v) for v in outputs)
    opsets = _pb(8, _pb(1, "") + _pv(2, 13)) + \
        _pb(8, _pb(1, "com.microsoft") + _pv(2, 1))
    return _pv(1, 7) + _pb(2, "nnstreamer_tpu tests") + opsets + \
        _pb(7, graph)


def _conv_attrs(ly) -> dict:
    (pt, pb), (pl, pr) = ly["pads"]
    k = int(ly["w"].shape[-1])
    return dict(kernel_shape=[k, k], strides=[ly["stride"]] * 2,
                pads=[pt, pl, pb, pr], group=int(ly["groups"]),
                dilations=[1, 1])


def write_onnx_qlinear(path: str, seed: int = 0, width: float = 1.0,
                       size: int = 224, classes: int = 1000) -> str:
    """The QLinear MobileNetV2 (see the module doc) at ``path``."""
    layers, ranges = mobilenet_v2_net(seed, width, size, classes)
    q = {t: quant_params(*r) for t, r in ranges.items()}
    inits: Dict[str, np.ndarray] = {}
    nodes: List[bytes] = []

    def qp(t):
        s, z = q[t]
        if f"{t}_scale" not in inits:
            inits[f"{t}_scale"] = np.asarray(s, np.float32)
            inits[f"{t}_zp"] = np.asarray(z, np.uint8)
        return [f"{t}_scale", f"{t}_zp"]

    nodes.append(_onnx_node("QuantizeLinear", ["input"] + qp("input"),
                            ["input_q"], "quantize"))
    cur = {"input": "input_q"}
    for ly in layers:
        y = ly["y"] + "_q"
        if ly["kind"] == "conv":
            wq, ws, wz = _wq(ly["w"])
            inits[ly["name"] + "_w"] = wq
            inits[ly["name"] + "_w_scale"] = np.asarray(ws, np.float32)
            inits[ly["name"] + "_w_zp"] = np.asarray(wz, np.uint8)
            xs = q[ly["x"]][0]
            inits[ly["name"] + "_b"] = np.round(
                ly["b"] / (np.float32(xs) * np.float32(ws))).astype(np.int32)
            ins = [cur[ly["x"]]] + qp(ly["x"]) + [
                ly["name"] + "_w", ly["name"] + "_w_scale",
                ly["name"] + "_w_zp"] + qp(ly["y"]) + [ly["name"] + "_b"]
            nodes.append(_onnx_node("QLinearConv", ins, [y], ly["name"],
                                    **_conv_attrs(ly)))
        elif ly["kind"] == "add":
            ins = [cur[ly["a"]]] + qp(ly["a"]) + [cur[ly["b"]]] + \
                qp(ly["b"]) + qp(ly["y"])
            nodes.append(_onnx_node("QLinearAdd", ins, [y], ly["name"],
                                    domain="com.microsoft"))
        elif ly["kind"] == "pool":
            ins = [cur[ly["x"]]] + qp(ly["x"]) + qp(ly["y"])
            nodes.append(_onnx_node("QLinearGlobalAveragePool", ins, [y],
                                    ly["name"], domain="com.microsoft",
                                    channels_last=0))
        else:  # classifier: flatten, QLinearMatMul, QLinearAdd(bias)
            inits["flat_shape"] = np.asarray([1, -1], np.int64)
            nodes.append(_onnx_node("Reshape", [cur[ly["x"]], "flat_shape"],
                                    ["flat_q"], "flatten"))
            wq, ws, wz = _wq(ly["w"])
            inits["fc_w"], inits["fc_w_scale"], inits["fc_w_zp"] = \
                wq, np.asarray(ws, np.float32), np.asarray(wz, np.uint8)
            nodes.append(_onnx_node(
                "QLinearMatMul", ["flat_q"] + qp(ly["x"]) + [
                    "fc_w", "fc_w_scale", "fc_w_zp"] + qp("logits_mm"),
                ["logits_mm_q"], "fc"))
            bq, bs, bz = _wq(ly["b"])
            inits["fc_b"], inits["fc_b_scale"], inits["fc_b_zp"] = \
                bq, np.asarray(bs, np.float32), np.asarray(bz, np.uint8)
            nodes.append(_onnx_node(
                "QLinearAdd", ["logits_mm_q"] + qp("logits_mm") + [
                    "fc_b", "fc_b_scale", "fc_b_zp"] + qp(ly["y"]),
                [y], "fc_bias", domain="com.microsoft"))
        cur[ly["y"]] = y
    nodes.append(_onnx_node("DequantizeLinear", [cur["logits"]] +
                            qp("logits"), ["output"], "dequantize"))
    blob = _onnx_model(nodes, inits,
                       [_onnx_value_info("input", 1, [1, 3, size, size])],
                       [_onnx_value_info("output", 1, [1, classes])])
    with open(path, "wb") as f:
        f.write(blob)
    return path


def write_onnx_float(path: str, seed: int = 0, width: float = 1.0,
                     size: int = 224, classes: int = 1000) -> str:
    """The same MobileNetV2 as float ONNX ops at ``path``."""
    layers, _ = mobilenet_v2_net(seed, width, size, classes)
    inits: Dict[str, np.ndarray] = {
        "clip_min": np.asarray(0.0, np.float32),
        "clip_max": np.asarray(6.0, np.float32)}
    nodes: List[bytes] = []
    for ly in layers:
        n = ly["name"]
        if ly["kind"] == "conv":
            inits[n + "_w"], inits[n + "_b"] = ly["w"], ly["b"]
            out = n + "_pre" if ly["relu6"] else ly["y"]
            nodes.append(_onnx_node("Conv", [ly["x"], n + "_w", n + "_b"],
                                    [out], n, **_conv_attrs(ly)))
            if ly["relu6"]:
                nodes.append(_onnx_node("Clip", [out, "clip_min",
                                                 "clip_max"], [ly["y"]],
                                        n + "_relu6"))
        elif ly["kind"] == "add":
            nodes.append(_onnx_node("Add", [ly["a"], ly["b"]], [ly["y"]], n))
        elif ly["kind"] == "pool":
            nodes.append(_onnx_node("GlobalAveragePool", [ly["x"]],
                                    [ly["y"]], n))
        else:
            nodes.append(_onnx_node("Flatten", [ly["x"]], ["flat"],
                                    "flatten", axis=1))
            inits["fc_w"] = np.ascontiguousarray(ly["w"].T)
            inits["fc_b"] = ly["b"]
            nodes.append(_onnx_node("Gemm", ["flat", "fc_w", "fc_b"],
                                    ["output"], "fc", transB=1))
    blob = _onnx_model(nodes, inits,
                       [_onnx_value_info("input", 1, [1, 3, size, size])],
                       [_onnx_value_info("output", 1, [1, classes])])
    with open(path, "wb") as f:
        f.write(blob)
    return path


# -- flatbuffers (TFLite) ------------------------------------------------------

_SCALAR = {"u8": "<B", "i8": "<b", "u16": "<H", "i32": "<i", "u32": "<I",
           "f32": "<f", "i64": "<q"}


class _Tbl:
    """A flatbuffer table: ``{field_id: (kind, value)}``; kinds are the
    scalars of ``_SCALAR``, ``tbl``, ``str``, ``[tbl]``, ``[i32]``,
    ``[f32]``, ``[i64]`` and ``[u8]``."""

    def __init__(self, **fields):
        self.fields = {int(k[1:]): v for k, v in fields.items()}


class _FBWriter:
    """Lays a table tree out front to back: a parent before its children,
    so every unsigned offset points forward."""

    def __init__(self):
        self.b = bytearray()

    def _pad(self, n: int, extra: int = 0) -> None:
        while (len(self.b) + extra) % n:
            self.b.append(0)

    def _patch(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.b, at, target - at)

    def finish(self, root: _Tbl, ident: bytes) -> bytes:
        self.b += b"\0\0\0\0" + ident
        self._patch(0, self.table(root))
        return bytes(self.b)

    def table(self, t: _Tbl) -> int:
        layout, pos = {}, 4
        for fid, (kind, _) in sorted(t.fields.items()):
            size = struct.calcsize(_SCALAR[kind]) if kind in _SCALAR else 4
            pos = -(-pos // size) * size
            layout[fid] = pos
            pos += size
        nf = max(t.fields) + 1 if t.fields else 0
        self._pad(2)
        vt = len(self.b)
        self.b += struct.pack("<HH", 4 + 2 * nf, pos)
        self.b += b"".join(struct.pack("<H", layout.get(i, 0))
                           for i in range(nf))
        self._pad(8)
        start = len(self.b)
        self.b += struct.pack("<i", start - vt) + bytes(pos - 4)
        kids = []
        for fid, (kind, v) in sorted(t.fields.items()):
            if kind in _SCALAR:
                struct.pack_into(_SCALAR[kind], self.b, start + layout[fid],
                                 v)
            else:
                kids.append((start + layout[fid], kind, v))
        for at, kind, v in kids:
            self._patch(at, self.obj(kind, v))
        return start

    def obj(self, kind: str, v) -> int:
        if kind == "tbl":
            return self.table(v)
        if kind == "str":
            self._pad(4)
            at = len(self.b)
            raw = v.encode()
            self.b += struct.pack("<I", len(raw)) + raw + b"\0"
            return at
        elem = kind[1:-1]
        if elem == "u8":
            self._pad(16, 4)
            at = len(self.b)
            self.b += struct.pack("<I", len(v)) + bytes(v)
            return at
        if elem == "i64":
            self._pad(8, 4)
        else:
            self._pad(4)
        at = len(self.b)
        self.b += struct.pack("<I", len(v))
        if elem == "tbl":
            slots = []
            for _ in v:
                slots.append(len(self.b))
                self.b += b"\0\0\0\0"
            for slot, t in zip(slots, v):
                self._patch(slot, self.table(t))
        else:
            fmt = {"i32": "<i", "f32": "<f", "i64": "<q"}[elem]
            self.b += b"".join(struct.pack(fmt, x) for x in v)
        return at


# BuiltinOperator codes and BuiltinOptions union types (schema.fbs)
_TFL_OPS = {"ADD": 0, "AVERAGE_POOL_2D": 1, "CONV_2D": 3,
            "DEPTHWISE_CONV_2D": 4, "RESHAPE": 22}
_TFL_OPTS = {"CONV_2D": 1, "DEPTHWISE_CONV_2D": 2, "AVERAGE_POOL_2D": 5,
             "ADD": 11, "RESHAPE": 17}
_TT_F32, _TT_I32, _TT_U8 = 0, 2, 3


def write_tflite_quant(path: str, seed: int = 0, width: float = 1.0,
                       size: int = 224, classes: int = 1001) -> str:
    """The uint8 MobileNetV2 (see the module doc) at ``path``."""
    layers, ranges = mobilenet_v2_net(seed, width, size, classes)
    # the reference model's input quantization: real = (q - 128) / 128
    ranges = dict(ranges)
    q = {t: quant_params(*r) for t, r in ranges.items()}
    q["input"] = (1.0 / 128.0, 128)
    buffers = [_Tbl()]                  # buffer 0: the empty sentinel
    tensors: List[_Tbl] = []
    index: Dict[str, int] = {}
    shapes: Dict[str, List[int]] = {"input": [1, size, size, 3]}
    ops: List[_Tbl] = []
    used: List[str] = []

    def tensor(name, shape, ttype, data=None, scale=None, zp=0):
        buf = 0
        if data is not None:
            buffers.append(_Tbl(f0=("[u8]", np.ascontiguousarray(
                data).tobytes())))
            buf = len(buffers) - 1
        fields = dict(f0=("[i32]", [int(s) for s in shape]),
                      f1=("u8", ttype), f2=("u32", buf), f3=("str", name))
        if scale is not None:
            fields["f4"] = ("tbl", _Tbl(f2=("[f32]", [float(scale)]),
                                        f3=("[i64]", [int(zp)])))
        tensors.append(_Tbl(**fields))
        index[name] = len(tensors) - 1
        return index[name]

    def act(name):
        if name not in index:
            s, z = q[name]
            tensor(name, shapes[name], _TT_U8, scale=s, zp=z)
        return index[name]

    def op(kind, ins, outs, opts: _Tbl):
        if kind not in used:
            used.append(kind)
        ops.append(_Tbl(f0=("u32", used.index(kind)), f1=("[i32]", ins),
                        f2=("[i32]", outs), f3=("u8", _TFL_OPTS[kind]),
                        f4=("tbl", opts)))

    act("input")
    for ly in layers:
        if ly["kind"] == "conv":
            x, k = ly["x"], int(ly["w"].shape[-1])
            n, hw = shapes[x][0], shapes[x][1]
            dw = ly["groups"] > 1
            oc = ly["w"].shape[0]
            out_hw = -(-hw // ly["stride"])
            shapes[ly["y"]] = [n, out_hw, out_hw, oc]
            w = np.transpose(ly["w"], (1, 2, 3, 0)) if dw else \
                np.transpose(ly["w"], (0, 2, 3, 1))  # → (1,kh,kw,C) / OHWI
            wq, ws, wz = _wq(w)
            wi = tensor(ly["name"] + "/weights", w.shape, _TT_U8, wq, ws, wz)
            bs = np.float32(q[x][0]) * np.float32(ws)
            bi = tensor(ly["name"] + "/bias", [oc], _TT_I32,
                        np.round(ly["b"] / bs).astype(np.int32), bs, 0)
            fa = 3 if ly["relu6"] else 0
            s = ly["stride"]
            opts = _Tbl(f0=("u8", 0), f1=("i32", s), f2=("i32", s),
                        f3=("i32", 1), f4=("u8", fa)) if dw else \
                _Tbl(f0=("u8", 0), f1=("i32", s), f2=("i32", s),
                     f3=("u8", fa))
            op("DEPTHWISE_CONV_2D" if dw else "CONV_2D",
               [act(x), wi, bi], [act(ly["y"])], opts)
        elif ly["kind"] == "add":
            shapes[ly["y"]] = shapes[ly["a"]]
            op("ADD", [act(ly["a"]), act(ly["b"])], [act(ly["y"])],
               _Tbl(f0=("u8", 0)))
        elif ly["kind"] == "pool":
            hw = ly["hw"]
            shapes[ly["y"]] = [1, 1, 1, shapes[ly["x"]][3]]
            op("AVERAGE_POOL_2D", [act(ly["x"])], [act(ly["y"])],
               _Tbl(f0=("u8", 1), f1=("i32", 1), f2=("i32", 1),
                    f3=("i32", hw), f4=("i32", hw), f5=("u8", 0)))
        else:  # the classifier as a 1x1 conv, then RESHAPE to (1, classes)
            w = ly["w"].T.reshape(classes, 1, 1, -1)
            wq, ws, wz = _wq(w)
            wi = tensor("logits/weights", w.shape, _TT_U8, wq, ws, wz)
            bs = np.float32(q[ly["x"]][0]) * np.float32(ws)
            bi = tensor("logits/bias", [classes], _TT_I32,
                        np.round(ly["b"] / bs).astype(np.int32), bs, 0)
            shapes["logits4"] = [1, 1, 1, classes]
            q["logits4"] = q["logits"]
            op("CONV_2D", [act(ly["x"]), wi, bi], [act("logits4")],
               _Tbl(f0=("u8", 1), f1=("i32", 1), f2=("i32", 1),
                    f3=("u8", 0)))
            si = tensor("logits/shape", [2], _TT_I32,
                        np.asarray([1, classes], np.int32))
            shapes["logits"] = [1, classes]
            op("RESHAPE", [act("logits4"), si], [act("logits")],
               _Tbl(f0=("[i32]", [1, classes])))
    subgraph = _Tbl(f0=("[tbl]", tensors), f1=("[i32]", [index["input"]]),
                    f2=("[i32]", [index["logits"]]), f3=("[tbl]", ops),
                    f4=("str", "main"))
    codes = [_Tbl(f0=("i8", _TFL_OPS[k]), f2=("i32", 1),
                  f3=("i32", _TFL_OPS[k])) for k in used]
    model = _Tbl(f0=("u32", 3), f1=("[tbl]", codes), f2=("[tbl]", [subgraph]),
                 f3=("str", "nnstreamer_tpu tests"), f4=("[tbl]", buffers))
    with open(path, "wb") as f:
        f.write(_FBWriter().finish(model, b"TFL3"))
    return path


# -- GraphDef (TF) -------------------------------------------------------------

_DT_FLOAT, _DT_INT32, _DT_STRING = 1, 3, 7


def _tf_shape(dims) -> bytes:
    return b"".join(_pb(2, _pv(1, d & ((1 << 64) - 1))) for d in dims)


def _tf_tensor(a: np.ndarray) -> bytes:
    dt = {np.dtype(np.float32): _DT_FLOAT,
          np.dtype(np.int32): _DT_INT32}[a.dtype]
    return _pv(1, dt) + _pb(2, _tf_shape(a.shape)) + \
        _pb(4, np.ascontiguousarray(a).tobytes())


def _tf_attr(v) -> bytes:
    """AttrValue from a tagged value: ('type', n), ('s', str), ('i', n),
    ('f', x), ('b', bool), ('ints', [..]), ('shape', dims),
    ('tensor', array)."""
    kind, x = v
    if kind == "type":
        return _pv(6, x)
    if kind == "s":
        return _pb(2, x)
    if kind == "i":
        return _pv(3, x)
    if kind == "f":
        return _pf32(4, x)
    if kind == "b":
        return _pv(5, int(x))
    if kind == "ints":
        return _pb(1, _packed(3, x))
    if kind == "shape":
        return _pb(7, _tf_shape(x))
    return _pb(8, _tf_tensor(x))


def _tf_node(name: str, op: str, ins=(), **attrs) -> bytes:
    b = _pb(1, name) + _pb(2, op) + b"".join(_pb(3, i) for i in ins)
    for k, v in sorted(attrs.items()):
        b += _pb(5, _pb(1, k) + _pb(2, _tf_attr(v)))
    return _pb(1, b)


def _tf_const(name: str, a: np.ndarray) -> bytes:
    dt = _DT_FLOAT if a.dtype == np.float32 else _DT_INT32
    return _tf_node(name, "Const", dtype=("type", dt), value=("tensor", a))


def _graphdef(nodes: List[bytes]) -> bytes:
    return b"".join(nodes) + _pb(4, _pv(1, 27))


def write_speech_pb(path: str, seed: int = 0, filters: int = 64) -> str:
    """The speech-commands ``conv`` graph (see the module doc) at
    ``path``; ``filters`` is 64 in the original."""
    rng = np.random.default_rng(seed)
    f32 = ("type", _DT_FLOAT)

    def he(*shape):
        fan = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan)).astype(
            np.float32)

    w1, w2 = he(20, 8, 1, filters), he(10, 4, filters, filters)
    flat = 49 * 20 * filters
    wf = he(flat, len(SPEECH_LABELS))
    nodes = [
        _tf_node("wav_data", "Placeholder", dtype=("type", _DT_STRING),
                 shape=("shape", [])),
        _tf_node("decoded_sample_data", "DecodeWav", ["wav_data"],
                 desired_channels=("i", 1), desired_samples=("i", 16000)),
        _tf_node("AudioSpectrogram", "AudioSpectrogram",
                 ["decoded_sample_data"], window_size=("i", 480),
                 stride=("i", 160), magnitude_squared=("b", True)),
        _tf_node("Mfcc", "Mfcc", ["AudioSpectrogram",
                                  "decoded_sample_data:1"],
                 dct_coefficient_count=("i", 40),
                 filterbank_channel_count=("i", 40),
                 lower_frequency_limit=("f", 20.0),
                 upper_frequency_limit=("f", 4000.0)),
        _tf_const("Reshape/shape", np.asarray([-1, 3920], np.int32)),
        _tf_node("Reshape", "Reshape", ["Mfcc", "Reshape/shape"], T=f32,
                 Tshape=("type", _DT_INT32)),
        _tf_const("Reshape_1/shape", np.asarray([-1, 98, 40, 1], np.int32)),
        _tf_node("Reshape_1", "Reshape", ["Reshape", "Reshape_1/shape"],
                 T=f32, Tshape=("type", _DT_INT32)),
        _tf_const("Variable", w1),
        _tf_node("Variable/read", "Identity", ["Variable"], T=f32),
        _tf_node("Conv2D", "Conv2D", ["Reshape_1", "Variable/read"], T=f32,
                 strides=("ints", [1, 1, 1, 1]), padding=("s", "SAME"),
                 data_format=("s", "NHWC"), dilations=("ints", [1] * 4)),
        _tf_const("Variable_1", (0.1 * rng.standard_normal(filters)).astype(
            np.float32)),
        _tf_node("add", "Add", ["Conv2D", "Variable_1"], T=f32),
        _tf_node("Relu", "Relu", ["add"], T=f32),
        _tf_node("MaxPool", "MaxPool", ["Relu"], T=f32,
                 ksize=("ints", [1, 2, 2, 1]),
                 strides=("ints", [1, 2, 2, 1]), padding=("s", "SAME"),
                 data_format=("s", "NHWC")),
        _tf_const("Variable_2", w2),
        _tf_node("Conv2D_1", "Conv2D", ["MaxPool", "Variable_2"], T=f32,
                 strides=("ints", [1, 1, 1, 1]), padding=("s", "SAME"),
                 data_format=("s", "NHWC"), dilations=("ints", [1] * 4)),
        _tf_const("Variable_3", (0.1 * rng.standard_normal(filters)).astype(
            np.float32)),
        _tf_node("add_1", "Add", ["Conv2D_1", "Variable_3"], T=f32),
        _tf_node("Relu_1", "Relu", ["add_1"], T=f32),
        _tf_const("Reshape_2/shape", np.asarray([-1, flat], np.int32)),
        _tf_node("Reshape_2", "Reshape", ["Relu_1", "Reshape_2/shape"],
                 T=f32, Tshape=("type", _DT_INT32)),
        _tf_const("Variable_4", wf),
        _tf_node("MatMul", "MatMul", ["Reshape_2", "Variable_4"], T=f32,
                 transpose_a=("b", False), transpose_b=("b", False)),
        _tf_const("Variable_5", (0.1 * rng.standard_normal(
            len(SPEECH_LABELS))).astype(np.float32)),
        _tf_node("add_2", "Add", ["MatMul", "Variable_5"], T=f32),
        _tf_node("labels_softmax", "Softmax", ["add_2"], T=f32),
    ]
    with open(path, "wb") as f:
        f.write(_graphdef(nodes))
    return path


def write_mnist_pb(path: str, seed: int = 0) -> str:
    """A softmax regression over 784 pixels in the op set of mnist.pb
    (Placeholder, Const, Identity, MatMul, Add, Softmax) at ``path``."""
    rng = np.random.default_rng(seed)
    f32 = ("type", _DT_FLOAT)
    nodes = [
        _tf_node("input", "Placeholder", dtype=f32,
                 shape=("shape", [-1, 784])),
        _tf_const("W", (0.05 * rng.standard_normal((784, 10))).astype(
            np.float32)),
        _tf_node("W/read", "Identity", ["W"], T=f32),
        _tf_const("b", (0.1 * rng.standard_normal(10)).astype(np.float32)),
        _tf_node("b/read", "Identity", ["b"], T=f32),
        _tf_node("MatMul", "MatMul", ["input", "W/read"], T=f32,
                 transpose_a=("b", False), transpose_b=("b", False)),
        _tf_node("add", "Add", ["MatMul", "b/read"], T=f32),
        _tf_node("softmax", "Softmax", ["add"], T=f32),
    ]
    with open(path, "wb") as f:
        f.write(_graphdef(nodes))
    return path


def wav_bytes(pcm: np.ndarray, rate: int = 16000) -> bytes:
    """A mono PCM16 RIFF/WAVE container of float samples in [-1, 1]
    (DecodeWav reads back ``int16 / 32768``)."""
    data = np.clip(np.round(np.asarray(pcm).ravel() * 32768.0), -32768,
                   32767).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, rate, rate * 2, 2, 16)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + \
        b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", len(body)) + body


def seeded_clip(seed: int, samples: int = 16000) -> np.ndarray:
    """A seeded 1 s clip: two tones and noise, as the speech graph's PCM
    input (samples, 1) float32 on the PCM16 grid."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000.0
    f0, f1 = rng.uniform(150, 900), rng.uniform(900, 3000)
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * f1 * t)
    x = x + 0.05 * rng.standard_normal(samples)
    q = np.clip(np.round(x * 32767.0), -32768, 32767)
    return (q / 32768.0).astype(np.float32).reshape(samples, 1)
