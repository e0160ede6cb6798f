"""Minimal ONNX model importer: protobuf walk + quantized graph → torch.

Counterpart of the JAX package's ``filters/onnx_import.py`` (parity
target: the reference's onnxruntime filter sub-plugin and its in-tree
test model mobilenet_v2_quant.onnx, an ORT-quantized torchvision
MobileNetV2: QLinearConv/QLinearAdd/QLinearMatMul/
QLinearGlobalAveragePool, all-uint8 activations+weights, NCHW float I/O).
No ORT runtime: the hand-rolled protobuf walk (no protoc codegen) is a
copy of the JAX package's, and the network is rebuilt as one PyTorch
function that runs eagerly on the card.

Quantization is an execution mode, as in the JAX package: weights stay
uint8 on the device and inter-op activations carry their integer codes.
Four modes, selectable via ``custom=qmode:<mode>``:

- ``bf16`` (the filter's default): activations stored as their integer
  code (0..255) in bf16, exact; each conv lifts codes and weights to
  float32 integer values (exact) and accumulates in float32 (exact while
  the sums stay below 2**24).  The JAX package convolves bf16 operands
  with a float32 accumulator; PyTorch's bf16 convolution would round its
  output to bf16, so the codes go to float32 instead (same products;
  codes of at most 255 in magnitude enter cuDNN's TF32 unrounded).
- ``dequant``: the same arithmetic with uint8 activation storage.
- ``int8``: exact integer sums.  CUDA has no integer convolution, and a
  float32 sum is exact only below 2**24 (a 1x1 conv over 960 channels of
  255x255 products reaches 6.2e7), so the zero-point-removed codes
  convolve in float64, exact below 2**53, and the sum rounds to float32
  once, as the JAX package's int32 accumulator does.
- ``float``: dequantize the weights at load and run float32 with each
  activation still rounded and saturated to its quantized range.

Layout: ONNX graphs are NCHW; the importer transposes the input once and
runs the network NHWC inside (the NCHW view of NHWC memory is a
channels-last tensor for cuDNN).  Weights stay OIHW, PyTorch's layout,
where the JAX package transposes them to HWIO at load.  Reshape is
supported where layout cannot matter (2-D tensors, or 4-D with 1x1
spatial).  A graph with several inputs binds the last, as the JAX
package does; here a graph whose nodes read another input is refused at
load, naming the inputs (the JAX package fails at its first call).

Precision: no switch of PyTorch's is set here, so a pipeline runs under
its own (by default cuDNN convolutions take TF32 operands, matmuls stay
float32).  ``bf16``, ``dequant`` and ``int8`` give the same codes either
way.  ``float`` convolves real values: on the card its logits lie within
8 output quanta of the CPU's with TF32 off and within 16 under the
default (2.0 and 8.0 read on an H100, ``chip_smoke.py`` phase 21a).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .importer_ops import (
    DeviceConsts,
    avg_pool_nhwc,
    conv2d_nhwc,
    max_pool_nhwc,
    mean_hw,
    true_div,
)
from .importer_util import batch_flex_target
from .tf_import import _fields, _signed64

# -- protobuf parse -----------------------------------------------------------

# ONNX TensorProto.DataType
_ODT_NP = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
           5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
           11: np.float64, 12: np.uint32, 13: np.uint64}


def _parse_tensor(b: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
    int64_data=7, name=8, raw_data=9, double_data=10."""
    dims: List[int] = []
    dt = 1
    name = ""
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    for f, w, v in _fields(b):
        if f == 1:
            if w == 2:  # packed
                p = 0
                from ..converters.codecs import _read_varint
                while p < len(v):
                    x, p = _read_varint(v, p)
                    dims.append(_signed64(x))
            else:
                dims.append(_signed64(v))
        elif f == 2:
            dt = v
        elif f == 4:
            if w == 2:
                floats.extend(np.frombuffer(v, "<f4").tolist())
            else:
                floats.append(struct.unpack(
                    "<f", struct.pack("<I", v & 0xFFFFFFFF))[0])
        elif f in (5, 7):
            if w == 2:
                p = 0
                from ..converters.codecs import _read_varint
                while p < len(v):
                    x, p = _read_varint(v, p)
                    ints.append(_signed64(x))
            else:
                ints.append(_signed64(v))
        elif f == 8:
            name = v.decode("utf-8", "replace")
        elif f == 9:
            raw = v
    if dt not in _ODT_NP:
        raise NotImplementedError(f"onnx: unsupported tensor dtype {dt}")
    np_dt = _ODT_NP[dt]
    if raw:
        arr = np.frombuffer(raw, np_dt)
    elif floats:
        arr = np.asarray(floats, np_dt)
    elif ints:
        arr = np.asarray(ints, np_dt)
    else:
        arr = np.zeros(0, np_dt)
    n = int(np.prod(dims)) if dims else arr.size
    if arr.size == 1 and n > 1:
        arr = np.full(n, arr.ravel()[0], np_dt)
    return name, (arr.reshape(dims) if dims else arr)


class OnnxAttr:
    __slots__ = ("name", "f", "i", "s", "t", "ints", "floats", "present")

    def __init__(self):
        self.name = ""
        self.f = 0.0
        self.i = 0
        self.s = b""
        self.t: Optional[np.ndarray] = None
        self.ints: List[int] = []
        self.floats: List[float] = []


def _parse_attr(b: bytes) -> OnnxAttr:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8."""
    a = OnnxAttr()
    from ..converters.codecs import _read_varint
    for f, w, v in _fields(b):
        if f == 1:
            a.name = v.decode("utf-8", "replace")
        elif f == 2:
            a.f = struct.unpack("<f", struct.pack("<I", v & 0xFFFFFFFF))[0]
        elif f == 3:
            a.i = _signed64(v)
        elif f == 4:
            a.s = v
        elif f == 5:
            a.t = _parse_tensor(v)[1]
        elif f == 7:
            if w == 2:
                a.floats.extend(np.frombuffer(v, "<f4").tolist())
            else:
                a.floats.append(struct.unpack(
                    "<f", struct.pack("<I", v & 0xFFFFFFFF))[0])
        elif f == 8:
            if w == 2:
                p = 0
                while p < len(v):
                    x, p = _read_varint(v, p)
                    a.ints.append(_signed64(x))
            else:
                a.ints.append(_signed64(v))
    return a


class OnnxNode:
    __slots__ = ("name", "op", "inputs", "outputs", "attrs")

    def __init__(self):
        self.name = ""
        self.op = ""
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.attrs: Dict[str, OnnxAttr] = {}

    def attr_ints(self, key: str, default) -> List[int]:
        return list(self.attrs[key].ints) if key in self.attrs \
            else list(default)

    def attr_i(self, key: str, default: int) -> int:
        return int(self.attrs[key].i) if key in self.attrs else default


def _parse_value_info(b: bytes) -> Tuple[str, Optional[int], List[int]]:
    """ValueInfoProto → (name, elem_type, dims); unknown dims are 0."""
    name = ""
    elem: Optional[int] = None
    dims: List[int] = []
    for f, w, v in _fields(b):
        if f == 1:
            name = v.decode("utf-8", "replace")
        elif f == 2:  # TypeProto.tensor_type=1
            for f2, _, v2 in _fields(v):
                if f2 != 1:
                    continue
                for f3, _, v3 in _fields(v2):
                    if f3 == 1:
                        elem = v3
                    elif f3 == 2:  # TensorShapeProto.dim=1
                        for f4, _, v4 in _fields(v3):
                            if f4 != 1:
                                continue
                            dv = 0
                            for f5, _, v5 in _fields(v4):
                                if f5 == 1:
                                    dv = _signed64(v5)
                            dims.append(dv)
    return name, elem, dims


class OnnxModel:
    """Parsed ModelProto: nodes (topological), initializers, graph IO."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            buf = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                buf = f.read()
        graph = None
        for f, w, v in _fields(buf):
            if f == 7:  # ModelProto.graph
                graph = v
        if graph is None:
            raise ValueError("onnx: no graph in model")
        self.nodes: List[OnnxNode] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.inputs: List[Tuple[str, Optional[int], List[int]]] = []
        self.outputs: List[str] = []
        for f, w, v in _fields(graph):
            if f == 1:  # node
                n = OnnxNode()
                for f2, w2, v2 in _fields(v):
                    if f2 == 1:
                        n.inputs.append(v2.decode("utf-8", "replace"))
                    elif f2 == 2:
                        n.outputs.append(v2.decode("utf-8", "replace"))
                    elif f2 == 3:
                        n.name = v2.decode("utf-8", "replace")
                    elif f2 == 4:
                        n.op = v2.decode("utf-8", "replace")
                    elif f2 == 5:
                        a = _parse_attr(v2)
                        n.attrs[a.name] = a
                self.nodes.append(n)
            elif f == 5:  # initializer
                name, arr = _parse_tensor(v)
                self.inits[name] = arr
            elif f == 11:
                self.inputs.append(_parse_value_info(v))
            elif f == 12:
                self.outputs.append(_parse_value_info(v)[0])
        if not self.nodes:
            raise ValueError("onnx: no nodes in graph")


# -- graph → torch ------------------------------------------------------------


def _pads4(node: OnnxNode) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """ONNX 2-D pads [hb, wb, he, we] → ((hb, he), (wb, we))."""
    auto = node.attrs.get("auto_pad")
    if auto is not None and auto.s not in (b"", b"NOTSET"):
        raise NotImplementedError(
            f"onnx: auto_pad {auto.s!r} unsupported (explicit pads only)")
    p = node.attr_ints("pads", [0, 0, 0, 0])
    return (int(p[0]), int(p[2])), (int(p[1]), int(p[3]))


def _qparams(consts, sname: str, zname: str):
    s = np.asarray(consts[sname], np.float32).ravel()
    z = np.asarray(consts[zname]).ravel().astype(np.int32) \
        if zname and zname in consts else np.zeros(1, np.int32)
    return s, z


_SUPPORTED = {"QuantizeLinear", "DequantizeLinear", "QLinearConv",
              "QLinearAdd", "QLinearMul", "QLinearGlobalAveragePool",
              "QLinearMatMul", "Reshape", "Conv", "Add", "Mul", "Relu",
              "Clip", "GlobalAveragePool", "MatMul", "Gemm", "Softmax",
              "Flatten", "Sigmoid", "Concat", "MaxPool", "AveragePool",
              "Transpose"}

#: quantized storage dtype → (lowest code, highest code, torch dtype)
_RQ = {np.dtype(np.uint8): (0, 255, torch.uint8),
       np.dtype(np.int8): (-128, 127, torch.int8)}


def _wshape(ndim: int) -> Tuple[int, ...]:
    """How a per-output-channel vector broadcasts over a weight: OIHW
    puts O first, a (K, N) matmul weight N last."""
    return (-1, 1, 1, 1) if ndim == 4 else (-1,)


def _graph_input(model: OnnxModel, consts) -> Tuple[str, Optional[int],
                                                      List[int]]:
    """The graph input the function binds: the last one that is not an
    initializer, as in the JAX package.  A graph whose nodes also read
    another input is refused here, naming the inputs."""
    free = [gi for gi in model.inputs if gi[0] not in consts]
    if not free:
        raise ValueError("onnx: no graph input")
    read = {nm for n in model.nodes for nm in n.inputs}
    unbound = [gi[0] for gi in free[:-1] if gi[0] in read]
    if unbound:
        raise ValueError(
            f"onnx: graph inputs {[gi[0] for gi in free]}: only one input "
            f"is bound ({free[-1][0]!r}), but nodes read {unbound}")
    return free[-1]


def build_fn(model: OnnxModel, qmode: str = "dequant"):
    """Compile the parsed graph into ``fn(params, x) -> y`` plus the
    params dict (numpy initializers), the declared input shape (NCHW as
    exported) and dtype.  ``qmode``: "bf16" (default via the filter) |
    "dequant" | "int8" | "float" (see module doc)."""
    if qmode not in ("bf16", "dequant", "int8", "float"):
        raise ValueError(f"onnx: unknown qmode {qmode!r}")

    floatlike = qmode == "float"
    consts = dict(model.inits)
    for n in model.nodes:
        if n.op not in _SUPPORTED:
            raise NotImplementedError(
                f"onnx: unsupported op {n.op} (node {n.name!r})")

    in_name, in_elem, in_dims = _graph_input(model, consts)
    in_dtype = _ODT_NP.get(in_elem or 1, np.float32)
    in_shape = tuple(int(d) if d else 1 for d in in_dims)
    out_name = model.outputs[0]

    # weights: every initializer a node consumes as a data operand
    # (scales/zero-points/shape vectors stay host-side consts — they are
    # structural, folded into the function)
    structural = set()
    for n in model.nodes:
        if n.op in ("QuantizeLinear", "DequantizeLinear"):
            structural.update(n.inputs[1:])
        elif n.op.startswith("QLinear"):
            # data operands are at fixed positions; the rest are q-params
            data = {0, 3} if n.op in ("QLinearConv", "QLinearMatMul",
                                      "QLinearAdd", "QLinearMul") else {0}
            for i, nm in enumerate(n.inputs):
                if i not in data and i != 8:  # 8 = QLinearConv bias
                    structural.add(nm)
        elif n.op == "Reshape":
            structural.update(n.inputs[1:])
    weights: Dict[str, np.ndarray] = {}
    for n in model.nodes:
        for nm in n.inputs:
            if nm in consts and nm not in structural:
                weights[nm] = consts[nm]  # OIHW stays: torch's layout

    int_sum = torch.float64 if qmode == "int8" else torch.float32
    on = DeviceConsts()

    def requant(acc_f, y_s, y_z, qdt=np.dtype(np.uint8)):
        """float accumulator → quantized activation (the epilogue)."""
        lo, hi, tdt = _RQ[qdt]
        y = torch.round(true_div(acc_f, y_s)) + y_z
        y = torch.clamp(y, lo, hi)
        if floatlike:
            return (y - y_z) * y_s  # real-valued, saturation preserved
        if qmode == "bf16":
            # the integer CODE in bf16: exact (fits the mantissa)
            return y.to(torch.bfloat16)
        return y.to(tdt)

    def lift(q, z):
        """quantized activation → integer-valued compute operand."""
        if floatlike:
            return q  # already real-valued (dequantized)
        return q.to(int_sum) - z

    def fn(params, x):
        dev = x.device
        vals: Dict[str, Any] = {in_name: x}
        # activations are NHWC internally; the exported graph is NCHW
        if len(in_shape) == 4:
            vals[in_name] = x.permute(0, 2, 3, 1)

        def get(nm):
            if nm in vals:
                return vals[nm]
            if nm in params:
                return params[nm]
            return on(nm, lambda: consts[nm], dev)

        def getw(nm, s, z):
            """weight operand in compute form (u8-resident on device)."""
            w = get(nm)
            if floatlike:
                if w.dtype not in (torch.uint8, torch.int8):
                    return w
                shp = _wshape(w.dim())
                return (w.float() - on(nm + "#z", lambda: z.astype(
                    np.float32).reshape(shp), dev)) * on(
                    nm + "#s", lambda: s.reshape(shp), dev)
            return w.to(int_sum) - on(
                nm + "#z", lambda: z.reshape(_wshape(w.dim())).astype(
                    np.float64 if qmode == "int8" else np.float32), dev)

        for n in model.nodes:
            op = n.op
            if op == "QuantizeLinear":
                s, z = _qparams(consts, n.inputs[1], n.inputs[2]
                                if len(n.inputs) > 2 else "")
                qdt = consts[n.inputs[2]].dtype if len(n.inputs) > 2 \
                    and n.inputs[2] in consts else np.dtype(np.uint8)
                xi = get(n.inputs[0]).float()
                vals[n.outputs[0]] = requant(xi, float(s[0]), int(z[0]),
                                             np.dtype(qdt))
            elif op == "DequantizeLinear":
                s, z = _qparams(consts, n.inputs[1], n.inputs[2]
                                if len(n.inputs) > 2 else "")
                q = get(n.inputs[0])
                if floatlike:
                    vals[n.outputs[0]] = q  # already real-valued
                else:
                    vals[n.outputs[0]] = \
                        (q.float() - float(z[0])) * float(s[0])
            elif op == "QLinearConv":
                (xn, xs, xz, wn, ws, wz, ys, yz) = n.inputs[:8]
                bias = n.inputs[8] if len(n.inputs) > 8 else None
                x_s, x_z = _qparams(consts, xs, xz)
                w_s, w_z = _qparams(consts, ws, wz)
                y_s, y_z = _qparams(consts, ys, yz)
                strides = tuple(n.attr_ints("strides", [1, 1]))
                group = n.attr_i("group", 1)
                pads = _pads4(n)
                xi = lift(get(xn), int(x_z[0]))
                # zero-valued padding is correct post-lift (x_zp removed)
                w = getw(wn, w_s, w_z)
                acc = conv2d_nhwc(xi, w, strides, pads, groups=group)
                acc = acc.float()
                if not floatlike:
                    # fold scales: per-channel w_s broadcasts over O
                    # (float mode operands are already real-valued)
                    acc = acc * on(n.outputs[0] + "#m", lambda: (
                        float(x_s[0]) * w_s).astype(np.float32).reshape(
                        1, 1, 1, -1), dev)
                if bias:
                    b = get(bias).float() * on(
                        n.outputs[0] + "#bs",
                        lambda: float(x_s[0]) * w_s.reshape(-1), dev)
                    acc = acc + b.reshape(1, 1, 1, -1)
                qdt = consts[yz].dtype if yz in consts \
                    else np.dtype(np.uint8)
                vals[n.outputs[0]] = requant(acc, float(y_s[0]),
                                             int(y_z[0]), np.dtype(qdt))
            elif op in ("QLinearAdd", "QLinearMul"):
                (an, as_, az, bn, bs, bz, cs, cz) = n.inputs[:8]
                a_s, a_z = _qparams(consts, as_, az)
                b_s, b_z = _qparams(consts, bs, bz)
                c_s, c_z = _qparams(consts, cs, cz)

                def as_real(v, sc, zp):
                    # float-mode activations are already real, but a
                    # quantized INITIALIZER operand (e.g. the
                    # classifier bias vector) arrives raw — dequantize
                    # by dtype, not by mode
                    if v.dtype in (torch.uint8, torch.int8):
                        return (v.float() - zp) * sc
                    return v

                if floatlike:
                    a = as_real(get(an), float(a_s[0]), float(a_z[0]))
                    b = as_real(get(bn), float(b_s[0]), float(b_z[0]))
                else:
                    a = (get(an).float() - float(a_z[0])) * float(a_s[0])
                    b = (get(bn).float() - float(b_z[0])) * float(b_s[0])
                r = a + b if op == "QLinearAdd" else a * b
                qdt = consts[cz].dtype if cz in consts \
                    else np.dtype(np.uint8)
                vals[n.outputs[0]] = requant(r, float(c_s[0]),
                                             int(c_z[0]), np.dtype(qdt))
            elif op == "QLinearGlobalAveragePool":
                (xn, xs, xz, ys, yz) = n.inputs[:5]
                x_s, x_z = _qparams(consts, xs, xz)
                y_s, y_z = _qparams(consts, ys, yz)
                if floatlike:
                    xi = get(xn)
                else:
                    xi = (get(xn).float() - float(x_z[0])) * float(x_s[0])
                if n.attr_i("channels_last", 0):
                    raise NotImplementedError(
                        "onnx: channels_last QLinearGlobalAveragePool")
                r = mean_hw(xi)  # NHWC, one order on every device
                qdt = consts[yz].dtype if yz in consts \
                    else np.dtype(np.uint8)
                vals[n.outputs[0]] = requant(r, float(y_s[0]),
                                             int(y_z[0]), np.dtype(qdt))
            elif op == "QLinearMatMul":
                (an, as_, az, bn, bs, bz, ys, yz) = n.inputs[:8]
                a_s, a_z = _qparams(consts, as_, az)
                b_s, b_z = _qparams(consts, bs, bz)
                y_s, y_z = _qparams(consts, ys, yz)
                a = lift(get(an), int(a_z[0]))
                b = getw(bn, b_s, b_z)
                acc = torch.matmul(a, b).float()
                if not floatlike:
                    acc = acc * on(n.outputs[0] + "#m", lambda: (
                        float(a_s[0]) * b_s.astype(np.float32)), dev)
                qdt = consts[yz].dtype if yz in consts \
                    else np.dtype(np.uint8)
                vals[n.outputs[0]] = requant(acc, float(y_s[0]),
                                             int(y_z[0]), np.dtype(qdt))
            elif op == "Reshape":
                v = get(n.inputs[0])
                tgt = tuple(int(t) for t in np.asarray(
                    consts[n.inputs[1]]).ravel())
                if v.dim() == 4:
                    if v.shape[1] != 1 or v.shape[2] != 1:
                        raise NotImplementedError(
                            "onnx: layout-sensitive Reshape on a 4-D "
                            f"activation {tuple(v.shape)} (NHWC internal)")
                    v = v.reshape(v.shape[0], -1)  # (B,1,1,C) → (B,C)
                tgt = batch_flex_target(
                    tgt, tuple(v.shape), int(x.shape[0]) if x.dim() else 1)
                vals[n.outputs[0]] = v.reshape(tgt)
            elif op == "Flatten":
                v = get(n.inputs[0])
                if v.dim() == 4 and (v.shape[1] != 1 or v.shape[2] != 1):
                    raise NotImplementedError(
                        "onnx: layout-sensitive Flatten (NHWC internal)")
                vals[n.outputs[0]] = v.reshape(v.shape[0], -1)
            # -- float ops (non-quantized graphs) -------------------------
            elif op == "Conv":
                xi, w = get(n.inputs[0]), get(n.inputs[1])  # w OIHW
                strides = tuple(n.attr_ints("strides", [1, 1]))
                group = n.attr_i("group", 1)
                y = conv2d_nhwc(xi, w, strides, _pads4(n), groups=group)
                if len(n.inputs) > 2:
                    y = y + get(n.inputs[2]).reshape(1, 1, 1, -1)
                vals[n.outputs[0]] = y
            elif op in ("Add", "Mul"):
                a, b = get(n.inputs[0]), get(n.inputs[1])
                vals[n.outputs[0]] = a + b if op == "Add" else a * b
            elif op == "Relu":
                vals[n.outputs[0]] = torch.clamp(get(n.inputs[0]), min=0.0)
            elif op == "Clip":
                # absent bounds mean -inf/+inf (a one-sided torch
                # clamp(min=0) export must NOT clamp above)
                lo = -np.inf
                hi = np.inf
                if len(n.inputs) > 1 and n.inputs[1]:
                    lo = float(np.asarray(consts[n.inputs[1]]).ravel()[0])
                elif "min" in n.attrs:
                    lo = float(n.attrs["min"].f)
                if len(n.inputs) > 2 and n.inputs[2]:
                    hi = float(np.asarray(consts[n.inputs[2]]).ravel()[0])
                elif "max" in n.attrs:
                    hi = float(n.attrs["max"].f)
                vals[n.outputs[0]] = torch.clamp(get(n.inputs[0]), lo, hi)
            elif op == "GlobalAveragePool":
                vals[n.outputs[0]] = mean_hw(get(n.inputs[0]))
            elif op in ("MaxPool", "AveragePool"):
                xi = get(n.inputs[0])
                ks = n.attr_ints("kernel_shape", [1, 1])
                st = n.attr_ints("strides", [1, 1])
                pool = max_pool_nhwc if op == "MaxPool" else avg_pool_nhwc
                vals[n.outputs[0]] = pool(xi, ks, st, _pads4(n))
            elif op == "MatMul":
                vals[n.outputs[0]] = get(n.inputs[0]) @ get(n.inputs[1])
            elif op == "Gemm":
                a, b = get(n.inputs[0]), get(n.inputs[1])
                if n.attr_i("transA", 0):
                    a = a.T
                if n.attr_i("transB", 0):
                    b = b.T
                alpha = n.attrs["alpha"].f if "alpha" in n.attrs else 1.0
                r = (a @ b) * alpha
                if len(n.inputs) > 2:
                    beta = n.attrs["beta"].f if "beta" in n.attrs else 1.0
                    r = r + beta * get(n.inputs[2])
                vals[n.outputs[0]] = r
            elif op == "Softmax":
                vals[n.outputs[0]] = torch.softmax(
                    get(n.inputs[0]), dim=n.attr_i("axis", -1))
            elif op == "Sigmoid":
                vals[n.outputs[0]] = torch.sigmoid(get(n.inputs[0]))
            elif op == "Concat":
                ax = n.attr_i("axis", 0)
                arrs = [get(i) for i in n.inputs]
                if arrs[0].dim() == 4:
                    # NCHW axis → NHWC axis
                    ax = {0: 0, 1: 3, 2: 1, 3: 2}[ax % 4]
                vals[n.outputs[0]] = torch.cat(arrs, dim=ax)
            elif op == "Transpose":
                perm = n.attr_ints("perm", [])
                v = get(n.inputs[0])
                if v.dim() == 4:
                    raise NotImplementedError(
                        "onnx: Transpose on 4-D activations (NHWC "
                        "internal layout)")
                vals[n.outputs[0]] = v.permute(
                    *(perm or reversed(range(v.dim()))))
        out = vals[out_name]
        if out.dim() == 4:  # restore the exported NCHW contract
            out = out.permute(0, 3, 1, 2)
        return out

    if floatlike:
        # dequantize weights once at load; scales/zps folded per use site
        fweights: Dict[str, np.ndarray] = {}
        wq: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for n in model.nodes:
            if n.op in ("QLinearConv", "QLinearMatMul"):
                wq[n.inputs[3]] = _qparams(consts, n.inputs[4], n.inputs[5])
        for nm, arr in weights.items():
            if nm in wq and arr.dtype in (np.uint8, np.int8):
                s, z = wq[nm]
                shp = _wshape(arr.ndim)
                fweights[nm] = (arr.astype(np.float32) -
                                z.reshape(shp)) * s.reshape(shp) \
                    if s.size > 1 else \
                    (arr.astype(np.float32) - float(z[0])) * float(s[0])
            else:
                fweights[nm] = arr
        weights = fweights

    return fn, weights, in_shape, in_dtype
