"""Minimal .tflite model importer: flatbuffer reader + graph → torch.

Counterpart of the JAX package's ``filters/tflite_import.py`` (parity
target: the reference's flagship tensorflow-lite filter sub-plugin, which
loads a .tflite file and invokes it through the TFLite interpreter).  The
graph is IMPORTED instead of interpreted: the hand-rolled flatbuffer walk
(no flatc codegen), a copy of the JAX package's, extracts tensors,
quantization params and the operator list, and the network is rebuilt as
one PyTorch function that runs eagerly on the card.  Execution modes,
``custom=qmode:<mode>``:

- ``auto`` (the default): ``bf16`` for a quantized graph, else ``float``
  — as in the JAX package.  On a quantized graph this is APPROXIMATE:
  weights and activations are real values rounded to bf16, not the
  graph's integer codes (``dequant`` is the exact mode).
- ``bf16``: weights dequantized at load and stored bf16; activations
  bf16; each activation clamped to its quantized range.
- ``dequant``: quantized execution — weights and inter-op activations
  stay uint8/int8 on the device; each conv/matmul lifts its operands to
  float32 integer values (exact) with a float32 accumulator (exact while
  the sums stay below 2**24, as in the JAX package), and the
  requantize epilogue (``s_x*s_w/s_y``, round, add the zero point, clip,
  narrow) keeps the JAX package's order of float operations
  (_build_fn_quant).
- ``float``: dequantize everything at load, run float32 with the
  output-range saturation clamps.

Supported op set covers the reference's test models (mobilenet_v1/v2
classifiers and friends): CONV_2D, DEPTHWISE_CONV_2D, ADD, MUL, PAD,
AVERAGE_POOL_2D, MAX_POOL_2D, FULLY_CONNECTED, RESHAPE, SQUEEZE, SOFTMAX,
MEAN, RELU, RELU6, LOGISTIC, CONCATENATION, RESIZE_BILINEAR.  Anything
else raises with the op name so the gap is explicit.

SAME padding is asymmetric at stride 2 (importer_ops.same_pad), and an
AVERAGE_POOL_2D under SAME divides by the count of valid cells: both are
padded by hand, since PyTorch's convolutions and pools pad only
symmetrically.  A depthwise weight (1, kh, kw, C·M) runs as ``groups=C``
with weight (C·M, 1, kh, kw).

Precision: no switch of PyTorch's is set here, so a pipeline runs under
its own (by default cuDNN convolutions take TF32 operands, matmuls stay
float32).  ``dequant`` (codes of at most 255 enter TF32 unrounded) and
``auto``/``bf16`` (bf16 convolutions) give the same outputs either way.
``float`` on the card lies within 0.5 output quanta of the CPU with TF32
off and within 1 under the default (0.0 and 0.375 read on an H100,
``chip_smoke.py`` phase 21b).
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
    pad_nd,
    pads_of,
    same_pad,
    true_div,
)
from .importer_util import batch_flex_target

# -- flatbuffer primitives ---------------------------------------------------


class _FB:
    """Just enough of the flatbuffers binary format to walk a .tflite:
    root offset, vtable-indexed field lookup, vectors, strings."""

    def __init__(self, buf: bytes):
        self.b = buf

    def u8(self, p):
        return self.b[p]

    def u16(self, p):
        return struct.unpack_from("<H", self.b, p)[0]

    def i32(self, p):
        return struct.unpack_from("<i", self.b, p)[0]

    def u32(self, p):
        return struct.unpack_from("<I", self.b, p)[0]

    def i64(self, p):
        return struct.unpack_from("<q", self.b, p)[0]

    def f32(self, p):
        return struct.unpack_from("<f", self.b, p)[0]

    def root(self) -> int:
        return self.u32(0)

    def field(self, table: int, fid: int) -> Optional[int]:
        """Absolute position of field ``fid``'s inline data, or None if
        absent (vtable default)."""
        vt = table - self.i32(table)
        if 4 + 2 * fid >= self.u16(vt):
            return None
        off = self.u16(vt + 4 + 2 * fid)
        return table + off if off else None

    def indirect(self, p: int) -> int:
        return p + self.u32(p)

    def table_field(self, table: int, fid: int) -> Optional[int]:
        p = self.field(table, fid)
        return None if p is None else self.indirect(p)

    def vec(self, table: int, fid: int) -> Optional[Tuple[int, int]]:
        """(start, length) of a vector field; elements follow ``start``."""
        p = self.field(table, fid)
        if p is None:
            return None
        v = self.indirect(p)
        return v + 4, self.u32(v)

    def vec_i32(self, table: int, fid: int) -> Optional[np.ndarray]:
        se = self.vec(table, fid)
        if se is None:
            return None
        s, n = se
        return np.frombuffer(self.b, "<i4", count=n, offset=s).copy()

    def vec_f32(self, table: int, fid: int) -> Optional[np.ndarray]:
        se = self.vec(table, fid)
        if se is None:
            return None
        s, n = se
        return np.frombuffer(self.b, "<f4", count=n, offset=s).copy()

    def vec_i64(self, table: int, fid: int) -> Optional[np.ndarray]:
        se = self.vec(table, fid)
        if se is None:
            return None
        s, n = se
        return np.frombuffer(self.b, "<i8", count=n, offset=s).copy()

    def vec_bytes(self, table: int, fid: int) -> Optional[bytes]:
        se = self.vec(table, fid)
        if se is None:
            return None
        s, n = se
        return self.b[s:s + n]

    def vec_tables(self, table: int, fid: int) -> List[int]:
        se = self.vec(table, fid)
        if se is None:
            return []
        s, n = se
        return [self.indirect(s + 4 * i) for i in range(n)]

    def string(self, table: int, fid: int) -> str:
        p = self.field(table, fid)
        if p is None:
            return ""
        v = self.indirect(p)
        n = self.u32(v)
        return self.b[v + 4:v + 4 + n].decode("utf-8", "replace")

    def scalar(self, table: int, fid: int, kind: str, default=0):
        p = self.field(table, fid)
        if p is None:
            return default
        return getattr(self, kind)(p)


# -- tflite schema field ids (schema.fbs) ------------------------------------

# TensorType
_TT_FLOAT32, _TT_FLOAT16, _TT_INT32 = 0, 1, 2
_TT_UINT8, _TT_INT64, _TT_INT8 = 3, 4, 9
_TT_NP = {_TT_FLOAT32: np.float32, _TT_FLOAT16: np.float16,
          _TT_INT32: np.int32, _TT_UINT8: np.uint8, _TT_INT64: np.int64,
          _TT_INT8: np.int8}

# BuiltinOperator (deprecated_builtin_code values; 3.x models use these)
_OPS = {0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
        4: "DEPTHWISE_CONV_2D", 9: "FULLY_CONNECTED", 14: "LOGISTIC",
        17: "MAX_POOL_2D", 18: "MUL", 19: "RELU", 21: "RELU6",
        22: "RESHAPE", 23: "RESIZE_BILINEAR", 25: "SOFTMAX", 34: "PAD",
        40: "MEAN", 43: "SQUEEZE"}

_ACT = {0: None, 1: "relu", 3: "relu6"}


def _act(code: int):
    """Map a fused_activation_function code; raise on unsupported codes
    (RELU_N1_TO_1=2, TANH=4, SIGN_BIT=5) so the gap is explicit rather
    than a silently dropped activation."""
    if code not in _ACT:
        raise NotImplementedError(
            f"tflite: unsupported fused_activation_function code {code}")
    return _ACT[code]


class TFLiteTensor:
    __slots__ = ("shape", "ttype", "buffer", "name", "scale", "zero",
                 "qdim")

    def __init__(self, shape, ttype, buffer, name, scale, zero, qdim=0):
        self.shape, self.ttype, self.buffer = shape, ttype, buffer
        self.name, self.scale, self.zero = name, scale, zero
        self.qdim = qdim


class TFLiteModel:
    """Parsed model: tensor table, constant buffers, operator list."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            buf = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                buf = f.read()
        fb = _FB(buf)
        model = fb.indirect(0)
        # Model: version=0 operator_codes=1 subgraphs=2 desc=3 buffers=4
        self.opcodes = []
        for oc in fb.vec_tables(model, 1):
            # OperatorCode: deprecated_builtin_code=0 (int8),
            # custom_code=1, version=2, builtin_code=3 (int32)
            code = fb.scalar(oc, 3, "i32", 0) or fb.scalar(oc, 0, "u8", 0)
            self.opcodes.append(_OPS.get(code, f"op#{code}"))
        self.buffers = []
        for b in fb.vec_tables(model, 4):
            self.buffers.append(fb.vec_bytes(b, 0))
        subgraphs = fb.vec_tables(model, 2)
        if not subgraphs:
            raise ValueError("tflite: no subgraphs")
        sg = subgraphs[0]
        # SubGraph: tensors=0 inputs=1 outputs=2 operators=3 name=4
        self.tensors: List[TFLiteTensor] = []
        for t in fb.vec_tables(sg, 0):
            # Tensor: shape=0 type=1 buffer=2 name=3 quantization=4
            q = fb.table_field(t, 4)
            scale = zero = None
            qdim = 0
            if q is not None:
                # QuantizationParameters: min=0 max=1 scale=2
                # zero_point=3 details_type=4 details=5
                # quantized_dimension=6
                sc = fb.vec_f32(q, 2)
                zp = fb.vec_i64(q, 3)
                if sc is not None and sc.size:
                    scale = sc
                    zero = zp if zp is not None and zp.size else \
                        np.zeros_like(sc, np.int64)
                    qdim = fb.scalar(q, 6, "i32", 0)
            self.tensors.append(TFLiteTensor(
                fb.vec_i32(t, 0), fb.scalar(t, 1, "u8", 0),
                fb.scalar(t, 2, "u32", 0), fb.string(t, 3), scale, zero,
                qdim))
        def _ids(vec):
            return [] if vec is None else [int(v) for v in vec]

        self.inputs = _ids(fb.vec_i32(sg, 1))
        self.outputs = _ids(fb.vec_i32(sg, 2))
        self.operators = []
        for op in fb.vec_tables(sg, 3):
            # Operator: opcode_index=0 inputs=1 outputs=2
            #           builtin_options_type=3 builtin_options=4
            self.operators.append({
                "op": self.opcodes[fb.scalar(op, 0, "u32", 0)],
                "inputs": _ids(fb.vec_i32(op, 1)),
                "outputs": _ids(fb.vec_i32(op, 2)),
                "options": fb.table_field(op, 4),
            })
        self._fb = fb

    # -- constants -----------------------------------------------------------

    def const(self, idx: int, dequant: bool = True) -> Optional[np.ndarray]:
        """Materialize tensor ``idx``'s constant data (dequantized to
        float32 when it carries quantization params), or None if it is
        an activation (empty buffer)."""
        t = self.tensors[idx]
        raw = self.buffers[t.buffer] if t.buffer < len(self.buffers) else None
        if not raw:
            return None
        arr = np.frombuffer(raw, _TT_NP[t.ttype]).reshape(
            t.shape if t.shape is not None and len(t.shape) else -1)
        if dequant and t.scale is not None and \
                t.ttype in (_TT_UINT8, _TT_INT8):
            scale, zero = t.scale, t.zero
            if scale.size > 1:  # per-channel along quantized_dimension
                shape = [1] * arr.ndim
                shape[t.qdim] = scale.size
                scale = scale.reshape(shape)
                zero = zero.reshape(shape)
            arr = (arr.astype(np.float32) - zero.astype(np.float32)) * \
                scale.astype(np.float32)
        elif dequant and t.scale is not None and t.ttype == _TT_INT32:
            # bias: int32 with scale = input_scale * weight_scale
            scale = t.scale
            if scale.size > 1:
                scale = scale.reshape([-1])
            arr = arr.astype(np.float32) * scale.astype(np.float32)
        return arr


# -- graph → torch ------------------------------------------------------------

_TT_TORCH = {_TT_FLOAT32: torch.float32, _TT_FLOAT16: torch.float16,
             _TT_INT32: torch.int32, _TT_UINT8: torch.uint8,
             _TT_INT64: torch.int64, _TT_INT8: torch.int8}


def _resize_bilinear(x: torch.Tensor, oh: int, ow: int,
                     align_corners: bool, half_pixel: bool) -> torch.Tensor:
    """NHWC bilinear resize matching TFLite's three sampling grids
    (half-pixel centers / align-corners / legacy floor)."""

    def axis_coords(n_in, n_out):
        # on the host, then copied: the grid is the same on every device
        i = torch.arange(n_out, dtype=torch.float32)
        if align_corners and n_out > 1:
            src = i * (n_in - 1) / (n_out - 1)
        elif half_pixel:
            src = (i + 0.5) * n_in / n_out - 0.5
        else:
            src = i * n_in / n_out
        src = torch.clamp(src, 0.0, n_in - 1)
        lo = torch.floor(src).long()
        hi = torch.clamp(lo + 1, max=n_in - 1)
        w = src - lo.float()
        return lo.to(x.device), hi.to(x.device), w.to(x.device)

    h_lo, h_hi, h_w = axis_coords(x.shape[1], oh)
    w_lo, w_hi, w_w = axis_coords(x.shape[2], ow)
    top = x.index_select(1, h_lo)
    bot = x.index_select(1, h_hi)
    rows = top + (bot - top) * h_w[None, :, None, None]
    left = rows.index_select(2, w_lo)
    right = rows.index_select(2, w_hi)
    return left + (right - left) * w_w[None, None, :, None]


#: ops whose SECOND input is structural (shapes/axes/sizes read when the
#: function runs, not tensor data)
_STRUCTURAL_OPS = {"RESHAPE", "PAD", "MEAN", "RESIZE_BILINEAR"}


def _mean(v: torch.Tensor, axes, keep: bool) -> torch.Tensor:
    """MEAN: over H and W of an NHWC tensor in one fixed order
    (``importer_ops.mean_hw``), else a reduction kernel."""
    if v.dim() == 4 and sorted(a % 4 for a in axes) == [1, 2]:
        y = mean_hw(v)
        return y if keep else y.reshape(y.shape[0], -1)
    return v.mean(dim=axes, keepdim=keep)


def _conv_weight(w: torch.Tensor, depthwise: bool) -> torch.Tensor:
    """A TFLite conv weight in PyTorch's OIHW: CONV_2D's OHWI permuted;
    DEPTHWISE_CONV_2D's (1, kh, kw, C·M) as (C·M, 1, kh, kw), run with
    ``groups=C``."""
    return w.permute(3, 0, 1, 2) if depthwise else w.permute(0, 3, 1, 2)


def _squeeze(v: torch.Tensor, fb, op) -> torch.Tensor:
    """SqueezeOptions: squeeze_dims=0 (list); absent → all size-1 dims
    EXCEPT the batch axis (keep the schema batch-flexible, same contract
    as RESHAPE)."""
    dims = [] if op["options"] is None else [
        int(d) for d in _opt_ints(fb, op["options"], 0)]
    if not dims:
        dims = [d for d in range(1, v.dim()) if v.shape[d] == 1]
    return v.squeeze(tuple(dims)) if dims else v


def _reshape(fbm, op, consts, v: torch.Tensor, x: torch.Tensor):
    ins, outs = op["inputs"], op["outputs"]
    shape = consts.get(ins[1]) if len(ins) > 1 else None
    if shape is None:
        shape = fbm.tensors[outs[0]].shape
    tgt = batch_flex_target(
        tuple(int(s) for s in shape), tuple(v.shape),
        int(x.shape[0]) if x.dim() else 1,
        recorded_src=fbm.tensors[ins[0]].shape)
    return v.reshape(tgt)


def build_fn(model: TFLiteModel, qmode: str = "auto"):
    """Compile the op list into ``fn(params, x) -> output`` (single
    input/output graphs — the reference's filter contract for its test
    models).  Weights travel in ``params`` (a {tensor_index: array} dict
    the filter layer places on the device); structural constants
    (reshape shapes, pad widths, reduce axes) stay host-side.  Output is
    float32.  Returns (fn, params, in_shape, in_dtype).  ``qmode``: see
    the module doc."""
    fbm = model
    if qmode not in ("auto", "bf16", "dequant", "float"):
        raise ValueError(f"tflite: unknown qmode {qmode!r}")
    quantized = fbm.tensors[fbm.inputs[0]].scale is not None and \
        fbm.tensors[fbm.inputs[0]].ttype in (_TT_UINT8, _TT_INT8)
    if qmode == "auto":
        # the JAX package's choice (bf16 measured fastest on its chip);
        # approximate on a quantized graph, see the module doc
        qmode = "bf16" if quantized else "float"
    if qmode == "dequant":
        if not quantized:
            raise ValueError(
                "tflite: qmode dequant needs a quantized graph")
        return _build_fn_quant(fbm)
    in_idx = fbm.inputs[0]
    out_idx = fbm.outputs[0]
    consts: Dict[int, Any] = {}
    for i in range(len(fbm.tensors)):
        c = fbm.const(i)
        if c is not None:
            consts[i] = c
    fb = fbm._fb
    structural = set()
    for op in fbm.operators:
        if op["op"] in _STRUCTURAL_OPS and len(op["inputs"]) > 1:
            structural.add(op["inputs"][1])
    weights: Dict[str, Any] = {str(i): arr for i, arr in consts.items()
                               if i not in structural}
    cdt = torch.bfloat16 if qmode == "bf16" else torch.float32
    if qmode == "bf16":
        # bf16-resident weights and activations; the output returns f32
        weights = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cdt)
                   if getattr(v, "dtype", None) == np.float32 else v
                   for k, v in weights.items()}

    def opt(op, fid, kind, default=0):
        return default if op["options"] is None else \
            fb.scalar(op["options"], fid, kind, default)

    def in_cdt(v: float) -> float:
        """A Python float as the compute dtype rounds it (JAX's weak
        typing casts a scalar operand to the array's dtype)."""
        return float(torch.tensor(v, dtype=cdt))

    def fn(params, x):
        t = fbm.tensors[in_idx]
        x = x.to(cdt)
        if t.scale is not None:
            x = (x - torch.tensor(float(t.zero[0]), dtype=cdt)) * \
                torch.tensor(float(t.scale[0]), dtype=cdt)
        vals: Dict[int, Any] = {in_idx: x}

        def get(i):
            if i in vals:
                return vals[i]
            key = str(i)
            if key in params:
                return params[key]
            return torch.as_tensor(consts[i], device=x.device)

        for op in fbm.operators:
            name = op["op"]
            ins, outs = op["inputs"], op["outputs"]
            if name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                dw = name == "DEPTHWISE_CONV_2D"
                xi, w = get(ins[0]), get(ins[1])
                b = get(ins[2]) if len(ins) > 2 and ins[2] >= 0 else None
                sh, sw = opt(op, 2, "u32", 1), opt(op, 1, "u32", 1)
                pad = opt(op, 0, "u8", 0)  # 0=SAME 1=VALID
                # Conv2DOptions: dilation_w=4 dilation_h=5;
                # DepthwiseConv2DOptions: dilation_w=5 dilation_h=6
                fd = 5 if dw else 4
                dw_, dh = opt(op, fd, "u32", 1) or 1, \
                    opt(op, fd + 1, "u32", 1) or 1
                padding = [same_pad(xi.shape[1], sh, w.shape[1], dh),
                           same_pad(xi.shape[2], sw, w.shape[2], dw_)] \
                    if pad == 0 else [(0, 0), (0, 0)]
                y = conv2d_nhwc(xi, _conv_weight(w, dw), (sh, sw), padding,
                                (dh, dw_),
                                groups=xi.shape[-1] if dw else 1)
                if b is not None:
                    y = y + b
                act = _act(opt(op, 4 if dw else 3, "u8", 0))
            elif name == "ADD":
                y = get(ins[0]) + get(ins[1])
                act = _act(opt(op, 0, "u8", 0))
            elif name == "MUL":
                y = get(ins[0]) * get(ins[1])
                act = _act(opt(op, 0, "u8", 0))
            elif name == "PAD":
                y = pad_nd(get(ins[0]), np.asarray(consts[ins[1]]))
                act = None
            elif name in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
                xi = get(ins[0])
                sh, sw = opt(op, 2, "u32", 1), opt(op, 1, "u32", 1)
                kw, kh = opt(op, 3, "u32", 1), opt(op, 4, "u32", 1)
                padmode = "SAME" if opt(op, 0, "u8", 0) == 0 else "VALID"
                pads = pads_of(padmode, xi, (kh, kw), (sh, sw))
                # average over the actual window population (SAME pads
                # contribute neither sum nor count — TF semantics)
                pool = max_pool_nhwc if name == "MAX_POOL_2D" \
                    else avg_pool_nhwc
                y = pool(xi, (kh, kw), (sh, sw), pads)
                act = _act(opt(op, 5, "u8", 0))
            elif name == "MEAN":
                axes = tuple(int(a) for a in np.asarray(consts[ins[1]]))
                keep = bool(opt(op, 0, "u8", 0))
                y = _mean(get(ins[0]), axes, keep)
                act = None
            elif name == "FULLY_CONNECTED":
                xi, w = get(ins[0]), get(ins[1])
                y = xi.reshape(xi.shape[0], -1) @ w.T
                if len(ins) > 2 and ins[2] >= 0 and ins[2] in consts:
                    y = y + get(ins[2])
                act = _act(opt(op, 0, "u8", 0))
            elif name == "RESHAPE":
                y = _reshape(fbm, op, consts, get(ins[0]), x)
                act = None
            elif name == "SQUEEZE":
                y = _squeeze(get(ins[0]), fb, op)
                act = None
            elif name == "RESIZE_BILINEAR":
                xi = get(ins[0])
                oh, ow = (int(v) for v in np.asarray(consts[ins[1]]))
                # ResizeBilinearOptions: align_corners=2
                # half_pixel_centers=3; the three TF sampling grids
                align = bool(opt(op, 2, "u8", 0))
                half = bool(opt(op, 3, "u8", 0))
                y = _resize_bilinear(xi, oh, ow, align, half)
                act = None
            elif name == "SOFTMAX":
                beta = opt(op, 0, "f32", 1.0) or 1.0
                y = torch.softmax(get(ins[0]) * in_cdt(beta), dim=-1)
                act = None
            elif name == "LOGISTIC":
                y = torch.sigmoid(get(ins[0]))
                act = None
            elif name == "RELU":
                y = torch.clamp(get(ins[0]), min=0.0)
                act = None
            elif name == "RELU6":
                y = torch.clamp(get(ins[0]), 0.0, 6.0)
                act = None
            elif name == "CONCATENATION":
                axis = opt(op, 0, "i32", 0)
                y = torch.cat([get(i) for i in ins], dim=axis)
                act = _act(opt(op, 1, "u8", 0))
            else:
                raise NotImplementedError(
                    f"tflite: unsupported op {name} "
                    f"(inputs {[fbm.tensors[i].name for i in ins]})")
            if act == "relu":
                y = torch.clamp(y, min=0.0)
            elif act == "relu6":
                y = torch.clamp(y, 0.0, 6.0)
            # Quantized graphs encode activations in the OUTPUT tensor's
            # representable range (fused_activation_function stays NONE;
            # e.g. a Relu6 output has zero_point 0, scale 6/255): clamp
            # each activation to its quantized range, reproducing both
            # the nonlinearity and uint8 saturation in float.
            to = fbm.tensors[outs[0]]
            if to.scale is not None and to.ttype in (_TT_UINT8, _TT_INT8):
                qmin, qmax = (0, 255) if to.ttype == _TT_UINT8 \
                    else (-128, 127)
                sc, zp = float(to.scale[0]), float(to.zero[0])
                y = torch.clamp(y, in_cdt((qmin - zp) * sc),
                                in_cdt((qmax - zp) * sc))
            vals[outs[0]] = y
        return vals[out_idx].float()

    in_t = fbm.tensors[in_idx]
    in_shape = tuple(int(s) for s in in_t.shape)
    in_dtype = _TT_NP[in_t.ttype]
    return fn, weights, in_shape, in_dtype


def _opt_ints(fb, options, fid):
    """Read a flatbuffer int-vector option field (e.g. squeeze_dims)."""
    vec = fb.vec_i32(options, fid)
    return [] if vec is None else list(vec)


def _build_fn_quant(fbm: TFLiteModel):
    """Quantized execution: activations travel uint8/int8 between ops,
    weights stay in their stored integer dtype, and each conv/matmul
    lifts its operands to integer-valued float32 (exact), accumulating
    float32 (the JAX package lifts to bf16 with a float32 accumulator:
    the same products).  The requantize epilogue — one float32 multiply
    (``s_x*s_w/s_y``), round, clip, narrow — keeps the JAX package's
    order of operations, so ties round alike.

    Padding note: PAD and SAME-padding pad the LIFTED (zero-point-
    subtracted) operand, so zero-valued padding is exact.
    """
    in_idx = fbm.inputs[0]
    out_idx = fbm.outputs[0]
    consts_raw: Dict[int, Any] = {}
    for i in range(len(fbm.tensors)):
        c = fbm.const(i, dequant=False)
        if c is not None:
            consts_raw[i] = c
    fb = fbm._fb
    structural = set()
    for op in fbm.operators:
        if op["op"] in _STRUCTURAL_OPS and len(op["inputs"]) > 1:
            structural.add(op["inputs"][1])
    weights = {str(i): arr for i, arr in consts_raw.items()
               if i not in structural}
    on = DeviceConsts()

    def opt(op, fid, kind, default=0):
        return default if op["options"] is None else \
            fb.scalar(op["options"], fid, kind, default)

    def qp(i):
        t = fbm.tensors[i]
        if t.scale is None:
            return None
        return (t.scale.astype(np.float32), t.zero.astype(np.float32),
                t.qdim, t.ttype)

    def fn(params, x):
        dev = x.device

        def get(i):
            if i in vals:
                return vals[i]
            key = str(i)
            if key in params:
                return params[key]
            return on(f"c{i}", lambda: consts_raw[i], dev)

        def lift(i, ndim_for_qdim=None):
            """tensor i → integer-valued float32 (zero-point removed)."""
            v = get(i)
            q = qp(i)
            if q is None:
                # the JAX package lifts to bf16: a real operand rounds
                return v.to(torch.bfloat16).float()
            s, z, qdim, _tt = q
            if z.size > 1 and ndim_for_qdim is not None:
                shape = [1] * ndim_for_qdim
                shape[qdim] = z.size
                return v.float() - on(f"z{i}", lambda: z.reshape(shape),
                                      dev)
            return v.float() - float(z[0])

        def deq(i, v=None):
            """tensor i → real-valued f32."""
            v = get(i) if v is None else v
            q = qp(i)
            if q is None:
                return v.float()
            s, z, qdim, _tt = q
            if s.size > 1:
                shape = [1] * v.dim()
                shape[qdim] = s.size
                return (v.float() - on(f"dz{i}", lambda: z.reshape(shape),
                                       dev)) * \
                    on(f"ds{i}", lambda: s.reshape(shape), dev)
            return (v.float() - float(z[0])) * float(s[0])

        def req(i, real, act=None):
            """real-valued f32 → tensor i's quantized storage."""
            if act == "relu":
                real = torch.clamp(real, min=0.0)
            elif act == "relu6":
                real = torch.clamp(real, 0.0, 6.0)
            q = qp(i)
            if q is None:
                return real
            s, z, _qdim, tt = q
            lo, hi = (0, 255) if tt == _TT_UINT8 else (-128, 127)
            y = torch.round(true_div(real, float(s[0]))) + float(z[0])
            return torch.clamp(y, lo, hi).to(
                torch.uint8 if tt == _TT_UINT8 else torch.int8)

        def mult(o, ins, shape):
            """The requantize multiplier ``s_x * s_w`` (per channel)."""
            def make():
                s_x = float(qp(ins[0])[0][0])
                return (s_x * qp(ins[1])[0]).reshape(shape)

            return on(f"m{o}", make, dev)

        # input: accept the declared quantized dtype directly, or
        # requantize a float input (e.g. an upstream transform)
        t_in = fbm.tensors[in_idx]
        vals: Dict[int, Any] = {}
        if x.dtype == _TT_TORCH[t_in.ttype]:
            vals[in_idx] = x
        else:
            vals[in_idx] = req(in_idx, x.float())

        for op in fbm.operators:
            name = op["op"]
            ins, outs = op["inputs"], op["outputs"]
            o = outs[0]
            if name in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                dw = name == "DEPTHWISE_CONV_2D"
                xi = lift(ins[0])
                w_raw = get(ins[1])
                w = lift(ins[1], ndim_for_qdim=4)
                act = _act(opt(op, 4 if dw else 3, "u8", 0))
                sh, sw = opt(op, 2, "u32", 1), opt(op, 1, "u32", 1)
                pad = opt(op, 0, "u8", 0)
                fd = 5 if dw else 4
                d_w = opt(op, fd, "u32", 1) or 1
                d_h = opt(op, fd + 1, "u32", 1) or 1
                kh, kw = w_raw.shape[1], w_raw.shape[2]
                padding = [same_pad(xi.shape[1], sh, kh, d_h),
                           same_pad(xi.shape[2], sw, kw, d_w)] \
                    if pad == 0 else [(0, 0), (0, 0)]
                acc = conv2d_nhwc(xi, _conv_weight(w, dw), (sh, sw),
                                  padding, (d_h, d_w),
                                  groups=xi.shape[-1] if dw else 1)
                # bias: int32 at scale s_x*s_w — same units as acc
                if len(ins) > 2 and ins[2] >= 0:
                    acc = acc + get(ins[2]).float()
                vals[o] = req(o, acc * mult(o, ins, (1, 1, 1, -1)), act)
            elif name == "FULLY_CONNECTED":
                xi = lift(ins[0])
                xi = xi.reshape(xi.shape[0], -1)
                w = lift(ins[1], ndim_for_qdim=2)
                act = _act(opt(op, 0, "u8", 0))
                acc = xi @ w.T
                if len(ins) > 2 and ins[2] >= 0 and ins[2] in consts_raw:
                    acc = acc + get(ins[2]).float()
                vals[o] = req(o, acc * mult(o, ins, (1, -1)), act)
            elif name in ("ADD", "MUL"):
                act = _act(opt(op, 0, "u8", 0))
                a, b = deq(ins[0]), deq(ins[1])
                vals[o] = req(o, a + b if name == "ADD" else a * b, act)
            elif name == "PAD":
                # quantized pad: fill with the zero-point (real 0)
                q = qp(ins[0])
                fill = 0 if q is None else int(q[1][0])
                vals[o] = pad_nd(get(ins[0]), np.asarray(consts_raw[ins[1]]),
                                 value=fill)
            elif name == "MAX_POOL_2D":
                # max is monotone in q-space: pool the u8/i8 directly
                # (pads = dtype min, so negative int8 windows and SAME
                # padding cannot inject spurious zeros)
                sh, sw = opt(op, 2, "u32", 1), opt(op, 1, "u32", 1)
                kw_, kh_ = opt(op, 3, "u32", 1), opt(op, 4, "u32", 1)
                padmode = "SAME" if opt(op, 0, "u8", 0) == 0 else "VALID"
                act = _act(opt(op, 5, "u8", 0))
                xi = get(ins[0])
                pooled = max_pool_nhwc(
                    xi, (kh_, kw_), (sh, sw),
                    pads_of(padmode, xi, (kh_, kw_), (sh, sw)))
                if act is not None:
                    # rare: fused act on a quantized maxpool — apply in
                    # real space against the INPUT qparams (maxpool
                    # preserves them), requantize to the output
                    vals[o] = req(o, deq(ins[0], pooled), act)
                else:
                    vals[o] = pooled
            elif name == "AVERAGE_POOL_2D":
                sh, sw = opt(op, 2, "u32", 1), opt(op, 1, "u32", 1)
                kw_, kh_ = opt(op, 3, "u32", 1), opt(op, 4, "u32", 1)
                padmode = "SAME" if opt(op, 0, "u8", 0) == 0 else "VALID"
                act = _act(opt(op, 5, "u8", 0))
                xi = deq(ins[0])
                vals[o] = req(o, avg_pool_nhwc(
                    xi, (kh_, kw_), (sh, sw),
                    pads_of(padmode, xi, (kh_, kw_), (sh, sw))), act)
            elif name == "MEAN":
                axes = tuple(int(a) for a in
                             np.asarray(consts_raw[ins[1]]))
                keep = bool(opt(op, 0, "u8", 0))
                vals[o] = req(o, _mean(deq(ins[0]), axes, keep))
            elif name == "SQUEEZE":
                vals[o] = _squeeze(get(ins[0]), fb, op)
            elif name == "RESHAPE":
                vals[o] = _reshape(fbm, op, consts_raw, get(ins[0]), x)
            elif name == "CONCATENATION":
                axis = opt(op, 0, "i32", 0)
                act = _act(opt(op, 1, "u8", 0))
                vals[o] = req(o, torch.cat([deq(i) for i in ins], dim=axis),
                              act)
            elif name == "SOFTMAX":
                beta = opt(op, 0, "f32", 1.0) or 1.0
                vals[o] = req(o, torch.softmax(deq(ins[0]) * beta, dim=-1))
            elif name == "LOGISTIC":
                vals[o] = req(o, torch.sigmoid(deq(ins[0])))
            elif name == "RELU":
                vals[o] = req(o, torch.clamp(deq(ins[0]), min=0.0))
            elif name == "RELU6":
                vals[o] = req(o, torch.clamp(deq(ins[0]), 0.0, 6.0))
            elif name == "RESIZE_BILINEAR":
                oh, ow = (int(v) for v in
                          np.asarray(consts_raw[ins[1]]))
                align = bool(opt(op, 2, "u8", 0))
                half = bool(opt(op, 3, "u8", 0))
                vals[o] = req(o, _resize_bilinear(
                    deq(ins[0]), oh, ow, align, half))
            else:
                raise NotImplementedError(
                    f"tflite: unsupported op {name} in quantized "
                    f"execution "
                    f"(inputs {[fbm.tensors[i].name for i in ins]})")
        return deq(out_idx, vals[out_idx])

    in_t = fbm.tensors[in_idx]
    in_shape = tuple(int(s) for s in in_t.shape)
    in_dtype = _TT_NP[in_t.ttype]
    return fn, weights, in_shape, in_dtype
