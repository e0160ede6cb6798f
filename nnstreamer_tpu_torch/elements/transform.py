"""``tensor_transform`` — element-wise tensor stream ops.

Counterpart of the JAX package's ``elements/transform.py`` (parity target:
the reference's gsttensor_transform.c), for the modes this slice of the
port covers: ``typecast`` and ``arithmetic`` with its mini-language
(``typecast:float32,add:-127.5,div:127.5``, multi-op chains in one
instance, per-channel operands).  The other modes (``dimchg``,
``transpose``, ``stand``, ``clamp``, ``padding``) raise
``NotImplementedError`` naming the mode.

``backend=`` selects how a foldable affine arithmetic chain runs:
``torch`` (default) runs the chain as plain tensor ops; ``cuda`` folds it
to ``(x + b/a) * a`` and runs the hand-written kernel
(ops/kernels.py ``scale_bias_cast``; its plain version on the CPU).  The
JAX spellings ``xla`` and ``pallas`` are accepted as aliases so one launch
string parses in both packages.  A transform feeding a ``torch-cuda``
filter is fused into the filter's program (runtime/fusion.py).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core import Buffer, Caps, DType, Tensor, TensorSpec
from ..runtime.element import NegotiationError, Pad, TransformElement
from ..runtime.registry import register_element

#: backend= spellings → backend (the JAX names are aliases)
_BACKENDS = {"torch": "torch", "xla": "torch", "cuda": "cuda",
             "pallas": "cuda"}
_PORTED_MODES = ("typecast", "arithmetic")
_UNPORTED_MODES = ("dimchg", "transpose", "stand", "clamp", "padding")


# -- option grammar parsing --------------------------------------------------


def parse_arith_ops(option: str) -> List[Tuple[str, object]]:
    """Parse the arithmetic mini-language:
    ``typecast:float32,add:-127.5,div:127.5,per-channel-add:1;2;3``."""
    ops: List[Tuple[str, object]] = []
    for tok in option.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if ":" not in tok:
            raise ValueError(f"arithmetic op missing ':': {tok!r}")
        name, _, arg = tok.partition(":")
        name = name.strip().lower()
        if name == "typecast":
            ops.append(("typecast", DType.from_string(arg)))
        elif name in ("add", "sub", "mul", "div", "pow"):
            ops.append((name, float(arg)))
        elif name.startswith("per-channel-"):
            base = name[len("per-channel-"):]
            if base not in ("add", "sub", "mul", "div"):
                raise ValueError(f"bad per-channel op {name!r}")
            vec = np.array([float(v) for v in arg.split(";")],
                           dtype=np.float64)
            ops.append((f"pc-{base}", vec))
        else:
            raise ValueError(f"unknown arithmetic op {name!r}")
    if not ops:
        raise ValueError(f"empty arithmetic option {option!r}")
    return ops


def _fold_affine(ops, in_dtype: Optional[DType] = None) -> Optional[tuple]:
    """Fold ``[typecast:float32?] add/sub/mul/div…`` into (a, b, f32)
    with chain(x) == a*x + b, or None when the chain isn't a pure affine
    map (pow, per-channel, mid-chain casts) or when the unfused chain
    would NOT produce float32 — f16/bf16/f64 inputs keep their dtype under
    scalar type promotion, so folding them to the kernel's f32 would
    change the negotiated output schema."""
    a, b = 1.0, 0.0
    out_dt = DType.FLOAT32
    has_cast = ops and ops[0][0] == "typecast"
    if not has_cast and in_dtype is not None and in_dtype in (
            DType.FLOAT16, DType.BFLOAT16, DType.FLOAT64):
        return None  # chain would keep f16/bf16/f64 unfused
    for i, (name, arg) in enumerate(ops):
        if name == "typecast":
            if i != 0 or arg is not DType.FLOAT32:
                return None  # kernel computes in f32 only
        elif name == "add":
            b += arg
        elif name == "sub":
            b -= arg
        elif name == "mul":
            a *= arg
            b *= arg
        elif name == "div":
            if arg == 0:
                return None
            a /= arg
            b /= arg
        else:
            return None
    if a == 0:
        return None
    return a, b, out_dt


class _OpChain:
    """One transform instance's op list; builds a fn specialized to the
    negotiated input spec."""

    def __init__(self, mode: str, option: str, acceleration: bool = True,
                 backend: str = "torch"):
        if mode in _UNPORTED_MODES:
            raise NotImplementedError(
                f"tensor_transform mode={mode} is not ported to "
                "nnstreamer_tpu_torch yet")
        if mode not in _PORTED_MODES:
            raise ValueError(f"unknown transform mode {mode!r}")
        self.mode = mode
        self.option = option
        self.acceleration = acceleration
        self.backend = backend  # "torch" (default) | "cuda" (ops/ kernel)
        # per-(op, dtype, device) constants for per-channel operands, made
        # once instead of re-staged from the host on every frame
        self._const_cache: dict = {}

    def _pc_const(self, op_index: int, arr, x: torch.Tensor) -> torch.Tensor:
        key = (op_index, x.dtype, x.device)
        vec = self._const_cache.get(key)
        if vec is None:
            vec = torch.as_tensor(arr).to(device=x.device, dtype=x.dtype)
            self._const_cache[key] = vec
        return vec

    def digest(self) -> str:
        """Stable identity of this op chain (the fused segment's digest
        covers it)."""
        return "|".join((self.mode, self.option,
                         "1" if self.acceleration else "0", self.backend))

    def out_spec_of(self, spec: TensorSpec) -> TensorSpec:
        """Output schema, from the plain chain run on a shape-only
        ("meta") tensor — the kernel path is only taken where it yields
        the same schema (see :func:`_fold_affine`)."""
        x = torch.empty(spec.shape, dtype=spec.dtype.torch_dtype,
                        device="meta")
        o = self._plain_fn()(x)
        return TensorSpec.from_shape(tuple(o.shape),
                                     DType.from_torch(o.dtype),
                                     name=spec.name)

    def fn_for(self, spec: TensorSpec) -> Callable:
        """Return fn(tensor) -> tensor for this op chain on this schema."""
        if self.mode == "arithmetic" and self.acceleration \
                and self.backend == "cuda":
            from ..ops import scale_bias_cast, scale_bias_cast_available

            folded = _fold_affine(parse_arith_ops(self.option), spec.dtype)
            if folded is not None and \
                    scale_bias_cast_available(spec.shape, spec.dtype):
                a, b, out_dt = folded

                def fn(x, _a=a, _b=b, _dt=out_dt.torch_dtype):
                    return scale_bias_cast(x.contiguous(), _a, _b / _a, _dt)

                return fn
            if folded is not None:
                # f64: no kernel; the plain version computes at f64
                from ..ops import scale_bias_cast_reference

                a, b, out_dt = folded

                def fn(x, _a=a, _b=b, _dt=out_dt.torch_dtype):
                    return scale_bias_cast_reference(x, _a, _b / _a, _dt)

                return fn
        return self._plain_fn()

    def _plain_fn(self) -> Callable:
        if self.mode == "typecast":
            dt = DType.from_string(self.option).torch_dtype

            def fn(x):
                return x.to(dt)

            return fn
        ops = parse_arith_ops(self.option)

        def fn(x):
            for i, (name, arg) in enumerate(ops):
                if name == "typecast":
                    x = x.to(arg.torch_dtype)
                elif name == "add":
                    x = x + arg
                elif name == "sub":
                    x = x - arg
                elif name == "mul":
                    x = x * arg
                elif name == "div":
                    x = x / arg
                elif name == "pow":
                    x = x ** arg
                else:
                    # per-channel: channel = innermost dim (= last axis)
                    vec = self._pc_const(i, arg, x)
                    if name == "pc-add":
                        x = x + vec
                    elif name == "pc-sub":
                        x = x - vec
                    elif name == "pc-mul":
                        x = x * vec
                    else:
                        x = x / vec
            return x

        return fn


@register_element("tensor_transform")
class TensorTransform(TransformElement):
    FACTORY = "tensor_transform"

    def __init__(self, name=None, mode: str = "", option: str = "",
                 acceleration: bool = True, backend: str = "torch", **props):
        self.mode = mode
        self.option = option
        self.acceleration = acceleration
        self.backend = backend  # "torch" (default) | "cuda"; xla/pallas alias
        super().__init__(name, **props)
        self._chain_def: Optional[_OpChain] = None
        self._fns: List[Callable] = []
        # set by the pipeline fusion pass: this element's op chain runs
        # inside the downstream torch-cuda filter — act as passthrough
        self._fused = False
        self._fusion_filter = None  # the filter holding our op chain

    def _opchain(self) -> _OpChain:
        if self._chain_def is None:
            if not self.mode:
                raise NegotiationError(f"{self.name}: mode not set")
            backend = _BACKENDS.get(str(self.backend).lower())
            if backend is None:
                raise NegotiationError(
                    f"{self.name}: unknown backend {self.backend!r} "
                    f"(expected one of {', '.join(sorted(_BACKENDS))})")
            self._chain_def = _OpChain(self.mode, str(self.option),
                                       bool(self.acceleration), backend)
        return self._chain_def

    # -- negotiation ---------------------------------------------------------

    def _unfuse(self) -> None:
        """Back out of fusion: flexible streams run per buffer, so the
        pre-negotiation fusion decision is withdrawn and the op chain is
        returned from the downstream filter to this element."""
        self._fused = False
        flt = self._fusion_filter
        self._fusion_filter = None
        if flt is not None and self._chain_def is not None:
            try:
                flt._fused_pre.remove(self._chain_def)
            except ValueError:
                pass

    def propose_src_caps(self, pad: Pad) -> Caps:
        in_spec = self.sinkpad.spec
        if in_spec is None:
            raise NegotiationError(
                f"{self.name}: tensor_transform needs tensor input caps")
        if self._fused and not in_spec.is_static():
            self._unfuse()
        if self._fused or not in_spec.is_static():
            return Caps.from_spec(in_spec)  # chain runs in the filter / per buffer
        oc = self._opchain()
        try:
            outs = tuple(oc.out_spec_of(t) for t in in_spec.tensors)
        except (ValueError, TypeError, RuntimeError) as e:
            raise NegotiationError(
                f"{self.name}: mode={self.mode} option={self.option!r} "
                f"invalid for {in_spec}: {e}") from e
        return Caps.from_spec(in_spec.with_tensors(outs))

    def caps_negotiated(self, pad: Pad) -> None:
        in_spec = pad.spec
        if self._fused and (in_spec is None or not in_spec.is_static()):
            self._unfuse()  # flexible after all: run the chain here
        if self._fused or in_spec is None or not in_spec.is_static():
            self._fns = []
            return
        oc = self._opchain()
        self._fns = [oc.fn_for(t) for t in in_spec.tensors]

    # -- hot path ------------------------------------------------------------

    def transform(self, buf: Buffer) -> Buffer:
        if self._fused:
            return buf  # op chain executes inside the fused filter
        fns = self._fns or [self._opchain().fn_for(t.spec)
                            for t in buf.tensors]
        with torch.inference_mode():
            out = [Tensor(fn(t.torch(self.device)))
                   for fn, t in zip(fns, buf.tensors)]
        return Buffer(tensors=out, pts=buf.pts, duration=buf.duration,
                      offset=buf.offset, format=buf.format,
                      meta=dict(buf.meta))
