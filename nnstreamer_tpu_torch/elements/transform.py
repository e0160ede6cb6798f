"""``tensor_transform`` — element-wise and layout tensor stream ops.

Counterpart of the JAX package's ``elements/transform.py`` (parity target:
the reference's gsttensor_transform.c) with its seven modes:
``typecast``, ``arithmetic`` with its mini-language
(``typecast:float32,add:-127.5,div:127.5``, multi-op chains in one
instance, per-channel operands), ``transpose``, ``dimchg``, ``stand``,
``clamp`` and ``padding``.  Dimension indices in options are nnstreamer's,
innermost first.

``backend=`` selects how a foldable affine arithmetic chain runs:
``torch`` (default) runs the chain as plain tensor ops; ``cuda`` folds it
to ``(x + b/a) * a`` and runs the hand-written kernel
(ops/kernels.py ``scale_bias_cast``; its plain version on the CPU).  The
JAX spellings ``xla`` and ``pallas`` are accepted as aliases so one launch
string parses in both packages.  A transform feeding a ``torch-cuda``
filter is fused into the filter's program (runtime/fusion.py).

``donate=true`` hands the input frame over: a chain that keeps the
input's shape and float type runs in place on the input's memory when no
other tensor can see that memory, and the input is marked donated either
way (a later read raises ``DonatedTensorError``).

``stand`` takes its mean and variance accumulated in float64 and rounded
to float32, then multiplies by ``1 / (std + 1e-10)``: that reproduces the
committed golden byte for byte, which the JAX package's own
``(x - mean) / (std + 1e-10)`` misses by one ulp.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import Buffer, Caps, DType, Tensor, TensorSpec
from ..runtime.element import NegotiationError, Pad, TransformElement
from ..runtime.registry import register_element

#: backend= spellings → backend (the JAX names are aliases)
_BACKENDS = {"torch": "torch", "xla": "torch", "cuda": "cuda",
             "pallas": "cuda"}
_MODES = ("typecast", "arithmetic", "transpose", "dimchg", "stand", "clamp",
          "padding")
_STAND_EPS = 1e-10


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


def _dim_axis(rank: int, dim_index: int) -> int:
    """nnstreamer dim index (innermost-first) → tensor axis."""
    return rank - 1 - dim_index


def _stand_stats(xf: torch.Tensor, axis, keepdim: bool):
    """Mean and population std of float32 ``xf`` over ``axis``, each
    accumulated in float64 and rounded to float32 (see the module doc)."""
    mean = xf.double().mean(dim=axis, keepdim=keepdim).float()
    d = xf - mean
    std = (d.double() ** 2).mean(dim=axis, keepdim=keepdim).sqrt().float()
    return mean, d, std


class _OpChain:
    """One transform instance's op list; builds a fn specialized to the
    negotiated input spec."""

    def __init__(self, mode: str, option: str, acceleration: bool = True,
                 backend: str = "torch"):
        if mode not in _MODES:
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
        o = self._plain_fn(spec.rank)(x)
        return TensorSpec.from_shape(tuple(o.shape),
                                     DType.from_torch(o.dtype),
                                     name=spec.name)

    def fn_for(self, spec: TensorSpec, lead: int = 0) -> Callable:
        """Return fn(tensor) -> tensor for this op chain on this schema.

        ``lead`` leading axes ahead of the schema's own are a window of
        frames (a micro-batched filter runs its fused prologue on the
        stacked window): axes are addressed past them and ``stand``
        reduces per frame, so each frame comes out as it would alone."""
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
        return self._plain_fn(spec.rank, lead)

    def inplace_fn_for(self, spec: TensorSpec) -> Optional[Callable]:
        """fn(x) that writes the chain's result into ``x`` itself, or
        None where the chain changes the shape or type, or runs on the
        kernel (which writes a new tensor).  In-place and plain results
        are bit-equal: the same ops in the same order."""
        dt = spec.dtype.torch_dtype
        out = self.out_spec_of(spec)
        if not dt.is_floating_point or spec.rank == 0 or \
                (out.shape, out.dtype) != (spec.shape, spec.dtype):
            return None
        if self.mode == "typecast":
            return lambda x: x
        if self.mode == "clamp":
            lo, hi = self._clamp_bounds()
            return lambda x: x.clamp_(lo, hi)
        if self.mode == "stand":
            kind, per_channel = self._stand_opts()
            axis = tuple(range(spec.rank - (1 if per_channel else 0)))

            def stand_(x):
                mean, _, std = _stand_stats(x, axis, per_channel)
                x.sub_(mean)
                if kind == "default":
                    x.mul_(torch.reciprocal(std + _STAND_EPS))
                return x

            return stand_
        if self.mode != "arithmetic":
            return None
        ops = parse_arith_ops(self.option)
        if any(n == "typecast" and a.torch_dtype != dt for n, a in ops):
            return None
        if self.acceleration and self.backend == "cuda" and \
                _fold_affine(ops, spec.dtype) is not None:
            return None

        def arith_(x):
            for i, (name, arg) in enumerate(ops):
                if name in ("add", "pc-add"):
                    x.add_(arg if name == "add" else self._pc_const(i, arg, x))
                elif name in ("sub", "pc-sub"):
                    x.sub_(arg if name == "sub" else self._pc_const(i, arg, x))
                elif name in ("mul", "pc-mul"):
                    x.mul_(arg if name == "mul" else self._pc_const(i, arg, x))
                elif name in ("div", "pc-div"):
                    x.div_(arg if name == "div" else self._pc_const(i, arg, x))
                elif name == "pow":
                    x.pow_(arg)
            return x

        return arith_

    def _clamp_bounds(self) -> Tuple[float, float]:
        lo, _, hi = self.option.partition(":")
        return float(lo), float(hi)

    def _stand_opts(self) -> Tuple[str, bool]:
        opt = self.option.split(":")
        kind = opt[0].strip().lower() or "default"
        if kind not in ("default", "dc-average"):
            raise ValueError(f"unknown stand mode {kind!r}")
        return kind, len(opt) > 1 and opt[1].strip() == "per-channel"

    def _plain_fn(self, rank: int, lead: int = 0) -> Callable:
        """The chain as plain tensor ops for frames of ``rank`` axes
        behind ``lead`` window axes."""
        mode, option = self.mode, self.option
        if mode == "typecast":
            dt = DType.from_string(option).torch_dtype
            return lambda x: x.to(dt)
        if mode == "arithmetic":
            return self._arith_fn(parse_arith_ops(option))
        if mode == "transpose":
            # option "1:0:2:3": new dim i comes from old dim perm[i]
            # (innermost-first); unspecified outer dims keep their place
            perm = [int(p) for p in option.split(":") if p.strip()]
            if len(perm) != rank:
                perm = perm + list(range(len(perm), rank))
            axes = list(range(lead)) + [
                lead + rank - 1 - perm[rank - 1 - ax] for ax in range(rank)]
            return lambda x: x.permute(axes).contiguous()
        if mode == "dimchg":
            # option "from:to" moves dim index from→to (innermost-first)
            f, _, t = option.partition(":")
            src = lead + _dim_axis(rank, int(f))
            dst = lead + _dim_axis(rank, int(t))
            return lambda x: torch.movedim(x, src, dst).contiguous()
        if mode == "stand":
            kind, per_channel = self._stand_opts()
            # per frame: every axis of the frame, or all but the channel
            axis = tuple(range(lead, lead + (rank - 1 if per_channel
                                             else rank)))
            keep = bool(per_channel or lead)

            def stand(x):
                xf = x.to(torch.float32)
                if not axis:  # a rank-0 frame is its own mean
                    return xf - xf
                mean, d, std = _stand_stats(xf, axis, keep)
                if kind == "dc-average":
                    return d
                return d * torch.reciprocal(std + _STAND_EPS)

            return stand
        if mode == "clamp":
            lo, hi = self._clamp_bounds()
            return lambda x: torch.clamp(x, lo, hi)
        if mode == "padding":
            # option "d0b:d0e,d1b:d1e,...[,value:v]" innermost-first: the
            # order F.pad takes its (begin, end) pairs in
            pads: List[int] = []
            value = 0.0
            for tok in option.split(","):
                tok = tok.strip()
                if not tok:
                    continue
                if tok.startswith("value:"):
                    value = float(tok[len("value:"):])
                    continue
                b, _, e = tok.partition(":")
                pads += [int(b), int(e) if e else int(b)]
            if len(pads) > 2 * rank:
                raise ValueError(f"padding {option!r} names more dims than "
                                 f"the tensor's {rank}")
            return lambda x: F.pad(x, pads, value=value)
        raise ValueError(f"unknown transform mode {mode!r}")

    def _arith_fn(self, ops) -> Callable:
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


def _sole_storage(t: Tensor, x: torch.Tensor) -> bool:
    """Whether ``x`` (the device payload of ``t``) is the only thing that
    can see its memory: not a view, the whole of its storage, no host or
    wire copy that may alias it (``torch.from_numpy`` shares memory), and
    not handed to several branches by a ``tee``."""
    return (t._host is None and t._raw is None and not t._shared
            and x._base is None
            and x.storage_offset() == 0
            and x.untyped_storage().nbytes() == x.numel() * x.element_size())


@register_element("tensor_transform")
class TensorTransform(TransformElement):
    FACTORY = "tensor_transform"

    #: bound of the flexible-stream cache of per-schema fns
    FLEX_CACHE_MAX = 64

    def __init__(self, name=None, mode: str = "", option: str = "",
                 acceleration: bool = True, backend: str = "torch",
                 donate: bool = False, **props):
        self.mode = mode
        self.option = option
        self.acceleration = acceleration
        self.backend = backend  # "torch" (default) | "cuda"; xla/pallas alias
        self.donate = donate
        super().__init__(name, **props)
        self._chain_def: Optional[_OpChain] = None
        self._fns: List[Callable] = []
        self._inplace: List[Optional[Callable]] = []
        # set by the pipeline fusion pass: this element's op chain runs
        # inside the downstream torch-cuda filter — act as passthrough
        self._fused = False
        self._fusion_filter = None  # the filter holding our op chain
        # flexible streams: (shape, dtype) → (fn, in-place fn), LRU-bounded
        self._flex_cache: "OrderedDict" = OrderedDict()

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

    def _fns_of(self, spec: TensorSpec) -> Tuple[Callable, Optional[Callable]]:
        oc = self._opchain()
        return oc.fn_for(spec), (oc.inplace_fn_for(spec) if self.donate
                                 else None)

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
        except (ValueError, TypeError, RuntimeError, IndexError) as e:
            raise NegotiationError(
                f"{self.name}: mode={self.mode} option={self.option!r} "
                f"invalid for {in_spec}: {e}") from e
        return Caps.from_spec(in_spec.with_tensors(outs))

    def caps_negotiated(self, pad: Pad) -> None:
        in_spec = pad.spec
        if self._fused and (in_spec is None or not in_spec.is_static()):
            self._unfuse()  # flexible after all: run the chain here
        if self._fused or in_spec is None or not in_spec.is_static():
            self._fns, self._inplace = [], []
            return
        pairs = [self._fns_of(t) for t in in_spec.tensors]
        self._fns = [f for f, _ in pairs]
        self._inplace = [g for _, g in pairs]

    # -- hot path ------------------------------------------------------------

    def _flex_fns(self, spec: TensorSpec):
        """Schema-keyed cache for flexible streams: each distinct
        per-buffer schema builds its fns once."""
        key = (spec.shape, spec.dtype)
        fns = self._flex_cache.get(key)
        if fns is None:
            fns = self._fns_of(spec)
            self._flex_cache[key] = fns
            while len(self._flex_cache) > self.FLEX_CACHE_MAX:
                self._flex_cache.popitem(last=False)
        else:
            self._flex_cache.move_to_end(key)
        return fns

    def transform(self, buf: Buffer) -> Buffer:
        if self._fused:
            return buf  # op chain executes inside the fused filter
        if self._fns:
            pairs = list(zip(self._fns, self._inplace))
        else:  # flexible stream: per-buffer schema
            pairs = [self._flex_fns(t.spec) for t in buf.tensors]
        out = []
        with torch.inference_mode():
            for (fn, inplace), t in zip(pairs, buf.tensors):
                x = t.torch(self.device)
                if inplace is not None and _sole_storage(t, x):
                    out.append(Tensor(inplace(x)))
                else:
                    out.append(Tensor(fn(x)))
        if self.donate:
            buf.mark_donated()
        return Buffer(tensors=out, pts=buf.pts, duration=buf.duration,
                      offset=buf.offset, format=buf.format,
                      meta=dict(buf.meta))
