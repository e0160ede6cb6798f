"""``torch-cuda`` filter sub-plugin: in-process PyTorch models on the card.

Counterpart of the JAX package's ``filters/jax_xla.py`` for its
single-instance path: the ``register_model(name, fn, params, in_shapes,
in_dtypes)`` contract and :class:`ModelDef`, the fused transform prologue
and decoder epilogue (``set_fused_pre``/``set_fused_post``, installed by
runtime/fusion.py), and ``get_model_info``/``set_input_info``/``invoke``.

PyTorch runs eagerly, so there is no compile step: the per-frame program
is the composition prologue → model → epilogue, called under
``torch.inference_mode()``.  The weights are placed on the device once, at
configure.  The output schema is read off one call on zeros of the input
schema (PyTorch has no abstract evaluation that covers a whole model with
its data-dependent postprocess).

Not in this slice (later work): model files, a persistent cache, mesh /
sharding, micro-batching, shared pools, hot swap.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import DType, TensorsSpec
from ..utils.device import parse_accel_kind, resolve_device
from .api import FilterError, FilterProps, FilterSubplugin
from .registry import register_filter

# -- in-process model registry ----------------------------------------------

_models: Dict[str, "ModelDef"] = {}
_models_lock = threading.Lock()


def _place(obj: Any, device: torch.device) -> Any:
    """A copy of a params tree on ``device``: ``nn.Module``s (copied, put
    in eval mode), tensors, and dicts/lists/tuples of them; other leaves
    (ints, strings) pass through."""
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device).eval()
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _place(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_place(v, device) for v in obj)
    return obj


class ModelDef:
    """A model: ``fn(params, *inputs) -> output(s)`` (or ``fn(*inputs)``
    when params is None) plus its input schema."""

    def __init__(self, fn: Callable, params: Any = None,
                 in_spec: Optional[TensorsSpec] = None,
                 name: str = "<anonymous>"):
        self.fn = fn
        self.params = params
        self.in_spec = in_spec
        self.name = name
        self._dev_params: Dict[torch.device, Any] = {}
        self._lock = threading.Lock()

    def flat_fn(self, device: torch.device) -> Callable:
        """``fn(*inputs)`` with the params placed on ``device`` (once per
        device, then reused by every instance)."""
        if self.params is None:
            return self.fn
        with self._lock:
            if device not in self._dev_params:
                self._dev_params[device] = _place(self.params, device)
            params = self._dev_params[device]

        def fn(*inputs):
            return self.fn(params, *inputs)

        return fn


def register_model(name: str, fn: Callable, params: Any = None,
                   in_spec: Optional[TensorsSpec] = None,
                   in_shapes: Optional[Sequence] = None,
                   in_dtypes: Any = None) -> str:
    """Register a callable as a named model for ``model=name``."""
    if in_spec is None and in_shapes is not None:
        in_spec = TensorsSpec.from_shapes(
            in_shapes, in_dtypes if in_dtypes is not None else np.float32)
    with _models_lock:
        _models[name] = ModelDef(fn, params, in_spec, name)
    return name


def unregister_model(name: str) -> None:
    with _models_lock:
        _models.pop(name, None)


def get_model(name: str) -> Optional[ModelDef]:
    with _models_lock:
        return _models.get(name)


# -- the sub-plugin ----------------------------------------------------------


class _Program:
    """The per-frame callable for one input schema + its I/O specs.
    ``with_pre``/``with_post`` record whether a fused prologue/epilogue
    is in it, so negotiation can tell a stale program after the fusion
    pass re-derived."""

    __slots__ = ("fn", "in_spec", "out_spec", "with_pre", "with_post")

    def __init__(self, fn, in_spec: TensorsSpec, out_spec: TensorsSpec,
                 with_pre: bool, with_post: bool):
        self.fn = fn
        self.in_spec = in_spec
        self.out_spec = out_spec
        self.with_pre = with_pre
        self.with_post = with_post


@register_filter
class TorchCudaFilter(FilterSubplugin):
    NAME = "torch-cuda"
    ACCELERATORS = ("cuda", "cpu")
    ALLOCATE_IN_INVOKE = True

    def __init__(self):
        super().__init__()
        self._model: Optional[ModelDef] = None
        self._program: Optional[_Program] = None
        self._pre_chains: list = []  # fused transform op chains, in order
        self._post_fns: list = []    # fused downstream epilogue (≤1)

    def set_fused_pre(self, chains: list) -> None:
        """Install upstream transform op chains (runtime/fusion.py) to run
        as this filter's prologue.  They apply at the next
        ``set_input_info`` — negotiation always calls it when chains are
        present.  The list is kept BY REFERENCE: a transform that unfuses
        during negotiation removes its chain in place."""
        self._pre_chains = chains

    def set_fused_post(self, posts: list) -> None:
        """Install a downstream epilogue (runtime/fusion.py decoder
        fusion): a fn mapping the model's output tuple to the fused output
        tuple (the bounding-box device overlay).  Same by-reference
        contract as :meth:`set_fused_pre`."""
        self._post_fns = posts

    # -- lifecycle -----------------------------------------------------------

    def configure(self, props: FilterProps) -> None:
        super().configure(props)
        try:
            kind = parse_accel_kind(props.accelerator)
        except ValueError as e:
            raise FilterError(f"torch-cuda: {e}") from None
        if kind is not None:
            self.device = resolve_device(kind)
        else:
            self.device = props.device if props.device is not None \
                else resolve_device("cuda")
        self._model = self._resolve_model(props.model)
        in_spec = props.input_spec or self._model.in_spec
        if in_spec is None:
            raise FilterError(
                f"torch-cuda: model {self._model.name} has no input spec; "
                "pass input_spec or register with in_shapes")
        self._program = self._build(in_spec)

    def close(self) -> None:
        self._program = None
        self._model = None

    @staticmethod
    def _resolve_model(model) -> ModelDef:
        if isinstance(model, ModelDef):
            return model
        if isinstance(model, str):
            m = get_model(model)
            if m is not None:
                return m
            raise FilterError(
                f"torch-cuda: model {model!r} is not a registered name "
                "(model files are not supported by this port yet)")
        if callable(model):
            return ModelDef(model)
        raise FilterError(f"torch-cuda: unsupported model object {type(model)}")

    # -- program -------------------------------------------------------------

    def _pre_fns(self, in_spec: TensorsSpec) -> List[Callable]:
        """Per-input composition of the fused transform chains, each
        chain specialized to the schema flowing into it."""
        specs = list(in_spec.tensors)
        stages = []  # list of per-tensor fn lists, chain-major
        for chain in self._pre_chains:
            stages.append([chain.fn_for(sp) for sp in specs])
            specs = [chain.out_spec_of(sp) for sp in specs]

        def compose(i):
            fns = [st[i] for st in stages]

            def g(x):
                for f in fns:
                    x = f(x)
                return x

            return g

        return [compose(i) for i in range(len(in_spec.tensors))]

    def _build(self, in_spec: TensorsSpec) -> _Program:
        """The per-frame program for ``in_spec``: fused prologue + model +
        fused epilogue, outputs normalized to a tuple.  Its output schema
        comes from one call on zeros."""
        model_fn = self._model.flat_fn(self.device)
        pre = self._pre_fns(in_spec) if self._pre_chains else None
        post = self._post_fns[0] if self._post_fns else None

        def program(*inputs):
            if pre is not None:
                inputs = [g(x) for g, x in zip(pre, inputs)]
            out = model_fn(*inputs)
            out = tuple(out) if isinstance(out, (list, tuple)) else (out,)
            if post is not None:
                out = tuple(post(*out))
            return out

        zeros = [torch.zeros(t.shape, dtype=t.dtype.torch_dtype,
                             device=self.device) for t in in_spec.tensors]
        try:
            with torch.inference_mode():
                outs = program(*zeros)
        except (RuntimeError, ValueError, TypeError, IndexError) as e:
            raise FilterError(
                f"torch-cuda: model {self._model.name} rejects input "
                f"{in_spec}: {e}") from e
        out_spec = TensorsSpec.from_shapes(
            [tuple(o.shape) for o in outs],
            [DType.from_torch(o.dtype) for o in outs])
        return _Program(program, in_spec, out_spec,
                        with_pre=pre is not None, with_post=post is not None)

    # -- model info ----------------------------------------------------------

    def get_model_info(self) -> Tuple[TensorsSpec, TensorsSpec]:
        p = self._program
        if p is None:
            raise FilterError("torch-cuda: not configured")
        return p.in_spec, p.out_spec

    def set_input_info(self, in_spec: TensorsSpec
                       ) -> Tuple[TensorsSpec, TensorsSpec]:
        """Re-specialize the program to a new input schema (and to the
        fused stages currently installed)."""
        self._program = self._build(in_spec)
        return self._program.in_spec, self._program.out_spec

    # -- hot path ------------------------------------------------------------

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        p = self._program
        if p is None:
            raise FilterError("torch-cuda: not configured")
        inputs = [x if x.device == self.device else x.to(self.device)
                  for x in inputs]
        with torch.inference_mode():
            return list(p.fn(*inputs))
