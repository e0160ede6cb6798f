"""``torch-cuda`` filter sub-plugin: in-process PyTorch models on the card.

Counterpart of the JAX package's ``filters/jax_xla.py``: the
``register_model(name, fn, params, in_shapes, in_dtypes)`` contract and
:class:`ModelDef`, the fused transform prologue and decoder epilogue
(``set_fused_pre``/``set_fused_post``, installed by runtime/fusion.py),
``get_model_info``/``set_input_info``/``invoke``, the micro-batched
``invoke_batched`` and the ``shared-tensor-filter-key`` table.  The
serving pool shares one instance among its sharers (runtime/serving.py
``ModelPool``, through the base ``open_shared``/``close_shared``).

PyTorch runs eagerly, so there is no compile step: the per-frame program
is the composition prologue → model → epilogue, called under
``torch.inference_mode()``.  The weights are placed on the device once, at
configure.  The output schema is read off one call on zeros of the input
schema (PyTorch has no abstract evaluation that covers a whole model with
its data-dependent postprocess).

A window of frames runs as ONE program call where the JAX package
``vmap``s the per-frame program (``torch.func.vmap`` has no rule for the
hand-written kernels, and a loop over frames would launch every kernel
once per frame): the frames are stacked, the prologue runs on the stack
per frame (``_OpChain.fn_for(lead=1)``), the window axis folds into the
model's leading axis — (bucket, 1, 256, 256, 3) → (bucket, 256, 256, 3)
— and the outputs split back per frame.  That holds for a model whose
leading axis is a batch of independent rows, and it is checked once per
(input schema, bucket), on the first window with two different frames:
every output's leading axis must scale with the window, and the rows of
the window's first and last frame must equal those frames run alone
(within ``FOLD_TOL``).  A model that fails either (a reduction over its
whole input, a rank-0 input, a normalisation or a sort across its
leading axis) runs the window frame by frame instead, as the JAX
package does for a framework without ``SUPPORTS_BATCH``.  The check
costs two lone calls per (schema, bucket); the verdict is cached.

Not in this slice (later work): model files, a persistent cache, mesh /
sharding, hot swap, donation (``custom=donate``).
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import DType, TensorsSpec
from ..core.buffer import from_numpy
from ..utils.device import parse_accel_kind, resolve_device
from .api import SHARED_MODELS, FilterError, FilterProps, FilterSubplugin
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
    """The per-frame callable for one input schema + its I/O specs, and
    ``window_fn``, the same program over a stacked window of frames with
    the window axis folded into the model's leading axis.
    ``with_pre``/``with_post`` record whether a fused prologue/epilogue
    is in it, so negotiation can tell a stale program after the fusion
    pass re-derived."""

    __slots__ = ("fn", "window_fn", "in_spec", "out_spec", "with_pre",
                 "with_post")

    def __init__(self, fn, window_fn, in_spec: TensorsSpec,
                 out_spec: TensorsSpec, with_pre: bool, with_post: bool):
        self.fn = fn
        self.window_fn = window_fn
        self.in_spec = in_spec
        self.out_spec = out_spec
        self.with_pre = with_pre
        self.with_post = with_post


#: how far a folded window's row may sit from its frame run alone, as
#: both atol and rtol: 16-bit float outputs, then the rest
FOLD_TOL = {torch.float16: 1e-2, torch.bfloat16: 1e-2}
FOLD_TOL_DEFAULT = 1e-3


def _rows_agree(row: torch.Tensor, alone: torch.Tensor) -> bool:
    """One output row of a folded window against the same frame run
    alone: equal for integer and bool outputs, within ``FOLD_TOL`` for
    floating ones (summation order may differ with the batch size)."""
    if tuple(row.shape) != tuple(alone.shape) or row.dtype != alone.dtype:
        return False
    if not row.dtype.is_floating_point:
        return bool(torch.equal(row, alone))
    tol = FOLD_TOL.get(row.dtype, FOLD_TOL_DEFAULT)
    return bool(torch.allclose(row.float(), alone.float(), rtol=tol,
                               atol=tol, equal_nan=True))


def _stack_window(col: Sequence[Any], bucket: int,
                  device: torch.device) -> torch.Tensor:
    """One input tensor of every frame of a window, stacked along a new
    leading axis on ``device`` and padded up to ``bucket`` rows by
    replaying the last frame.  Host frames are stacked on the host and
    copied once; device frames stack on the device."""
    pad = bucket - len(col)
    if all(isinstance(x, np.ndarray) for x in col):
        return from_numpy(np.stack(list(col) + [col[-1]] * pad), device)
    ts = [(x if isinstance(x, torch.Tensor) else from_numpy(x)).to(device)
          for x in col]
    return torch.stack(ts + [ts[-1]] * pad)


@register_filter
class TorchCudaFilter(FilterSubplugin):
    NAME = "torch-cuda"
    ACCELERATORS = ("cuda", "cpu")
    ALLOCATE_IN_INVOKE = True
    SUPPORTS_BATCH = True

    def __init__(self):
        super().__init__()
        self._model: Optional[ModelDef] = None
        self._program: Optional[_Program] = None
        self._pre_chains: list = []  # fused transform op chains, in order
        self._post_fns: list = []    # fused downstream epilogue (≤1)
        # window verdicts, keyed by (in_spec, bucket): True = the window
        # folds into one program call, False = it runs frame by frame
        self._batch_fold: Dict[Tuple[TensorsSpec, int], bool] = {}
        self._batch_lock = threading.Lock()
        self.batch_cache_hits = 0
        self.batch_cache_misses = 0
        self._cache_by_bucket: Dict[int, List[int]] = {}  # b -> [hit, miss]

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
        # shared-tensor-filter-key: instances naming one key on one
        # device share the model and its program
        table_key = f"torch-cuda:{props.shared_key}:{self.device}"
        if props.shared_key:
            shared = SHARED_MODELS.get(table_key)
            if shared is not None:
                self._model, self._program = shared
                return
        self._model = self._resolve_model(props.model)
        in_spec = props.input_spec or self._model.in_spec
        if in_spec is None:
            raise FilterError(
                f"torch-cuda: model {self._model.name} has no input spec; "
                "pass input_spec or register with in_shapes")
        self._program = self._build(in_spec)
        if props.shared_key:
            self._model, self._program = SHARED_MODELS.insert(
                table_key, (self._model, self._program))

    def close(self) -> None:
        self._program = None
        self._model = None
        with self._batch_lock:
            self._batch_fold.clear()

    def cache_snapshot(self) -> dict:
        """One consistent read of the per-bucket window-cache hit/miss
        counters (a miss is a window shape seen for the first time)."""
        with self._batch_lock:
            return {
                "hits": self.batch_cache_hits,
                "misses": self.batch_cache_misses,
                "by_bucket": {str(b): {"hits": hm[0], "misses": hm[1]}
                              for b, hm in
                              sorted(self._cache_by_bucket.items())},
            }

    def hot_buckets(self) -> Tuple[int, ...]:
        """Bucket sizes whose window has run on the current schema."""
        with self._batch_lock:
            return tuple(sorted({int(k[1]) for k in self._batch_fold}))

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

    def _pre_fns(self, in_spec: TensorsSpec, lead: int = 0) -> List[Callable]:
        """Per-input composition of the fused transform chains, each
        chain specialized to the schema flowing into it (behind ``lead``
        window axes)."""
        specs = list(in_spec.tensors)
        stages = []  # list of per-tensor fn lists, chain-major
        for chain in self._pre_chains:
            stages.append([chain.fn_for(sp, lead) for sp in specs])
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
        """The programs for ``in_spec``: fused prologue + model + fused
        epilogue, outputs normalized to a tuple, per frame and over a
        stacked window.  The output schema comes from one call on
        zeros."""
        model_fn = self._model.flat_fn(self.device)
        pre = self._pre_fns(in_spec) if self._pre_chains else None
        pre_w = self._pre_fns(in_spec, lead=1) if self._pre_chains else None
        post = self._post_fns[0] if self._post_fns else None

        def run(inputs):
            out = model_fn(*inputs)
            out = tuple(out) if isinstance(out, (list, tuple)) else (out,)
            if post is not None:
                out = tuple(post(*out))
            return out

        def program(*inputs):
            if pre is not None:
                inputs = [g(x) for g, x in zip(pre, inputs)]
            return run(inputs)

        def window_program(*stacked):
            """(bucket, *frame_shape) per input → the outputs with the
            window folded into their leading axis."""
            if pre_w is not None:
                stacked = [g(x) for g, x in zip(pre_w, stacked)]
            return run([x.reshape((-1,) + tuple(x.shape[2:]))
                        for x in stacked])

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
        return _Program(program, window_program, in_spec, out_spec,
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
        fused stages currently installed).  A pooled instance is never
        reshaped under other sharers: the element refuses first
        (``TensorFilter.caps_negotiated``)."""
        self._program = self._build(in_spec)
        with self._batch_lock:
            self._batch_fold.clear()  # verdicts are per schema
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

    def invoke_batched(self, frames: Sequence[Sequence[Any]],
                       bucket: int) -> List[List[Any]]:
        """Run ``frames`` (n per-frame input lists of tensors or host
        arrays, n <= bucket) as ONE program call on a window padded up
        to ``bucket`` by replaying the last frame; returns n per-frame
        output lists (views into the window's outputs).  A model that does
        not fold runs the window frame by frame (see the module doc)."""
        p = self._program
        if p is None:
            raise FilterError("torch-cuda: not configured")
        n = len(frames)
        if n == 0:
            return []
        if n > bucket:
            raise FilterError(f"torch-cuda: {n} frames exceed bucket {bucket}")
        key = (p.in_spec, bucket)
        with self._batch_lock:
            fold = self._batch_fold.get(key)
            hm = self._cache_by_bucket.setdefault(bucket, [0, 0])
            if fold is None:
                self.batch_cache_misses += 1
                hm[1] += 1
            else:
                self.batch_cache_hits += 1
                hm[0] += 1
        probe = fold is None
        if probe:
            fold = all(t.rank >= 1 for t in p.in_spec.tensors) and \
                all(t.rank >= 1 for t in p.out_spec.tensors)
        with torch.inference_mode():
            out, verdict = self._fold(p, frames, bucket, probe) if fold \
                else (None, False)
            if verdict is not None:
                with self._batch_lock:
                    if self._program is p:
                        self._batch_fold[key] = verdict
            if out is not None:
                return out
            return [self._run_alone(p, f) for f in frames]

    def _fold(self, p: _Program, frames: Sequence[Sequence[Any]],
              bucket: int, probe: bool):
        """The window as ONE folded program call: ``(per-frame outputs,
        verdict)``, outputs None when the window must run frame by frame.
        ``probe``: no verdict is cached yet, so the rows of the first and
        last frame are also held against those frames run alone; the
        verdict stays None (open) when those two frames are one input."""
        n = len(frames)
        window = [_stack_window([f[j] for f in frames], bucket, self.device)
                  for j in range(len(p.in_spec.tensors))]
        outs = p.window_fn(*window)
        want = [(bucket * t.shape[0],) + tuple(t.shape[1:])
                for t in p.out_spec.tensors]
        if [tuple(o.shape) for o in outs] != want:
            return None, False
        per = [o.reshape((bucket,) + tuple(t.shape))
               for o, t in zip(outs, p.out_spec.tensors)]
        verdict = True
        if probe:
            if not self._rows_independent(p, frames, per):
                return None, False
            # two equal probe frames cannot show a model that mixes rows
            if all(torch.equal(w[0], w[n - 1]) for w in window):
                verdict = None
        return [[o[i] for o in per] for i in range(n)], verdict

    def _run_alone(self, p: _Program, frame: Sequence[Any]) -> List[Any]:
        return list(p.fn(*[(x if isinstance(x, torch.Tensor)
                            else from_numpy(x)).to(self.device)
                           for x in frame]))

    def _rows_independent(self, p: _Program, frames: Sequence[Sequence[Any]],
                          per: Sequence[torch.Tensor]) -> bool:
        """Whether the folded window's rows of its first and last frame
        equal those frames run alone: False for a model that mixes the
        rows of its leading axis (it normalises, sorts or reduces across
        them), which then runs every window frame by frame."""
        for i in sorted({0, len(frames) - 1}):
            alone = self._run_alone(p, frames[i])
            if len(alone) != len(per) or not all(
                    _rows_agree(w[i], a) for w, a in zip(per, alone)):
                return False
        return True
