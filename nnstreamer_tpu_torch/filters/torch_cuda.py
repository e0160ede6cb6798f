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

Model files (``model=`` a path, or ``file://…@tag``; the per-instance
seam :meth:`TorchCudaFilter._load_file`, which the importer frameworks of
``onnx.py``, ``tflite.py`` and ``tensorflow.py`` override): ``.npz`` and
``.safetensors`` weights files (``models/params_io.py``: the JAX
package's pytree layout, numpy leaves, plus an ``apply`` "module:callable"
naming a port callable ``fn(params, *inputs)``) and ``.pkl`` dicts.
Serialized XLA programs (``.jaxexp``/``.stablehlo``/``.mlir``) and flax
``.msgpack`` raise :class:`FilterError` naming the format.

Double-buffered hot swap (``runtime/lifecycle.py`` drives it):
:meth:`TorchCudaFilter.prepare_swap` builds a SHADOW instance off the
dispatch path — its weights copied to the card and its fold verdicts
taken on seeded, distinct frames at every hot bucket — and
:meth:`~TorchCudaFilter.commit_swap` flips (model, program, verdicts) in
under ``_swap_lock``, which every dispatch reads them under as one
snapshot.  ``custom=donate`` marks the tensors a dispatch was handed as
donated (the element and the pool do the marking).

Observability: the weights' placement on the card is recorded in the
transfer ledger (reason ``weights``), :meth:`TorchCudaFilter.weight_bytes`
gives the pooled model's footprint (``nns_model_weight_bytes``), and each
program's forward is counted once for ``obs/xlacost.py`` — the
single-frame program on the call on zeros that reads its output schema,
a window bucket on its first (fold-checked) dispatch.  The fold check's
verdicts cross to the host as recorded drains.

Placement (``mesh=``/``sharding=``/``devices=``, ``parallel/``): the
placement resolves once, at configure.  An invoke splits its batch over
the data axes in contiguous rows, in stack order (what
``obs/meshstat.shard_split`` assumes), runs every shard on its lead
device with that device's weight replica or ``model``-axis slices, and
gathers the outputs on the mesh's first device; a batch that does not
divide runs once, replicated.  A window stacks once and dispatches
sharded: each shard's rows run the fused prologue and the model on their
own device, so a kernel of the path launches once per shard.  Every
output is tagged with its mesh's device ids (``parallel.mesh.set_home``)
for the stage handoff of ``tensor_filter devices=``.  On a multi-process
(``dcn.``) placement each process runs its own rows; a single-frame
invoke gathers every process's rows (``all_gather``).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import importlib
import json
import os
import pickle
import struct
import threading
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import DType, TensorsSpec
from ..core.buffer import from_numpy
from ..obs import transfer as _xfer
from ..obs import xlacost as _xlacost
from ..obs.hwspec import device_platform
from ..ops.kernels import shape_only
from ..runtime.events import Event, EventKind
from ..utils import profile as _profile
from ..utils.device import parse_accel_kind, resolve_device
from .api import SHARED_MODELS, FilterError, FilterProps, FilterSubplugin
from .modeluri import resolve_model_uri
from .registry import register_filter

# -- in-process model registry ----------------------------------------------

_models: Dict[str, "ModelDef"] = {}
_models_lock = threading.Lock()


def _place(obj: Any, device: torch.device) -> Any:
    """A copy of a params tree on ``device``: ``nn.Module``s (copied, put
    in eval mode), tensors, numpy arrays and scalars (as tensors — a
    weights file's leaves), and dicts/lists/tuples of them; other leaves
    (ints, strings) pass through.  Uploads to the card are recorded in
    the transfer ledger as ``weights``."""
    if isinstance(obj, torch.nn.Module):
        m = copy.deepcopy(obj)
        moved = [t for t in list(m.parameters()) + list(m.buffers())
                 if not _xfer.on_card(t)]
        m = m.to(device).eval()
        if _xfer.ACTIVE and _xfer.on_card(device) and moved:
            _xfer.LEDGER.record("h2d", "weights",
                                sum(t.numel() * t.element_size()
                                    for t in moved))
        return m
    if isinstance(obj, torch.Tensor):
        return _xfer.move(obj, device, "weights")
    if isinstance(obj, (np.ndarray, np.generic)):
        return from_numpy(np.asarray(obj), device, reason="weights")
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
        #: placement key -> parallel.sharded.MeshParams
        self._mesh_params: Dict[Tuple, Any] = {}
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

    def shard_fn(self, rp: Any, group: Sequence[Any]) -> Callable:
        """Like :meth:`flat_fn` for one data shard of placement ``rp``:
        the params laid over the mesh per its rules (placed once per
        distinct device group, then reused by every instance)."""
        if self.params is None:
            return self.fn
        with self._lock:
            mp = self._mesh_params.get(rp.key)
            if mp is None:
                mp = self._mesh_params[rp.key] = rp.shard_params(
                    self.params, place=_place)
            params = mp.tree(group)

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


# -- model files ---------------------------------------------------------------

#: weights files and pickled dicts this port loads
MODEL_FILE_TYPES = (".npz", ".safetensors", ".pkl")
#: serialized XLA programs: the JAX package runs them, PyTorch cannot
XLA_PROGRAM_TYPES = (".jaxexp", ".stablehlo", ".mlir")


def _load_file(path: str) -> ModelDef:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".npz", ".safetensors"):
        return _load_weights_file(path, ext)
    if ext == ".pkl":
        return _load_pickled(path)
    if ext in XLA_PROGRAM_TYPES:
        raise FilterError(
            f"torch-cuda: {path}: {ext} is a serialized XLA program, which "
            "PyTorch cannot run; write the weights with models.params_io "
            "and name a port callable as 'apply'")
    if ext == ".msgpack":
        raise FilterError(
            f"torch-cuda: {path}: .msgpack needs flax, which this port "
            "does not use")
    raise FilterError(f"torch-cuda: unsupported model file type {ext!r}")


def _load_weights_file(path: str, ext: str) -> ModelDef:
    """A weights file (models/params_io.py): the JAX package's pytree
    (numpy leaves) plus an ``apply`` "module:callable" naming a port
    callable ``fn(params, *inputs)``, its ``apply_kwargs`` and the input
    schema in the metadata."""
    from ..models.params_io import load_npz, load_safetensors

    try:
        params, meta = (load_npz(path) if ext == ".npz"
                        else load_safetensors(path))
        in_shapes, kwargs = meta.get("in_shapes"), meta.get("apply_kwargs")
        if isinstance(in_shapes, str):
            in_shapes = json.loads(in_shapes)
        if isinstance(kwargs, str):
            kwargs = json.loads(kwargs)
    except (ValueError, KeyError, OSError, struct.error) as e:
        raise FilterError(f"torch-cuda: {path}: {e}") from e
    apply = meta.get("apply")
    if not apply:
        raise FilterError(
            f"torch-cuda: {path} carries no 'apply' metadata (write it "
            "with models.params_io.save_npz/save_safetensors)")
    fn = _resolve_apply(apply, path, kwargs)
    in_spec = None
    if in_shapes:
        in_spec = TensorsSpec.from_shapes(
            in_shapes, np.dtype(meta.get("in_dtypes") or "float32"))
    return ModelDef(fn, params, in_spec, name=path)


def _resolve_apply(target: Any, path: str,
                   kwargs: Optional[dict] = None) -> Callable:
    """``apply`` of a model file: a callable, or a "module:callable"
    import path; ``kwargs`` are bound to it by keyword."""
    if isinstance(target, str):
        mod, _, attr = target.partition(":")
        try:
            target = getattr(importlib.import_module(mod), attr)
        except (ImportError, AttributeError, ValueError) as e:
            raise FilterError(
                f"torch-cuda: cannot resolve apply {target!r} ({path}): "
                f"{e}") from e
    if not callable(target):
        raise FilterError(f"torch-cuda: bad apply entry {type(target)} "
                          f"({path})")
    if kwargs:
        if not isinstance(kwargs, dict):
            raise FilterError(f"torch-cuda: {path}: apply_kwargs must be "
                              f"an object, got {type(kwargs)}")
        return functools.partial(target, **kwargs)
    return target


def _load_pickled(path: str) -> ModelDef:
    """A pickled dict: ``apply`` ("module:callable" or a callable),
    ``params`` (the weight pytree), optional ``apply_kwargs``,
    ``in_shapes`` and ``in_dtypes``."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if not isinstance(blob, dict) or "apply" not in blob:
        raise FilterError(
            f"torch-cuda: {path} must hold a dict with an 'apply' "
            "\"module:callable\" entry")
    fn = _resolve_apply(blob["apply"], path, blob.get("apply_kwargs"))
    in_spec = None
    if blob.get("in_shapes") is not None:
        in_spec = TensorsSpec.from_shapes(
            blob["in_shapes"], blob.get("in_dtypes", np.float32))
    return ModelDef(fn, blob.get("params"), in_spec, name=path)


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
#: how far a frame's batch split over a mesh's data shards may sit from
#: the whole batch run once, as both atol and rtol: the check only has to
#: tell a batch of independent rows from a model that mixes them (off by
#: O(1)), while a 16-bit compute may round differently with the shard's
#: batch size (another convolution algorithm)
SPLIT_TOL = 5e-2


def _rows_agree(row: torch.Tensor, alone: torch.Tensor,
                tol: Optional[float] = None) -> bool:
    """One output row of a folded window against the same frame run
    alone: equal for integer and bool outputs, within ``tol`` (default
    ``FOLD_TOL``) for floating ones (summation order may differ with the
    batch size)."""
    if tuple(row.shape) != tuple(alone.shape) or row.dtype != alone.dtype:
        return False
    if not row.dtype.is_floating_point:
        return _on_host((row == alone).all())
    if tol is None:
        tol = FOLD_TOL.get(row.dtype, FOLD_TOL_DEFAULT)
    return _on_host(torch.isclose(row.float(), alone.float(), rtol=tol,
                                  atol=tol, equal_nan=True).all())


def _on_host(verdict: torch.Tensor) -> bool:
    """A device verdict read on the host: one recorded drain."""
    return bool(_xfer.to_host(verdict))


def _seeded_inputs(spec: TensorsSpec, device: torch.device,
                   rng: Optional[np.random.Generator] = None
                   ) -> List[torch.Tensor]:
    """Seeded inputs of schema ``spec`` on ``device`` (from ``rng``, else
    seed 0): normal floats, random bools, integers in [0, 100)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    frame = []
    for t in spec.tensors:
        dt = t.dtype.np_dtype
        if np.issubdtype(dt, np.floating):
            a = rng.standard_normal(t.shape).astype(dt)
        elif dt == np.bool_:
            a = rng.integers(0, 2, t.shape).astype(dt)
        else:
            a = rng.integers(0, 100, t.shape).astype(dt)
        frame.append(from_numpy(a, device))
    return frame


def _stack_window(col: Sequence[Any], bucket: int,
                  device: torch.device) -> torch.Tensor:
    """One input tensor of every frame of a window, stacked along a new
    leading axis on ``device`` and padded up to ``bucket`` rows by
    replaying the last frame.  Host frames are stacked on the host and
    copied once; device frames stack on the device."""
    pad = bucket - len(col)
    if all(isinstance(x, np.ndarray) for x in col):
        return from_numpy(np.stack(list(col) + [col[-1]] * pad), device)
    ts = [_xfer.move(x, device) if isinstance(x, torch.Tensor)
          else from_numpy(x, device) for x in col]
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
        self._pre_owner = ""         # the element whose prologue they are
        self._post_fns: list = []    # fused downstream epilogue (≤1)
        # window verdicts, keyed by (in_spec, bucket): True = the window
        # folds into one program call, False = it runs frame by frame
        self._batch_fold: Dict[Tuple[TensorsSpec, int], bool] = {}
        self._batch_lock = threading.Lock()
        # (model, program) flip together under this lock (commit_swap);
        # every dispatch reads them as one snapshot under it
        self._swap_lock = threading.Lock()
        self._donate = False  # custom=donate: callers mark inputs donated
        self.batch_cache_hits = 0
        self.batch_cache_misses = 0
        self._cache_by_bucket: Dict[int, List[int]] = {}  # b -> [hit, miss]
        #: the placement (parallel.ResolvedPlacement) of mesh=; None on
        #: one device
        self._placement = None

    def set_fused_pre(self, chains: list, owner: str = "") -> None:
        """Install upstream transform op chains (runtime/fusion.py) to run
        as this filter's prologue, under ``nns:prologue:<owner>`` spans
        (``owner``: the filter element).  They apply at the next
        ``set_input_info`` — negotiation always calls it when chains are
        present.  The list is kept BY REFERENCE: a transform that unfuses
        during negotiation removes its chain in place."""
        self._pre_chains = chains
        self._pre_owner = owner

    def set_fused_post(self, posts: list) -> None:
        """Install a downstream epilogue (runtime/fusion.py decoder
        fusion): a fn mapping the model's output tuple to the fused output
        tuple (the bounding-box device overlay).  Same by-reference
        contract as :meth:`set_fused_pre`."""
        self._post_fns = posts

    # -- lifecycle -----------------------------------------------------------

    def configure(self, props: FilterProps) -> None:
        super().configure(props)
        self._donate = "donate" in (props.custom or "")
        for prop in ("sharding", "devices"):
            if getattr(props, prop, "") and not props.mesh:
                raise FilterError(f"torch-cuda: {prop}="
                                  f"{getattr(props, prop)!r} requires mesh=")
        try:
            kind = parse_accel_kind(props.accelerator)
        except ValueError as e:
            raise FilterError(f"torch-cuda: {e}") from None
        if kind is not None:
            self.device = resolve_device(kind)
        else:
            self.device = props.device if props.device is not None \
                else resolve_device("cuda")
        self._placement = None
        if props.mesh:
            from ..parallel import Placement

            try:
                self._placement = Placement.from_props(props).resolve(
                    self.device.type)
            except (ValueError, TypeError) as e:
                raise FilterError(
                    f"torch-cuda: mesh {props.mesh!r}: {e}") from e
            self.device = self._placement.lead.torch_device
        # shared-tensor-filter-key: instances naming one key on one
        # placement share the model and its program
        where = self._placement.key if self._placement is not None \
            else self.device
        table_key = f"torch-cuda:{props.shared_key}:{where}"
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
        with self._swap_lock:
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


    def _resolve_model(self, model) -> ModelDef:
        if isinstance(model, ModelDef):
            return model
        if isinstance(model, str):
            m = get_model(model)
            if m is not None:
                return m
            if "://" in model or "@" in model:
                try:
                    model = resolve_model_uri(model)
                except (ValueError, KeyError) as e:
                    raise FilterError(f"torch-cuda: {e}") from None
            if os.path.isfile(model):
                return self._load_file(model)
            raise FilterError(
                f"torch-cuda: model {model!r} is neither a registered name "
                "nor a file")
        if callable(model):
            return ModelDef(model)
        raise FilterError(f"torch-cuda: unsupported model object {type(model)}")

    def _load_file(self, path: str) -> ModelDef:
        """A model file, by its extension.  The importer frameworks
        (``onnx``, ``tensorflow-lite``, ``tensorflow``) override this for
        their own extension and hand any other here, so an imported model
        runs on everything below: the fused prologue, hot reload (the
        shadow is an instance of the same class), ``share-model`` and
        ``mesh=``."""
        return _load_file(path)

    def model_name(self) -> str:
        m = self._model
        return m.name if m is not None else ""

    def _placement_label(self) -> str:
        """Where this instance's programs run: ``mesh(<axes>)`` on a
        mesh, else ``device``/``host``."""
        if self._placement is not None:
            return self._placement.describe()
        return "device" if _xfer.on_card(self.device) else "host"

    def weight_bytes(self) -> Optional[dict]:
        """The model's weights on this instance's placement, for
        ``nns_model_weight_bytes{pool,placement}``: every distinct copy
        on a mesh (placement ``mesh``; virtual devices over one card
        share one), the device copy otherwise; None without weights."""
        m = self._model
        if m is None or m.params is None:
            return None
        rp = self._placement
        with m._lock:
            if rp is not None:
                mp = m._mesh_params.get(rp.key)
                nbytes = mp.nbytes() if mp is not None else 0
            else:
                params = m._dev_params.get(self.device)
                nbytes = _xfer.params_nbytes(params) \
                    if params is not None else 0
        if not nbytes:
            return None
        return {"bytes": nbytes,
                "placement": "mesh" if rp is not None
                else self._placement_label()}

    def _capture(self, fn: Callable, *args: Any, bucket: int) -> Any:
        """``fn(*args)`` with its cost recorded for ``(model, bucket)``
        (obs/xlacost.py).  On the ``meta`` device (the analyzer's dry
        run) nothing computes, so nothing is recorded."""
        if self.device.type == "meta":
            return fn(*args)
        w = self.weight_bytes()
        return _xlacost.capture(
            self._model.name, fn, *args, bucket=bucket,
            placement=self._placement_label(),
            platform=device_platform(self.device),
            weight_bytes=w["bytes"] if w else 0)

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
        rp = self._placement
        model_fns = [self._model.flat_fn(self.device)] if rp is None else \
            [self._model.shard_fn(rp, g) for g in rp.groups]
        pre = self._pre_fns(in_spec) if self._pre_chains else None
        pre_w = self._pre_fns(in_spec, lead=1) if self._pre_chains else None
        post = self._post_fns[0] if self._post_fns else None

        def run(inputs, k=0):
            out = model_fns[k](*inputs)
            out = tuple(out) if isinstance(out, (list, tuple)) else (out,)
            if post is not None:
                out = tuple(post(*out))
            return out

        owner = self._pre_owner

        def frame_call(k, inputs):
            if pre is not None:
                with _profile.span("prologue", owner):
                    inputs = [g(x) for g, x in zip(pre, inputs)]
            return run(inputs, k)

        def window_call(k, stacked):
            """(bucket, *frame_shape) per input → the outputs with the
            window folded into their leading axis."""
            if pre_w is not None:
                with _profile.span("prologue", owner):
                    stacked = [g(x) for g, x in zip(pre_w, stacked)]
            return run([x.reshape((-1,) + tuple(x.shape[2:]))
                        for x in stacked], k)

        check_split = None
        if rp is None:
            def program(*inputs):
                return frame_call(0, inputs)

            def window_program(*stacked):
                return window_call(0, stacked)
        else:
            program, window_program, check_split = self._sharded_programs(
                rp, frame_call, window_call)

        zeros = [torch.zeros(t.shape, dtype=t.dtype.torch_dtype,
                             device=self.device) for t in in_spec.tensors]
        # on meta (the analyzer) the kernels' wrappers give shapes only
        scope = shape_only() if self.device.type == "meta" else nullcontext()
        try:
            with torch.inference_mode(), scope:
                # the single-frame program's cost row (bucket 0)
                outs = self._capture(program, *zeros, bucket=0)
        except (RuntimeError, ValueError, TypeError, IndexError) as e:
            raise FilterError(
                f"torch-cuda: model {self._model.name} rejects input "
                f"{in_spec}: {e}") from e
        if check_split is not None and self.device.type != "meta":
            with torch.inference_mode():
                check_split(_seeded_inputs(in_spec, self.device))
        out_spec = TensorsSpec.from_shapes(
            [tuple(o.shape) for o in outs],
            [DType.from_torch(o.dtype) for o in outs])
        return _Program(program, window_program, in_spec, out_spec,
                        with_pre=pre is not None, with_post=post is not None)

    @staticmethod
    def _sharded_programs(rp: Any, frame_call: Callable,
                          window_call: Callable):
        """The per-frame and window programs over placement ``rp``, and
        the split check.  The window splits over this process's data
        shards in whole frames, contiguous and in stack order; every
        shard runs ``window_call(k, rows)`` on its lead device and the
        outputs gather on the first.  A frame's own leading axis splits
        the same way once ``check(inputs)`` has held the split against
        the whole batch on seeded inputs (a frame whose leading axis is
        not a batch of independent rows runs replicated); a batch that
        does not divide runs once, replicated.  A multi-process frame
        batch is the global one: this process runs its own rows and the
        outputs gather from every process."""
        from ..parallel.sharded import run_sharded

        groups = rp.groups
        verdict = [None]  # True: a frame's leading axis splits

        def frame(inputs, split: bool):
            if split and rp.num_processes > 1:
                outs = run_sharded(groups, frame_call,
                                   [rp.local_rows(x) for x in inputs], True)
                return tuple(rp.gather_global(o) for o in outs)
            return run_sharded(groups, frame_call, inputs, split)

        def divisible(inputs) -> bool:
            b = int(inputs[0].shape[0]) if inputs and inputs[0].dim() \
                else 1
            return rp.data_axis_size > 1 and b % rp.data_axis_size == 0

        def program(*inputs):
            return frame(inputs, divisible(inputs) and bool(verdict[0]))

        def window_program(*stacked):
            sharded = rp.window_sharding(int(stacked[0].shape[0])) \
                is not None
            return run_sharded(groups, window_call, stacked, sharded)

        def check(inputs) -> None:
            if not divisible(inputs):
                return
            try:
                split = frame(inputs, True)
            except (RuntimeError, ValueError, TypeError, IndexError):
                verdict[0] = False
                return
            whole = frame(inputs, False)
            verdict[0] = len(split) == len(whole) and all(
                _rows_agree(a, w, SPLIT_TOL) for a, w in zip(split, whole))

        return program, window_program, check

    def _record_mesh(self, slots: int, frames: int, sharded: bool,
                     local: bool = False) -> None:
        """Feed one mesh dispatch into the per-shard attribution store
        (keyed by model name, like the cost rows), over every data axis
        of the placement.  ``local=True`` (a window) restricts a
        multi-process placement to its local data axes: this process
        sees only its own ``slots``/``frames``."""
        from ..obs import meshstat as _meshstat
        from ..parallel.placement import DCN_PREFIX

        rp = self._placement
        axes = rp.data_axes
        if local and rp.num_processes > 1:
            axes = tuple(a for a in rp.data_axes
                         if not a.startswith(DCN_PREFIX)) or axes
        _meshstat.record_dispatch(
            self._model.name if self._model is not None else "?",
            rp.mesh, axes, slots, frames, sharded)

    def _tag_home(self, outs: Sequence[Any]) -> None:
        """Mark a mesh dispatch's outputs as the mesh's (gathered on its
        first device; the stage handoff reads the tag)."""
        from ..parallel.mesh import set_home

        home = self._placement.device_ids
        for o in outs:
            if isinstance(o, torch.Tensor):
                set_home(o, home)

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
        p = self._build(in_spec)
        with self._swap_lock:
            self._program = p
        with self._batch_lock:
            self._batch_fold.clear()  # verdicts are per schema
        return p.in_spec, p.out_spec

    # -- hot path ------------------------------------------------------------

    def _snapshot(self) -> _Program:
        """The serving program, read as one with its model (commit_swap
        flips both under ``_swap_lock``)."""
        with self._swap_lock:
            p = self._program
        if p is None:
            raise FilterError("torch-cuda: not configured")
        return p

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        p = self._snapshot()
        inputs = [x if x.device == self.device else
                  _xfer.move(x, self.device) for x in inputs]
        with torch.inference_mode():
            out = list(p.fn(*inputs))
        if self._placement is not None:
            # the leading dim batch-shards over the data axes when it
            # divides, else the frame ran replicated
            b = int(p.in_spec.tensors[0].shape[0] or 1) \
                if p.in_spec.tensors and p.in_spec.tensors[0].shape else 1
            self._record_mesh(
                slots=b, frames=b,
                sharded=b % self._placement.data_axis_size == 0)
            self._tag_home(out)
        return out

    def invoke_batched(self, frames: Sequence[Sequence[Any]],
                       bucket: int) -> List[List[Any]]:
        """Run ``frames`` (n per-frame input lists of tensors or host
        arrays, n <= bucket) as ONE program call on a window padded up
        to ``bucket`` by replaying the last frame; returns n per-frame
        output lists (views into the window's outputs).  A model that does
        not fold runs the window frame by frame (see the module doc)."""
        p = self._snapshot()
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
            folded = out is not None
            if not folded:
                out = [self._run_alone(p, f) for f in frames]
        rp = self._placement
        if rp is not None:
            # window attribution: bucket slots over the local data shards
            # (pads included — they burn device time)
            self._record_mesh(slots=bucket, frames=n, local=True,
                              sharded=folded
                              and rp.window_sharding(bucket) is not None)
            for o in out:
                self._tag_home(o)
        return out

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
        # the bucket's cost row, counted on its first (probe) dispatch
        try:
            outs = self._capture(p.window_fn, *window, bucket=bucket) \
                if probe else p.window_fn(*window)
        except (RuntimeError, ValueError, TypeError, IndexError):
            if not probe:
                raise
            # the fold itself breaks the model (a frame whose leading
            # axis is not a batch): the window runs frame by frame
            return None, False
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
            if all(_on_host((w[0] == w[n - 1]).all()) for w in window):
                verdict = None
        return [[o[i] for o in per] for i in range(n)], verdict

    def _run_alone(self, p: _Program, frame: Sequence[Any]) -> List[Any]:
        return list(p.fn(*[_xfer.move(x, self.device)
                           if isinstance(x, torch.Tensor)
                           else from_numpy(x, self.device) for x in frame]))

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

    # -- double-buffered hot swap (runtime/lifecycle.py drives this) ---------

    def hot_buckets(self) -> Tuple[int, ...]:
        """Bucket sizes with a fold verdict on the current schema: the set
        a replacement must have warm before the flip."""
        with self._batch_lock:
            return tuple(sorted({int(k[1]) for k in self._batch_fold}))

    def check_buckets(self, buckets: Sequence[int]) -> Tuple[int, ...]:
        """Take the fold verdict of each bucket of ``buckets`` that has
        none yet, on the calling thread (a ``max-batch`` actuation calls
        this before a window may grow onto a new bucket): seeded frames
        of the serving schema run once a window at each.  Returns the
        buckets checked."""
        if self._program is None:
            return ()
        hot = set(self.hot_buckets())
        missing = tuple(sorted({int(b) for b in buckets} - hot))
        if missing:
            self._warm_shadow(self, missing)
        return missing

    def prepare_swap(self, model: Any, buckets: Sequence[int] = (),
                     warm: bool = True) -> "TorchCudaFilter":
        """Load a replacement OFF the dispatch path: a configured SHADOW
        instance (same device, custom and fused stages as this one, the
        serving input schema forced) while this instance keeps serving.
        ``model`` is anything ``model=`` accepts, or a bare params dict —
        the weights-only swap: this instance's ``fn`` with new weights.
        The shadow's weights are copied to the device at its configure;
        with ``warm`` it runs once alone and once a window at every
        bucket of ``buckets`` (else :meth:`hot_buckets`), so its fold
        verdicts exist before the flip, and the copies and forwards are
        finished when this returns.  A weights-only shadow starts from
        this instance's verdicts (the architecture decides them), so its
        warm windows are verdict hits.  Raises when the replacement
        changes the output schema."""
        if self.props is None:
            raise FilterError("torch-cuda: not configured (nothing to swap)")
        with self._swap_lock:
            cur_model, cur = self._model, self._program
        weights_only = isinstance(model, dict) and "apply" not in model
        if weights_only:
            if cur_model is None or cur_model.params is None:
                raise FilterError(
                    "torch-cuda: a weights-only swap needs a model that "
                    "carries params to swap into")
            model = ModelDef(cur_model.fn, model, cur_model.in_spec,
                             name=f"{cur_model.name}@weights")
        shadow = type(self)()
        # the same program shape: fused stages ride along by reference,
        # and the serving schema is forced so the flip serves the caps
        # already flowing; a private instance until commit (no shared key)
        shadow._pre_chains = self._pre_chains
        shadow._pre_owner = self._pre_owner
        shadow._post_fns = self._post_fns
        shadow.configure(dataclasses.replace(
            self.props, model=model,
            input_spec=cur.in_spec if cur is not None
            else self.props.input_spec, shared_key=None))
        if cur is not None and shadow._program.out_spec != cur.out_spec:
            raise FilterError(
                f"torch-cuda: replacement model {shadow.model_name()!r} "
                f"changes the output schema ({cur.out_spec} -> "
                f"{shadow._program.out_spec}); a hot swap must keep the "
                f"negotiated caps — restart the pipeline to change schemas")
        if weights_only and cur is not None:
            with self._batch_lock:
                verdicts = dict(self._batch_fold)
            shadow._batch_fold = {(shadow._program.in_spec, k[1]): v
                                  for k, v in verdicts.items()
                                  if k[0] == cur.in_spec}
        want = tuple(sorted({int(b) for b in buckets} or self.hot_buckets()))
        if warm:
            self._warm_shadow(shadow, want)
        return shadow

    @staticmethod
    def _warm_shadow(shadow: "TorchCudaFilter",
                     buckets: Tuple[int, ...]) -> None:
        """Run the shadow once alone and once a window at each bucket on
        two seeded frames that differ — the first window per bucket takes
        the fold verdict, which two equal frames (zeros) cannot — then
        wait for the device, so the flip inherits finished work."""
        p = shadow._program
        rng = np.random.default_rng(0)
        pair = [_seeded_inputs(p.in_spec, shadow.device, rng)
                for _ in range(2)]
        outs = list(shadow.invoke(pair[0]))
        for b in buckets:
            window = [pair[0]] + [pair[1]] * (int(b) - 1)
            outs += [o for out in shadow.invoke_batched(window, int(b))
                     for o in out]
        if shadow.device.type == "cuda":
            torch.cuda.current_stream(shadow.device).synchronize()

    def commit_swap(self, shadow: Any) -> None:
        """Adopt a prepared shadow's (model, program, fold verdicts): the
        double-buffer flip.  Dispatches read (model, program) under
        ``_swap_lock``, so none sees a torn pair; the lifecycle layer
        also flips at a window boundary, so no window straddles it."""
        with self._swap_lock:
            self._model = shadow._model
            self._program = shadow._program
        with self._batch_lock:
            self._batch_fold = dict(shadow._batch_fold)

    # -- events --------------------------------------------------------------

    def handle_event(self, event: Event) -> None:
        """RELOAD_MODEL on a non-pooled instance: stage and warm the
        replacement, then flip it in (the element's own window, if any,
        keeps its flush order; the pool goes through its lifecycle)."""
        if event.kind != EventKind.RELOAD_MODEL:
            return
        if self.props is None or not self.props.is_updatable:
            raise FilterError("torch-cuda: model is not updatable")
        self.commit_swap(self.prepare_swap(event.data["model"]))
