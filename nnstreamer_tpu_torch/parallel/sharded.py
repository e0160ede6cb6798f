"""Sharded model execution: the sharding rules, the data/model-parallel
invoke and the sharded training step.

Counterpart of the JAX package's ``parallel/sharded.py``.  JAX hands a
sharded program to XLA, which inserts the collectives.  Eager PyTorch has
no SPMD compiler, so this module does by hand what XLA inserts:

- the **split**: a batch shards over the data axes in contiguous rows,
  in stack order — data shard *k* holds rows ``[k*b/S, (k+1)*b/S)``,
  which is what ``obs/meshstat.shard_split`` assumes;
- the **weights**: every data shard runs on its lead device with that
  device's replica of the params; a leaf the rules split over the
  ``model`` axis becomes a :class:`ShardedLeaf` whose slice *j* lives on
  the shard's *j*-th ``model`` device;
- the **gathers**: a convolution or product with a :class:`ShardedLeaf`
  computes one slice of its output channels per ``model`` device and
  concatenates them on the lead device right after the layer, so the
  function is the unsplit one (each output channel is computed whole);
- the **final gather**: the shards' outputs concatenate in shard order
  on the mesh's first device.

The split assumes the model's leading axis is a batch of independent
rows (the same condition as the filter's window fold).

Placement descriptors: :class:`PartitionSpec` (``P``) names, per
dimension, the mesh axis it splits over; :class:`NamedSharding` binds
one to a mesh.  The rules read the port's own parameter layout: a
pointwise convolution is ``(cout, cin, 1, 1)`` here where the JAX tree
holds ``(1, 1, cin, cout)``, and a dense ``w`` is ``(din, dout)`` in
both — the same leaves split (``models/convert.py`` maps the two trees).

The training step (:func:`train_step`) is the JAX step's function: one
forward over the GLOBAL batch with the batch's statistics, its backward,
one optimizer update of every leaf.  In JAX that is one SPMD program
whose batch statistics and gradients XLA all-reduces over the data
shards.  Here, over S > 1 data shards, the step splits the batch into S
contiguous row blocks in shard order, runs each block's forward on its
shard's lead ``torch.device`` on a host thread of its own, with every
batch-norm layer normalizing by the moments of all S blocks
(``parallel/syncbn.py``), gathers the logits on the first shard's device
for one loss over the whole batch, and one ``backward()`` sums every
shard's gradient into the master leaves before one update.  The shards
may share a device (virtual records) or not: one code path.  With S = 1
the batch runs stacked on its one device.  On a ``model`` axis the step
splits the leaves its rules split, as the JAX step's ``shard_params``
places them: each becomes a :class:`ShardedLeaf` of trainable slices on
the first data shard's ``model`` group, the other shards' groups get the
slices by ``.to()``, and the layer's gather carries each slice's
gradient back.

Across processes (a mesh whose data shards lie on more than one rank of
the ``torch.distributed`` group) each rank runs its own shards on its
own rows and keeps a whole copy of the master leaves: the batch-norm
moments are exchanged over every rank once a layer
(``parallel/syncbn.py`` :class:`~.syncbn.RankShards`), each rank's loss
is its rows' share of the global batch's, and one ``all_reduce`` a
bucket sums the leaves' gradients over the ranks before the update, so
every rank takes the same update.

A ``model`` group may span ranks too (``make_mesh("model:2,data:4")``
over two ranks' records: every group one record on each rank).  Then
every rank of a group runs that data shard on the same rows, as
Megatron's tensor parallelism does: a split layer computes this rank's
slices of its output and gathers the others over the group's ranks
(:class:`_GatherSlices`, whose backward keeps this rank's slices of the
output gradient), and its input's gradient is summed over them in the
backward (:class:`_ReduceInputGrads`, one node a layer for all of a
rank's shards, so every rank issues those collectives in one order).
The master leaves hold this rank's slices only.  Everything downstream
of a gather runs alike on each rank of the group, so each shard must
count once, where a plain sum over every rank would count it once a rank
of its group (the fault the JAX step shows on a ``model`` axis: ROADMAP
queue C): the moments and a slice's gradient reduce over the data peers
(one rank of each data shard's group), and the replicated leaves'
gradients and the loss over every rank, divided by the ranks of a group,
so that each rank of a group takes the same update even where its
kernels rounded its own gradients otherwise (:meth:`TrainStep._reduce`).
"""

from __future__ import annotations

import copy
import functools
import itertools
import queue
import threading
import time
import weakref
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profile import GATE
from . import syncbn


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (None = not split)."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A :class:`PartitionSpec` bound to a mesh: where each dimension's
    pieces live."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh, axis: Any = "data") -> NamedSharding:
    """Shard the leading (batch) dimension over ``axis``."""
    return NamedSharding(mesh, P(axis))


# -- parameter sharding rules ------------------------------------------------


def replicated_param_rules(path: Tuple, leaf) -> PartitionSpec:
    """Pure data-parallel layout: every param replicated on every device."""
    return P()


def mobilenet_param_rules(path: Tuple, leaf) -> PartitionSpec:
    """Tensor-parallel rules for the MobileNet/SSD (and ViT) params: split
    the output channels of pointwise convolutions — ``weight`` of shape
    ``(cout, cin, 1, 1)`` — and of dense products — ``w`` of shape
    ``(din, dout)`` — over ``model``; keep depthwise and 3x3 convolutions
    and the batch-norm vectors replicated (they are small; splitting them
    buys nothing but gathers)."""
    leaf_name = path[-1] if path else None
    if leaf_name in ("w", "weight") and hasattr(leaf, "ndim"):
        if leaf.ndim == 2:  # dense: (din, dout)
            return P(None, "model")
        if leaf.ndim == 4 and leaf.shape[2] == 1 and leaf.shape[3] == 1:
            return P("model", None, None, None)  # pointwise conv, OIHW
    return P()


#: Named parameter-layout rules selectable from the element graph: the
#: ``tensor_filter sharding=`` property resolves here.
PARAM_RULES: Dict[str, Callable] = {
    "replicated": replicated_param_rules,
    "dp": replicated_param_rules,
    "mobilenet": mobilenet_param_rules,
    "tp": mobilenet_param_rules,
}


def register_param_rules(name: str, rules: Callable) -> str:
    """Register a ``(path, leaf) -> PartitionSpec`` rule set under
    ``name`` for use via ``tensor_filter sharding=name``."""
    PARAM_RULES[name] = rules
    return name


def get_param_rules(name: str) -> Callable:
    try:
        return PARAM_RULES[name or "replicated"]
    except KeyError:
        raise ValueError(
            f"unknown sharding rules {name!r}; known: "
            f"{sorted(PARAM_RULES)}") from None


# -- a leaf split over the model axis ----------------------------------------


class ShardedLeaf:
    """A parameter split over the ``model`` axis along ``dim``: slice *j*
    lives on the *j*-th device of the shard's ``model`` group.

    A tensor-like: ``F.conv2d`` with it as the weight (split on ``dim``
    0, the output channels) and a product ``x @ w`` (split on the last
    dim) compute one slice of the output per device and concatenate on
    the input's device — the gather right after the layer.  ``.to(dtype)``
    keeps the split; anything else sees the gathered tensor.

    Where the group spans ranks (``model``: its :class:`ModelGroup`) the
    leaf holds only this rank's slices, slice indices ``model.index`` of
    ``model.count``, each on its own record's device: the layer computes
    those slices of its output, then gathers the rest over the model
    subgroup (:class:`_GatherSlices`), and its input's gradient is summed
    over the subgroup in the backward (:func:`_model_input`), the two
    halves of a Megatron tensor-parallel layer.  :meth:`full` and
    :meth:`numpy` gather over the subgroup (every rank of it calls them
    in one order); :meth:`host` keeps this rank's slices."""

    def __init__(self, slices: Sequence[torch.Tensor], dim: int,
                 spec: PartitionSpec, shape: Sequence[int],
                 model: Optional["ModelGroup"] = None):
        self.slices = list(slices)
        self.split_dim = int(dim)
        self.spec = spec
        self._shape = torch.Size(shape)
        self.model = model

    shape = property(lambda self: self._shape)
    ndim = property(lambda self: len(self._shape))
    dtype = property(lambda self: self.slices[0].dtype)
    device = property(lambda self: self.slices[0].device)

    @property
    def index(self) -> Tuple[int, ...]:
        """The slice index of each slice held here, of :attr:`count`."""
        return self.model.index if self.model is not None \
            else tuple(range(len(self.slices)))

    @property
    def count(self) -> int:
        """The number of slices over the whole ``model`` group."""
        return self.model.count if self.model is not None \
            else len(self.slices)

    def _like(self, slices, dim=None, spec=None, shape=None) -> "ShardedLeaf":
        return ShardedLeaf(slices, self.split_dim if dim is None else dim,
                           self.spec if spec is None else spec,
                           self._shape if shape is None else shape,
                           self.model)

    def full(self) -> torch.Tensor:
        """The whole parameter, gathered on the first slice's device (over
        the model subgroup where it spans ranks: differentiable)."""
        dev = self.slices[0].device
        local = torch.cat([s.to(dev) for s in self.slices], self.split_dim)
        if self.model is None:
            return local
        return _GatherSlices.apply(local, self.model, self.split_dim)

    def to(self, *args, **kwargs):
        dt = kwargs.get("dtype") if not args else args[0]
        if isinstance(dt, torch.dtype) and len(args) <= 1 and \
                set(kwargs) <= {"dtype"}:
            return self._like([s.to(dt) for s in self.slices])
        return self.full().to(*args, **kwargs)

    def detach(self) -> "ShardedLeaf":
        return self._like([s.detach() for s in self.slices])

    def permute(self, *dims) -> "ShardedLeaf":
        """Each slice permuted, the split dim and spec following it (a
        leaf's JAX layout, ``models/convert.py``)."""
        dims = tuple(dims[0]) if len(dims) == 1 and \
            isinstance(dims[0], (tuple, list)) else dims
        spec = tuple(self.spec) + (None,) * (self.ndim - len(self.spec))
        return self._like([s.permute(*dims) for s in self.slices],
                          dims.index(self.split_dim),
                          PartitionSpec(*[spec[d] for d in dims]),
                          [self._shape[d] for d in dims])

    def host(self) -> "ShardedLeaf":
        """Each slice as an owned numpy array, copied from its own device
        (bf16 by bit pattern): no gather on one device, and across ranks
        this rank's slices only (:attr:`index`)."""
        from ..core.buffer import to_numpy

        return self._like([s if isinstance(s, np.ndarray) else
                           to_numpy(s.detach().contiguous()).copy()
                           for s in self.slices])

    def numpy(self) -> np.ndarray:
        """The whole leaf of :meth:`host`'s slices, concatenated; across
        ranks the other ranks' slices gathered over the subgroup as a
        layer's output is (:class:`_GatherSlices`: a zero keeps no sign),
        through the card under NCCL."""
        from ..core.buffer import from_numpy, to_numpy
        from .multihost import backend

        local = np.concatenate(self.host().slices, self.split_dim)
        if self.model is None:
            return local
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if backend() == "nccl" else torch.device("cpu")
        with torch.no_grad():
            whole = _GatherSlices.apply(from_numpy(local, dev, "gather"),
                                        self.model, self.split_dim)
        return to_numpy(whole).copy()

    def __repr__(self) -> str:
        held = "" if self.model is None else \
            f", index={list(self.index)} of {self.count}"
        return (f"ShardedLeaf(shape={tuple(self._shape)}, dim={self.split_dim}, "
                f"slices={len(self.slices)}{held})")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d and len(args) >= 2 \
                and isinstance(args[1], cls) and args[1].split_dim == 0 \
                and not isinstance(args[0], cls) \
                and kwargs.get("bias") is None:
            x, w = _model_input(args[0], args[1].model), args[1]
            outs = [func(x.to(s.device), s, *args[2:], **kwargs)
                    for s in w.slices]
            return _model_output(torch.cat([o.to(x.device) for o in outs], 1),
                                 w.model, 1)
        if func in _MATMULS and len(args) == 2 \
                and isinstance(args[1], cls) \
                and args[1].split_dim == args[1].ndim - 1 \
                and not isinstance(args[0], cls):
            x, w = _model_input(args[0], args[1].model), args[1]
            outs = [torch.matmul(x.to(s.device), s) for s in w.slices]
            out = torch.cat([o.to(x.device) for o in outs], -1)
            return _model_output(out, w.model, out.dim() - 1)
        return func(*_gathered(args), **_gathered(kwargs))


_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


def _gathered(obj):
    if isinstance(obj, ShardedLeaf):
        return obj.full()
    if isinstance(obj, dict):
        return {k: _gathered(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_gathered(v) for v in obj)
    return obj


# -- a model group across ranks ----------------------------------------------


class ModelGroup:
    """One data shard's ``model`` group where its records lie on more than
    one rank, as this rank holds it: the global data shard (``shard``),
    the model coordinates of this rank's records (``index``, ascending) of
    ``count``, and the subgroup of the group's ranks (``sub``,
    ``multihost.Subgroup``).  :meth:`all_reduce` times its collectives
    into ``ranks`` (:class:`~.syncbn.RankShards`) where set."""

    __slots__ = ("shard", "index", "count", "sub", "ranks")

    def __init__(self, shard: int, index: Sequence[int], count: int, sub,
                 ranks: Optional[syncbn.RankShards] = None):
        self.shard = int(shard)
        self.index = tuple(int(j) for j in index)
        self.count = int(count)
        self.sub = sub
        self.ranks = ranks

    def __reduce__(self):
        # a copy elsewhere keeps which slices these are, not the subgroup
        return (ModelGroup, (self.shard, self.index, self.count, None))

    def all_reduce(self, t: torch.Tensor, kind: str) -> None:
        """SUM ``t`` in place over the group's ranks; ``kind`` ("gather"
        or "input") names the counter its host seconds go to."""
        if self.sub is None:
            raise ValueError(f"{self!r}: a copy of a model group across "
                             f"ranks has no subgroup to gather over")
        t0 = time.perf_counter()
        self.sub.all_reduce(t)
        if self.ranks is not None:
            self.ranks.add(kind, time.perf_counter() - t0)

    def __repr__(self) -> str:
        ranks = list(self.sub.ranks) if self.sub is not None else None
        return (f"ModelGroup(shard={self.shard}, index={list(self.index)} "
                f"of {self.count}, ranks={ranks})")


class _GatherSlices(torch.autograd.Function):
    """The whole output of a split layer from this rank's slices of it.

    forward: this rank's slices (concatenated along ``dim`` in index
    order) concatenated at their places with zero slices into the whole
    output (``torch.cat``, so the buffer keeps the layer output's memory
    format, channels-last for a convolution over NHWC data, as the
    in-rank gather's does), and one ``all_reduce(SUM)`` of it over the
    model subgroup: every entry has one non-zero term, so the sum is
    exact, the same gather on every rank.  backward: this rank's slices of the output
    gradient, which every rank of the group holds whole and alike (they
    run the same downstream on the same rows): no collective, and no
    slice counted twice."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, model: ModelGroup, dim: int):
        ctx.model, ctx.dim = model, dim
        k = local.shape[dim] // len(model.index)
        held = dict((j, i) for i, j in enumerate(model.index))
        zero = torch.zeros_like(local.narrow(dim, 0, k))
        buf = torch.cat([local.narrow(dim, held[j] * k, k) if j in held
                         else zero for j in range(model.count)], dim)
        model.all_reduce(buf, "gather")
        return buf

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        model, dim = ctx.model, ctx.dim
        k = grad.shape[dim] // model.count
        return torch.cat([grad.narrow(dim, j * k, k) for j in model.index],
                         dim), None, None


class _ReduceInputGrads(torch.autograd.Function):
    """The split layers' inputs of every local shard at one layer.

    forward: each input as it is (a view).  backward: each shard's input
    gradient — this rank's slices' share of it — summed over its model
    subgroup (one ``all_reduce(SUM)`` a shard, in shard order), so every
    rank of a group continues its backward with the whole gradient.  One
    node a layer for all of a rank's shards (:func:`syncbn.joined`): the
    autograd engine runs it once, and every rank issues the layer's
    collectives in one order."""

    @staticmethod
    def forward(ctx, models, *xs):
        ctx.models = models
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, model, (shape, dtype, dev) in zip(grads, ctx.models,
                                                 ctx.like):
            g = torch.zeros(shape, dtype=dtype, device=dev) if g is None \
                else g.clone(memory_format=torch.contiguous_format)
            model.all_reduce(g, "input")
            out.append(g)
        return (None, *out)


def _model_input(x: torch.Tensor, model: Optional[ModelGroup]):
    """``x`` as a split layer's input: itself within a rank; across ranks
    behind :class:`_ReduceInputGrads`, joined with the other local
    shards' inputs of this layer, where a gradient will flow."""
    if model is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return syncbn.joined((x, model), lambda pairs: _ReduceInputGrads.apply(
        tuple(m for _, m in pairs), *[t for t, _ in pairs]))


def _model_output(out: torch.Tensor, model: Optional[ModelGroup], dim: int):
    """A split layer's output: whole within a rank; across ranks this
    rank's slices gathered with the others (:class:`_GatherSlices`)."""
    return out if model is None else _GatherSlices.apply(out, model, dim)


# -- placing params over a mesh ----------------------------------------------


def _on(device: torch.device):
    """The device context a shard's kernels launch under."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()


def _plain_place(obj: Any, device: torch.device) -> Any:
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device).eval()
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(obj)).to(device)
    if isinstance(obj, dict):
        return {k: _plain_place(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain_place(v, device) for v in obj)
    return obj


def _split_leaf(leaf: torch.Tensor, spec: PartitionSpec,
                group: Sequence[Any], model_axis: str,
                model: Optional[ModelGroup] = None):
    """``leaf`` split over the group's ``model`` devices per ``spec``, or
    None when the split dim does not divide (the leaf stays whole).  With
    ``model`` (a group across ranks) ``group`` is this rank's records of
    it and only their slices are made, each on its own record's device."""
    dims = [i for i, s in enumerate(spec) if s is not None]
    if not dims or spec[dims[0]] != model_axis:
        return None
    dim = dims[0]
    n = model.count if model is not None else len(group)
    if n <= 1 or leaf.shape[dim] % n:
        return None
    k = leaf.shape[dim] // n
    index = model.index if model is not None else range(n)
    with torch.no_grad():
        slices = [leaf.detach().narrow(dim, j * k, k).contiguous()
                  .to(rec.torch_device) for rec, j in zip(group, index)]
    return ShardedLeaf(slices, dim, spec, tuple(leaf.shape), model)


class MeshParams:
    """A params tree laid over a mesh per ``rules``: :meth:`tree` gives the
    tree a data shard's group runs with (its replica, model-split leaves
    as :class:`ShardedLeaf`), placed once per distinct group of
    ``torch.device``s — virtual records over one device share it.  A
    group across ranks is this rank's records of it with its
    :class:`ModelGroup`."""

    def __init__(self, params: Any, rules: Callable, model_axis: str,
                 place: Callable[[Any, torch.device], Any] = _plain_place):
        self.params = params
        self.rules = rules
        self.model_axis = model_axis
        self._place = place
        self._trees: Dict[Tuple, Any] = {}
        #: leaf path ("a.b.w") -> PartitionSpec actually applied
        self.specs: Dict[str, PartitionSpec] = {}

    def tree(self, group: Sequence[Any],
             model: Optional[ModelGroup] = None) -> Any:
        key = (tuple(d.torch_device for d in group), model)
        t = self._trees.get(key)
        if t is None:
            t = self._trees[key] = self._build(group, model)
        return t

    def _build(self, group: Sequence[Any],
               model: Optional[ModelGroup]) -> Any:
        base = self._place(self.params, group[0].torch_device)
        return self._shard(base, (), group, model)

    def _shard(self, obj: Any, path: Tuple, group, model=None) -> Any:
        if isinstance(obj, torch.nn.Module):
            named = list(obj.named_parameters()) + list(obj.named_buffers())
            for name, leaf in named:
                lpath = path + tuple(name.split("."))
                spec = P(*self.rules(lpath, leaf))
                sl = _split_leaf(leaf, spec, group, self.model_axis, model)
                self.specs[".".join(map(str, lpath))] = \
                    spec if sl is not None else P()
                if sl is None:
                    continue
                owner_name, _, attr = name.rpartition(".")
                owner = obj.get_submodule(owner_name) if owner_name else obj
                owner._parameters.pop(attr, None)
                owner._buffers.pop(attr, None)
                setattr(owner, attr, sl)
            return obj
        if isinstance(obj, torch.Tensor):
            spec = P(*self.rules(path, obj))
            sl = _split_leaf(obj, spec, group, self.model_axis, model)
            self.specs[".".join(map(str, path))] = \
                spec if sl is not None else P()
            return obj if sl is None else sl
        if isinstance(obj, dict):
            return {k: self._shard(v, path + (k,), group, model)
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._shard(v, path + (i,), group, model)
                             for i, v in enumerate(obj))
        return obj

    def nbytes(self) -> int:
        """Bytes of every distinct placed tree (replicas sharing one
        ``torch.device`` count once)."""
        total = 0
        for t in self._trees.values():
            total += _tree_nbytes(t)
        return total


def _tree_nbytes(obj: Any) -> int:
    if isinstance(obj, torch.nn.Module):
        n = sum(p.numel() * p.element_size()
                for p in list(obj.parameters()) + list(obj.buffers()))
        for m in obj.modules():
            for v in vars(m).values():
                if isinstance(v, ShardedLeaf):
                    n += sum(s.numel() * s.element_size() for s in v.slices)
        return n
    if isinstance(obj, ShardedLeaf):
        return sum(s.numel() * s.element_size() for s in obj.slices)
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_tree_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tree_nbytes(v) for v in obj)
    return 0


def data_shard_groups(mesh, data_axes: Sequence[str],
                      model_axis: str = "model",
                      process_index: Optional[int] = None
                      ) -> List[List[Any]]:
    """The device groups of the data shards, in shard order: shard *k*
    combines the coordinates along every data axis row-major in mesh
    order (as ``obs/meshstat.shard_device_label`` reads them); its group
    lists the devices along ``model_axis`` (one device without one), the
    other axes at coordinate 0.  ``process_index`` keeps the groups that
    process owns."""
    names = list(mesh.axis_names)
    shape = mesh.devices.shape
    data_idx = sorted(names.index(a) for a in data_axes if a in names)
    model_idx = names.index(model_axis) if model_axis in names \
        and model_axis not in data_axes else None
    groups: List[List[Any]] = []
    for coords in itertools.product(*[range(shape[i]) for i in data_idx]):
        index = [0] * len(shape)
        for i, c in zip(data_idx, coords):
            index[i] = c
        if model_idx is None:
            groups.append([mesh.devices[tuple(index)]])
            continue
        g = []
        for j in range(shape[model_idx]):
            index[model_idx] = j
            g.append(mesh.devices[tuple(index)])
        groups.append(g)
    if process_index is not None:
        groups = [g for g in groups if g[0].process_index == process_index]
    return groups


def _refuse_model_groups_across(mesh, model_axis: str, who: str) -> None:
    """``ValueError`` naming the first ``model`` group of ``mesh`` whose
    records lie on more than one process, and their owners: a sharded
    invoke runs each group in one process."""
    names = list(mesh.axis_names)
    if model_axis not in names:
        return
    ax = names.index(model_axis)
    fibers = np.moveaxis(mesh.devices, ax, -1).reshape(
        -1, mesh.devices.shape[ax])
    for g in fibers:
        owners = sorted({d.process_index for d in g})
        if len(owners) > 1:
            raise ValueError(
                f"{who}: the model group ({', '.join(str(d) for d in g)}) "
                f"lies on processes {owners}; a sharded invoke runs each "
                f"model group in one process (train_step trains one "
                f"across ranks)")


def shard_params(mesh, params, rules: Callable = mobilenet_param_rules,
                 model_axis: str = "model",
                 place: Callable[[Any, torch.device], Any] = _plain_place
                 ) -> MeshParams:
    """Lay a params tree over ``mesh`` per ``rules``; a leaf whose split
    dim does not divide over the ``model`` axis (or a mesh without one)
    stays replicated.  Raises ``ValueError`` where a ``model`` group's
    records lie on more than one process."""
    _refuse_model_groups_across(mesh, model_axis, "shard_params")
    return MeshParams(params, rules, model_axis if model_axis in
                      mesh.axis_names else "", place)


def run_sharded(groups: Sequence[Sequence[Any]],
                call: Callable[[int, List[torch.Tensor]], Sequence[Any]],
                inputs: Sequence[torch.Tensor], sharded: bool,
                unit: int = 1) -> Tuple[torch.Tensor, ...]:
    """``call(k, shard_inputs)`` on every data shard and the outputs
    gathered in shard order on the first shard's lead device.  With
    ``sharded`` every input splits into ``len(groups)`` contiguous row
    blocks (multiples of ``unit`` rows); without, the whole batch runs
    once on the first shard (the input is replicated: every device would
    compute the same rows)."""
    lead = groups[0][0].torch_device
    if not sharded or len(groups) == 1:
        with _on(lead):
            return tuple(call(0, [x.to(lead) for x in inputs]))
    s = len(groups)
    chunks = [x.split(x.shape[0] // s) for x in inputs]
    outs = []
    for k, g in enumerate(groups):
        dev = g[0].torch_device
        with _on(dev):
            outs.append(tuple(call(k, [c[k].to(dev) for c in chunks])))
    return tuple(torch.cat([o[i].to(lead) for o in outs])
                 for i in range(len(outs[0])))


class ShardedModel:
    """A model sharded over a mesh: params laid out by ``rules``, inputs
    split on the batch over ``data`` — one invoke spans every device of
    the mesh.  Returns what ``fn`` returns (a tensor or a tuple),
    gathered on the mesh's first device.  Raises ``ValueError`` for a
    mesh whose ``model`` group lies on more than one process, or that
    holds no data shard of this one."""

    def __init__(self, mesh, fn: Callable, params: Any = None,
                 rules: Callable = mobilenet_param_rules,
                 data_axis: str = "data", donate: bool = False,
                 name: str = ""):
        from .multihost import process_info

        self.mesh = mesh
        self.name = name or getattr(fn, "__name__", "sharded")
        self._fn = fn
        self._data_axis = data_axis
        _refuse_model_groups_across(mesh, "model", "ShardedModel")
        pid = process_info()[0]
        self._groups = data_shard_groups(mesh, (data_axis,),
                                         process_index=pid)
        if not self._groups:
            raise ValueError(f"ShardedModel: mesh {mesh!r} holds no data "
                             f"shard of process {pid}")
        self.params = shard_params(mesh, params, rules) \
            if params is not None else None

    def __call__(self, *inputs):
        inputs = [x if isinstance(x, torch.Tensor) else
                  torch.from_numpy(np.asarray(x)) for x in inputs]
        b = int(inputs[0].shape[0]) if inputs and inputs[0].dim() else 1
        s = len(self._groups)
        sharded = b % max(s, 1) == 0
        single = []

        def call(k, xs):
            if self.params is None:
                out = self._fn(*xs)
            else:
                out = self._fn(self.params.tree(self._groups[k]), *xs)
            if isinstance(out, (list, tuple)):
                return tuple(out)
            single.append(True)
            return (out,)

        with torch.inference_mode():
            outs = run_sharded(self._groups, call, inputs, sharded)
        self._record_dispatch(b, sharded)
        return outs[0] if single else outs

    def _record_dispatch(self, b: int, sharded: bool) -> None:
        """Per-shard mesh attribution (obs/meshstat.py): the leading dim
        of the first input is the batch this dispatch spreads over the
        data axis."""
        from ..obs import meshstat as _meshstat

        _meshstat.record_dispatch(self.name, self.mesh, self._data_axis,
                                  slots=b, frames=b, sharded=sharded)


# -- sharded training step ---------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels) -> torch.Tensor:
    """Mean over the batch of ``-sum(onehot · log_softmax(logits))``, the
    one-hot in f32 as ``jax.nn.one_hot`` makes it: a label outside the
    classes gives a zero row (its loss 0), where ``F.cross_entropy``
    would raise."""
    logp = torch.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(labels, device=logits.device)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels[..., None] == classes).to(torch.float32)
    return -(onehot * logp).sum(dim=-1).mean()


def _shard_groups(mesh, data_axis: str
                  ) -> Tuple[List[List[Any]], Optional[syncbn.RankShards]]:
    """This process's device groups of ``mesh``'s data shards, in shard
    order (:func:`data_shard_groups`: a shard's lead record first, then
    the rest of its ``model`` group; of a group across ranks, this rank's
    records of it in model order), and, where the mesh's records lie on
    more than one process, their :class:`~.syncbn.RankShards` (else None).

    A ``model`` group may span ranks where every rank holds the same model
    coordinates of each group it holds records of, and every group splits
    over its ranks alike (``make_mesh("model:M,data:D")`` over the
    ``devices()`` of M ranks, or ``hybrid_mesh`` with ``model`` a DCN
    axis; or M/R records of each group on each of R ranks).  Then every
    rank runs each data shard it holds records of, its ``ModelGroup``
    gathering the split layers over the group's ranks; the moments and
    the slices' gradients reduce over the data peers (the ranks holding
    the same coordinates, one of each data shard's group), the replicated
    leaves' gradients and the loss over every rank, divided by the ranks
    of a group (:meth:`TrainStep._reduce`).  The subgroups are
    made here, on every rank in one order: each cross-rank model group's
    in shard order, then the data peers' by coordinates.

    Raises ``ValueError`` (on every rank alike: the check reads only the
    mesh) for another layout of a group across ranks, naming the group and
    its owners; for records of processes that are not every rank of the
    process group; and, under NCCL, for a record of this rank that is not
    a card."""
    from .multihost import backend, process_info, subgroups

    rank, world = process_info()
    full = data_shard_groups(mesh, (data_axis,))
    owners = sorted({d.process_index for g in full for d in g})
    if owners == [rank]:
        return full, None
    if owners != list(range(world)):
        raise ValueError(
            f"train step: mesh {mesh!r} holds data shards of processes "
            f"{owners}; the step runs over every rank of the process "
            f"group ({world} here, this one {rank})")
    # each shard's owners -> the model coordinates of their records
    coords = [{p: tuple(j for j, d in enumerate(g) if d.process_index == p)
               for p in sorted({d.process_index for d in g})} for g in full]

    def named(k):
        return (f"the model group of data shard {k} "
                f"({', '.join(str(d) for d in full[k])}) on processes "
                f"{sorted(coords[k])}")

    held: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
    for k, c in enumerate(coords):
        for p, js in c.items():
            k0, js0 = held.setdefault(p, (k, js))
            if js0 != js:
                raise ValueError(
                    f"train step: {named(k)}: process {p} holds model "
                    f"coordinates {list(js)} of it and {list(js0)} of data "
                    f"shard {k0}'s; a rank holds the same coordinates of "
                    f"every model group it runs")
    parts = [sorted(c.values()) for c in coords]
    for k, part in enumerate(parts):
        if part != parts[0]:
            raise ValueError(
                f"train step: {named(k)} splits as "
                f"{[list(js) for js in part]} by process, data shard 0's "
                f"as {[list(js) for js in parts[0]]}; every model group "
                f"splits over its ranks alike")
    mine = [k for k, c in enumerate(coords) if rank in c]
    local = [[full[k][j] for j in coords[k][rank]] for k in mine]
    if backend() == "nccl" and any(d.torch_device.type != "cuda"
                                   for g in local for d in g):
        raise ValueError("train step: an nccl group reduces only card "
                         "tensors; this rank's data shards lie on another "
                         "device")
    spans = [k for k, c in enumerate(coords) if len(c) > 1]
    classes = sorted({js for c in coords for js in c.values()})
    sets = [sorted(coords[k]) for k in spans]
    if len(classes) > 1:
        sets += [sorted(p for p, (_, js) in held.items() if js == cls)
                 for cls in classes]
    subs = subgroups(sets)
    by_shard = dict(zip(spans, subs))
    peers = subs[len(spans) + classes.index(held[rank][1])] \
        if len(classes) > 1 else None
    models = [ModelGroup(k, coords[k][rank], len(full[k]), by_shard[k])
              if k in by_shard else None for k in mine]
    ranks = syncbn.RankShards(mine, len(full), peers,
                              [sorted(c) for c in coords], models)
    for m in models:
        if m is not None:
            m.ranks = ranks
    return local, ranks


def _as_device_tensor(a: Any, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.to(device)
        return t.clone() if t.is_inference() else t
    from ..core.buffer import from_numpy

    return from_numpy(np.asarray(a), device)


def _tree_copy(tree: Any, device: torch.device) -> Any:
    """A copy of ``tree`` with its array leaves as tensors on ``device``;
    other leaves are kept as they are."""
    if isinstance(tree, dict):
        return {k: _tree_copy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_copy(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device).clone()
    if isinstance(tree, (np.ndarray, np.generic)):
        return _as_device_tensor(np.array(tree), device)
    return tree


def _module_leaves(model: torch.nn.Module) -> List[torch.Tensor]:
    """Every floating parameter and buffer of ``model``, made trainable:
    the batch-norm vectors are buffers here and leaves of the JAX tree,
    which the JAX step updates too."""
    leaves = []
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point():
            t.requires_grad_(True)
            leaves.append(t)
    return leaves


def make_optimizer(name: str = "sgd", lr: float = 1e-2,
                   momentum: float = 0.9
                   ) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """``leaves -> torch.optim.Optimizer`` with optax's settings for
    ``sgd`` (momentum trace starting at g: ``dampening=0``, no Nesterov),
    ``adam`` (eps 1e-8, ``eps_root`` 0) and ``adamw`` (decay optax's
    1e-4, not torch's 1e-2).  Raises ``ValueError`` on another name."""
    name = name.lower()
    if name == "sgd":
        return lambda leaves: torch.optim.SGD(
            leaves, lr=lr, momentum=momentum, dampening=0.0, nesterov=False)
    if name == "adam":
        return lambda leaves: torch.optim.Adam(
            leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return lambda leaves: torch.optim.AdamW(
            leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    raise ValueError(f"unknown optimizer {name!r}")


def _leaf_on(leaf: ShardedLeaf, group: Sequence[Any],
             model: Optional[ModelGroup] = None) -> ShardedLeaf:
    """A split leaf's slices ``.to()`` the devices of ``group``, slice *j*
    to its *j*-th: differentiable, and the slice itself where it already
    lies there.  Across ranks ``group`` is this rank's records of the
    shard's group and ``model`` its :class:`ModelGroup`."""
    return ShardedLeaf([t.to(d.torch_device)
                        for t, d in zip(leaf.slices, group)],
                       leaf.split_dim, leaf.spec, leaf.shape, model)


def _tree_on(tree: Any, group: Sequence[Any],
             model: Optional[ModelGroup] = None) -> Any:
    """``tree`` with every tensor leaf ``.to()`` the group's lead device
    and every split leaf over the group (:func:`_leaf_on`)."""
    if isinstance(tree, dict):
        return {k: _tree_on(v, group, model) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_on(v, group, model) for v in tree)
    if isinstance(tree, ShardedLeaf):
        return _leaf_on(tree, group, model)
    if isinstance(tree, torch.Tensor):
        return tree.to(group[0].torch_device)
    return tree


def _split_leaves(obj: Any) -> List[Tuple[Tuple[str, ...], ShardedLeaf]]:
    """(owner path, leaf) of every split leaf of a module (the owner's
    attribute path, the attribute last) or a tree (its keys)."""
    if isinstance(obj, torch.nn.Module):
        return [(tuple(f"{name}.{attr}".lstrip(".").split(".")), v)
                for name, m in obj.named_modules()
                for attr, v in vars(m).items() if isinstance(v, ShardedLeaf)]
    if isinstance(obj, ShardedLeaf):
        return [((), obj)]
    items = obj.items() if isinstance(obj, dict) else \
        enumerate(obj) if isinstance(obj, (list, tuple)) else ()
    return [((str(k),) + path, leaf) for k, v in items
            for path, leaf in _split_leaves(v)]


class _Applied(torch.nn.Module):
    """``apply(model, x, train=True)`` as a forward, so
    ``torch.func.functional_call`` runs it with a shard's leaves."""

    def __init__(self, apply: Callable, model: torch.nn.Module):
        super().__init__()
        self.apply_fn = apply
        self.model = model

    def forward(self, x: torch.Tensor):
        return self.apply_fn(self.model, x, train=True)


def _shard_loop(jobs: "queue.SimpleQueue") -> None:
    while True:
        job = jobs.get()
        if job is None:
            return
        fn, done = job
        try:
            fn()
        except BaseException:   # noqa: BLE001 - the step raises it: the
            pass                # shard group keeps the first error
        finally:
            done.set()
        del job, fn, done      # the step must not outlive its last call


def _stop_shard_threads(queues: List["queue.SimpleQueue"]) -> None:
    for q in queues:
        q.put(None)


class _ShardThreads:
    """The host threads of shards 1..S−1, alive as long as their step, so
    what torch keeps per thread (cuDNN's execution plans, library
    handles) is built once, not at every step."""

    def __init__(self, n: int):
        self._queues = [queue.SimpleQueue() for _ in range(n)]
        self.threads = [threading.Thread(target=_shard_loop, args=(q,),
                                         name=f"train-shard-{k + 1}",
                                         daemon=True)
                        for k, q in enumerate(self._queues)]
        for t in self.threads:
            t.start()
        self._stop = weakref.finalize(self, _stop_shard_threads,
                                      self._queues)

    def submit(self, k: int, fn: Callable[[], None]) -> threading.Event:
        """Run ``fn`` on shard ``k``'s thread; the event is set once it
        returned or raised."""
        done = threading.Event()
        self._queues[k - 1].put((fn, done))
        return done

    def close(self) -> None:
        self._stop()
        for t in self.threads:
            t.join()


class TrainStep:
    """``step(params, opt_state, x, y) -> (params, opt_state, loss)``:
    the forward with ``train=True`` over the whole batch, the loss, the
    backward, and one update of every leaf.  ``params`` and ``opt_state``
    are the objects :func:`train_step` returned (updated in place and
    handed back, as the JAX step hands back new ones); ``loss`` is a 0-d
    tensor on :attr:`device`, the first data shard's.

    Over S = ``len(devices)`` > 1 data shards the forward splits (module
    docstring): shard *k* runs rows ``[k*b/S, (k+1)*b/S)`` on
    ``devices[k]`` on a host thread of its own (shard 0 on the caller's,
    the others on threads that live with the step: :meth:`close` ends
    them), with the master leaves
    ``.to(devices[k])`` (a module through ``torch.func.functional_call``
    on a leafless copy of it), every thread setting its grad mode, CUDA
    device and stream and entering ``utils/profile.py``'s gate; the
    batch-norm moments combine over a :class:`~.syncbn.ShardGroup`
    (``barrier_timeout`` seconds a barrier).  A shard's error aborts the
    others, and the step raises the first one.

    :meth:`apply` runs the forward alone (``train=False``: the stored
    statistics, as the JAX trainer's eval calls the apply), stacked.

    With ``ranks`` (:class:`~.syncbn.RankShards`: the mesh's data shards
    lie on more than one process) ``x``/``y`` are this rank's rows, its
    shards' in shard order, and the step always splits, over this rank's
    shards (one or more), the moments exchanged across ranks.  Before the
    forward one ``all_reduce`` gives every rank each rank's row count,
    shard count and row shape: unless every data shard takes the same
    number of rows of one shape, every rank raises ``ValueError``.  The
    loss of this rank's rows is scaled by ``b_local / B_global``; after
    the backward one ``all_reduce`` a bucket (a device and dtype) sums the
    leaves' gradients and the loss parts over the ranks; the returned
    loss is the global batch's, on every rank.

    With a ``model`` axis (``groups``: each data shard's lead record, then
    the rest of its ``model`` group) a leaf split by the step's rules is a
    :class:`ShardedLeaf` of trainable slices on the first shard's group;
    shard *k* runs with them ``.to()`` its own group (:func:`_leaf_on`),
    and the convolutions and products gather after each layer
    (:class:`ShardedLeaf`), so autograd brings every slice its gradient
    through the gathers.  Before a shard's thread reads what the caller's
    streams wrote (its rows, the master leaves the last update wrote), its
    current streams wait on an event recorded on the caller's.

    For measurement: ``record_events`` keeps four CUDA events a step on
    the first shard's device (start, forward done, backward done, update
    done; :meth:`timings`) and, for a split step, the host ms the
    slowest-waiting shard spent at the forward's barriers
    (``barrier_ms``: host clocks, no synchronisation); ``last_loss`` is the
    latest step's loss.  Across ranks it also keeps, a step, the host ms
    of the gradient all-reduce (``reduce_ms``) and of the moments'
    exchanges, forward and backward (``exchange_ms``), and, where a
    ``model`` group spans ranks, of the split layers' gathers
    (``gather_ms``) and input-gradient reductions (``input_ms``), each
    summed over the threads that spent them.

    Where a ``model`` group spans ranks (``ranks.models``) ``groups`` holds
    this rank's records of each of its shards' groups, ``x``/``y`` are the
    rows of every data shard this rank runs (each shard's rows given to
    every rank of its group alike: a digest of them is compared across the
    group before the forward), and the loss, the moments and the gradients
    reduce once a data shard (module docstring, :meth:`_reduce`).

    Across ranks the trained step is saved by every rank together:
    ``checkpoint.save_step(root, n, trained_tree(params, gather=False),
    group=step.ranks.every)`` writes one orbax step, each rank's share
    into its own ``ocdbt.process_<rank>/`` store under one merged
    manifest, which the JAX ``load_orbax`` and the port's ``load_dir``
    read whole (:func:`trained_tree`)."""

    def __init__(self, apply: Callable, params: Any,
                 opt_state: torch.optim.Optimizer,
                 leaves: List[torch.Tensor], loss_fn: Callable,
                 groups: Sequence[Sequence[Any]],
                 placement: Optional[MeshParams] = None,
                 ranks: Optional[syncbn.RankShards] = None):
        self.apply = apply
        self.params = params
        self.opt_state = opt_state
        self.leaves = leaves
        self.loss_fn = loss_fn
        self.groups = [list(g) for g in groups]
        #: the rules' placement of the leaves (``specs``), or None without
        #: a ``model`` axis of more than one device
        self.placement = placement
        #: this rank's shards among every rank's, or None in one process
        self.ranks = ranks
        self.devices = [g[0].torch_device for g in self.groups]
        self.device = self.devices[0]
        self.data_size = len(self.devices)
        self.barrier_timeout = syncbn.BARRIER_TIMEOUT_S
        self.steps = 0
        self.last_loss: Optional[torch.Tensor] = None
        self.record_events = False
        self.events: List[Tuple[Any, ...]] = []
        self.barrier_ms: List[float] = []
        self.reduce_ms: List[float] = []
        self.exchange_ms: List[float] = []
        self.gather_ms: List[float] = []
        self.input_ms: List[float] = []
        self._shells: Optional[List[_Applied]] = None
        self._threads: Optional[_ShardThreads] = None
        self._split = _split_leaves(params)
        if self.data_size > 1 and isinstance(params, torch.nn.Module):
            # a shard's module holds no weights of its own: the master
            # leaves go in at each call (meta: an unswapped leaf raises),
            # a split leaf's slices as a ShardedLeaf over the shard's group
            self._named = [("model." + n, t) for n, t in
                           list(params.named_parameters())
                           + list(params.named_buffers())]
            self._shells = [_Applied(apply, copy.deepcopy(
                params, {id(leaf): None for _, leaf in self._split})
                .to("meta")) for _ in self.devices]

    def _event(self):
        if not self.record_events or self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def leaf_bytes(self) -> Dict[str, int]:
        """Bytes of the master leaves on each record of the first shard's
        group: the whole leaves on its lead, each split leaf's slice *j*
        on its *j*-th record (across ranks: this rank's records of the
        group and their slices)."""
        group = self.groups[0]
        out = {str(d): 0 for d in group}
        split = {id(t) for _, leaf in self._split for t in leaf.slices}
        out[str(group[0])] = sum(t.numel() * t.element_size()
                                 for t in self.leaves if id(t) not in split)
        for _, leaf in self._split:
            for t, d in zip(leaf.slices, group):
                out[str(d)] += t.numel() * t.element_size()
        return out

    def _shard_forward(self, k: int, x: torch.Tensor):
        dev, group = self.devices[k], self.groups[k]
        across = self.ranks.models[k] if self.ranks is not None else None
        if self._shells is None:
            return self.apply(_tree_on(self.params, group, across), x,
                              train=True)
        model = self._shells[k].model
        for path, leaf in self._split:
            owner = model.get_submodule(".".join(path[:-1]))
            setattr(owner, path[-1], _leaf_on(leaf, group, across))
        return torch.func.functional_call(
            self._shells[k], {n: t.to(dev) for n, t in self._named}, (x,))

    def _split_forward(self, x: torch.Tensor):
        """The S shards' forwards over one group; their logits gathered
        on the first shard's device in shard order."""
        s = self.data_size
        blocks = x.split(x.shape[0] // s)
        group = syncbn.ShardGroup(s, self.barrier_timeout, self.ranks)
        streams = [torch.cuda.current_stream(d) if d.type == "cuda"
                   else None for d in self.devices]
        # the rows and the master leaves, as the caller's streams wrote them
        ready = {}
        for d in {d.torch_device for d in self.groups[0]}:
            if d.type == "cuda":
                ready[d] = torch.cuda.Event()
                ready[d].record(torch.cuda.current_stream(d))
        outs: List[Any] = [None] * s

        def run(k: int) -> None:
            dev = self.devices[k]
            with group.shard(k), GATE.inside(), _on(dev), \
                    (torch.cuda.stream(streams[k]) if streams[k] is not None
                     else nullcontext()), torch.enable_grad():
                for d, ev in ready.items():
                    torch.cuda.current_stream(d).wait_event(ev)
                outs[k] = self._shard_forward(k, blocks[k].to(dev))

        if self._threads is None:
            self._threads = _ShardThreads(s - 1)
        dones = [self._threads.submit(k, functools.partial(run, k))
                 for k in range(1, s)]
        try:
            run(0)
        except syncbn.ShardGroupError:
            pass    # another shard's error or a timeout: raised below
        finally:
            with GATE.outside():   # a wait, not a torch op
                for done in dones:
                    done.wait()
        if group.error is not None:
            raise group.error[1]
        if self.record_events:
            self.barrier_ms.append(max(group.wait_s) * 1e3)
        return torch.cat([o.to(self.device) for o in outs])

    def __call__(self, params, opt_state, x, y):
        if params is not self.params or opt_state is not self.opt_state:
            raise ValueError("train step: pass back the params and "
                             "optimizer state the step returned")
        x = _as_device_tensor(x, self.device)
        y = _as_device_tensor(y, self.device)
        ranks = self.ranks
        if ranks is not None:
            batch = self._global_batch(x)
        elif x.shape[0] % self.data_size:
            raise ValueError(
                f"train step: batch {x.shape[0]} does not split over the "
                f"data axis of size {self.data_size}")
        with _on(self.device), torch.enable_grad():
            e0 = self._event()
            opt_state.zero_grad(set_to_none=True)
            if ranks is not None:
                ranks.exchange_s = ranks.gather_s = ranks.input_s = 0.0
            out = self.apply(params, x, train=True) \
                if self.data_size == 1 and ranks is None \
                else self._split_forward(x)
            loss = self.loss_fn(out, y)
            if ranks is not None:   # these rows' share of the global loss
                loss = loss * (x.shape[0] / batch)
            e1 = self._event()
            loss.backward()
            e2 = self._event()
            for t in self.leaves:
                if t.grad is None:   # not in the graph: a zero gradient,
                    t.grad = torch.zeros_like(t)   # as JAX's grad gives
            if ranks is not None:
                loss = self._reduce(loss.detach())
            opt_state.step()
            e3 = self._event()
        if e0 is not None:
            self.events.append((e0, e1, e2, e3))
        if ranks is not None and self.record_events:
            self.exchange_ms.append(ranks.exchange_s * 1e3)
            self.gather_ms.append(ranks.gather_s * 1e3)
            self.input_ms.append(ranks.input_s * 1e3)
        self.steps += 1
        self.last_loss = loss.detach()
        return params, opt_state, self.last_loss

    def _global_batch(self, x: torch.Tensor) -> int:
        """The global batch's row count (each data shard's rows once,
        however many ranks run it), after one ``all_reduce`` over every
        rank of each rank's (rows, data shards, ``x.dim()``, row shape)
        and, where a ``model`` group spans ranks, a digest of each of its
        data shards' rows (:func:`_row_digests`); raises ``ValueError`` on
        every rank where a rank's rows do not split over its shards, a
        shard's rows differ in count or shape from another's, or the ranks
        of one data shard's model group were given different rows."""
        import torch.distributed as dist

        from .multihost import backend

        r = self.ranks
        across = [k for k, o in enumerate(r.owners or ()) if len(o) > 1]
        dims = list(x.shape[1:1 + _ROW_DIMS])
        head = 3 + _ROW_DIMS
        info = torch.zeros((r.world, head + 3 * len(across)),
                           dtype=torch.int64)
        info[r.rank, :3 + len(dims)] = torch.tensor(
            [x.shape[0], self.data_size, x.dim()] + dims)
        if across and x.shape[0] and x.shape[0] % self.data_size == 0:
            digests = _row_digests(x, self.data_size)
            for i, k in enumerate(r.index):
                if k in across:
                    c = head + 3 * across.index(k)
                    info[r.rank, c:c + 3] = digests[i]
        if backend() == "nccl":
            info = info.to(self.device)
        dist.all_reduce(info)
        rows = info.tolist()
        counts = [(b, s) for b, s, *_ in rows]
        bad = [q for q, (b, s) in enumerate(counts) if b % s]
        if bad:
            raise ValueError(
                f"train step: the batch of rank {bad[0]} ({counts[bad[0]][0]}"
                f" rows) does not split over its {counts[bad[0]][1]} data "
                f"shards (rows and data shards by rank: {counts})")
        if len({b // s for b, s in counts}) > 1:
            raise ValueError(
                f"train step: the ranks' rows are of unequal count for "
                f"their data shards (rows and data shards by rank: "
                f"{counts}); every data shard takes as many rows")
        if len({tuple(row[2:head]) for row in rows}) > 1:
            raise ValueError(
                f"train step: the ranks' rows differ in shape (row shape "
                f"by rank: {[row[3:2 + row[2]] for row in rows]})")
        for i, k in enumerate(across):
            c = head + 3 * i
            seen = {p: tuple(rows[p][c:c + 3]) for p in r.owners[k]}
            if len(set(seen.values())) > 1:
                raise ValueError(
                    f"train step: data shard {k}'s rows differ between the "
                    f"ranks {list(r.owners[k])} of its model group (digest "
                    f"by rank: {seen}); every rank of a model group takes "
                    f"that shard's rows")
        return counts[0][0] // counts[0][1] * r.size

    def _reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """One ``all_reduce(SUM)`` a bucket of the leaves' gradients (a
        bucket a device and dtype, in leaf order), this rank's loss part at
        the end of its own device's and dtype's; each gradient becomes its
        slice of the summed bucket.  Returns the summed loss.

        The replicated leaves' buckets and the loss sum over every rank
        and are divided by ``ranks.mates``, the ranks of a data shard's
        model group: each of them computes those gradients from that
        shard's rows, so the sum counts each shard once a rank of its
        group.  Every rank then holds the same sum, whatever order its own
        kernels added in (cuDNN's default backward algorithms are not
        bit-reproducible), so the replicated leaves stay bit-equal on
        every rank.  Where a group spans ranks a split leaf's slices go in
        buckets of their own, summed over the data peers: the ranks that
        hold those slices, each shard's once."""
        t0 = time.perf_counter()
        r = self.ranks
        split = {id(t) for _, leaf in self._split for t in leaf.slices} \
            if r.peers is not r.every else set()
        buckets: Dict[Tuple, List[torch.Tensor]] = {}
        for t in self.leaves:
            buckets.setdefault((id(t) in split, t.grad.device, t.grad.dtype),
                               []).append(t)
        key = (False, loss.device, loss.dtype)
        buckets.setdefault(key, [])
        total = loss
        for k, ts in buckets.items():
            parts = [t.grad.reshape(-1) for t in ts]
            if k == key:
                parts.append(loss.reshape(1))
            flat = torch.cat(parts)
            if k[0]:
                r.all_reduce(flat)
            else:
                r.every.all_reduce(flat)
                if r.mates > 1:
                    flat.div_(r.mates)
            o = 0
            for t in ts:
                n = t.grad.numel()
                t.grad = flat[o:o + n].view_as(t.grad)
                o += n
            if k == key:
                total = flat[o]
        if self.record_events:
            self.reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return total

    def close(self) -> None:
        """End the shard threads (a later call starts them anew)."""
        if self._threads is not None:
            self._threads.close()
            self._threads = None

    def timings(self) -> List[Tuple[float, float, float]]:
        """(forward, backward, update) ms of each recorded step, from its
        CUDA events (waits for the last one)."""
        out = []
        for e0, e1, e2, e3 in self.events:
            e3.synchronize()
            out.append((e0.elapsed_time(e1), e1.elapsed_time(e2),
                        e2.elapsed_time(e3)))
        return out


#: the row dimensions a cross-rank step compares between ranks
_ROW_DIMS = 8
#: the low bits of each 4-byte word that a row digest squares
_LOW = 0x7FFF


def _row_digests(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n, 3) int64 on the host: for each of ``x``'s ``n`` row blocks, the
    sum of its 4-byte words (1- and 2-byte elements widened), the sum of
    each row's low 15 bits weighted by the row's place in its block, and
    the sum of their squares.  Integer sums: the same rows give the same
    digest on any device and thread count, and no sum overflows for rows
    of under 2^24 words."""
    b = x.shape[0]
    v = x.detach().reshape(b, -1).contiguous()
    v = v.view({1: torch.uint8, 2: torch.int16}.get(v.element_size(),
                                                    torch.int32))
    v = v.to(torch.int32)
    low = v & _LOW
    place = torch.arange(1, b // n + 1, device=v.device).repeat(n)
    sums = torch.stack([v.sum(1, dtype=torch.int64),
                        low.sum(1, dtype=torch.int64) * place,
                        (low * low).sum(1, dtype=torch.int64)], 1)
    return sums.reshape(n, b // n, 3).sum(1).cpu()


def train_step(mesh, apply_fn: Callable, params, optimizer=None,
               loss_fn: Callable = softmax_xent,
               rules: Callable = mobilenet_param_rules,
               data_axis: str = "data"):
    """Build the training step over ``mesh``: ``(step, params,
    opt_state)``, as the JAX ``train_step``.

    - ``apply_fn(params, x, train=True)`` is the forward.  A tree apply
      that caches a module per tree (``models.convert.tree_module_of``:
      ``mobilenet_v1_tree_apply``, ``mobilenet_v2_tree_apply``) is
      replaced by its module, built once from the tree; the step trains
      the module's leaves and the returned ``params`` is that module
      (``to_jax`` carries it back to a tree).  An ``nn.Module`` as
      ``params`` is trained as a copy.  Any other tree is copied with its
      floating leaves trainable.  The master leaves live on the first
      data shard's group.
    - The data shards are ``mesh``'s along ``data_axis``
      (:func:`data_shard_groups`); over more than one the step splits
      (:class:`TrainStep`), on any placement of their records.  Where
      they lie on more than one process (``make_mesh("data:-1")`` over
      the ``devices()`` of a world of R ranks), every rank of the
      ``torch.distributed`` group builds the step on the same mesh and
      calls it with its own rows: the step is the global batch's, with
      the moments and the gradients reduced over every rank
      (:class:`TrainStep`'s ``ranks``), and every rank's leaves stay
      bit-equal.  gloo reduces host or card tensors (two ranks on one
      card are gloo), NCCL card tensors only.
    - ``rules`` places the leaves as the JAX ``shard_params`` does: on a
      ``model`` axis of M > 1 devices, a leaf it splits whose split dim
      divides by M becomes M trainable slices, one on each device of the
      first data shard's ``model`` group (:class:`MeshParams`, the step's
      ``placement``); every other leaf, and every leaf of a mesh without
      a ``model`` axis, stays whole.
    - A ``model`` group may span ranks (``make_mesh("model:M,data:D")``
      over the ``devices()`` of M ranks, or ``hybrid_mesh(ici_axes=
      [("data", D)], dcn_axes=[("model", M)])``, or M/R records of each
      group on each of R ranks): a rank then holds only its records'
      slices, the split layers gather over the group's ranks, every rank
      of a group is given that data shard's rows, and each data shard
      counts once in the loss and the gradients (:func:`_shard_groups`,
      :class:`TrainStep`).
    - ``optimizer(leaves) -> torch.optim.Optimizer`` builds the update
      (default: :func:`make_optimizer`'s sgd, lr 1e-2, momentum 0.9, as
      the JAX default ``optax.sgd(1e-2, momentum=0.9)``) over the whole
      leaves and the slices; it is the returned ``opt_state``.

    Raises ``ValueError`` for a layout of ``model`` groups across
    processes the step does not take, and for data shards of processes
    that are not every rank of the group (:func:`_shard_groups`)."""
    from ..models.convert import tree_module_of

    groups, ranks = _shard_groups(mesh, data_axis)
    device = groups[0][0].torch_device
    entry = tree_module_of(apply_fn) \
        if not isinstance(params, torch.nn.Module) else None
    if isinstance(params, torch.nn.Module):
        params, apply = copy.deepcopy(params).to(device), apply_fn
    elif entry is not None:
        build, apply = entry
        params = build(params).to(device)
    else:
        params = _tree_copy(params, device)
        apply = apply_fn
    placement = None
    model_axis = "model" if "model" in mesh.axis_names \
        and data_axis != "model" else ""
    if model_axis and mesh.shape[model_axis] > 1:
        # the master leaves split in place over the first group
        placement = MeshParams(params, rules, model_axis,
                               place=lambda obj, dev: obj)
        params = placement.tree(
            groups[0], ranks.models[0] if ranks is not None else None)
    leaves = _trainable_leaves(params)
    opt_state = (optimizer or make_optimizer())(leaves)
    step = TrainStep(apply, params, opt_state, leaves, loss_fn, groups,
                     placement, ranks)
    return step, params, opt_state


def _trainable_leaves(obj: Any) -> List[torch.Tensor]:
    """Every floating leaf of a module or a tree, a split leaf's slices in
    its place (a module's after its own leaves), made trainable."""
    if isinstance(obj, ShardedLeaf):
        return [t.requires_grad_(True) for t in obj.slices]
    if isinstance(obj, torch.nn.Module):
        return _module_leaves(obj) + [t.requires_grad_(True)
                                      for _, leaf in _split_leaves(obj)
                                      for t in leaf.slices]
    if isinstance(obj, (dict, list, tuple)):
        values = obj.values() if isinstance(obj, dict) else obj
        return [t for v in values for t in _trainable_leaves(v)]
    if isinstance(obj, torch.Tensor) and obj.is_floating_point():
        return [obj.requires_grad_(True)]
    return []


def trained_tree(params: Any, gather: bool = True) -> Any:
    """The JAX-layout numpy tree of a step's ``params``: a module through
    its inverse (``models.convert.MODULE_TO_JAX``), a tree leaf by leaf
    (owned copies, so later steps do not write into it).  A leaf split
    over the ``model`` axis is gathered into one array, or, without
    ``gather``, kept as a :class:`ShardedLeaf` of host slices (each copied
    from its own device), which the orbax writer stores a chunk a slice.
    Where the split spans ranks, ``gather`` gathers each split leaf over
    its model subgroup (every rank of it calls this, and every rank gets
    the whole tree); without, the leaf holds this rank's slices, their
    indices in :attr:`ShardedLeaf.index`.  A step across ranks is saved
    from either tree by every rank together,
    ``checkpoint.save_step(root, n, tree, group=step.ranks.every)``
    (``trainers/orbax_write.py``): each slice written by the ranks holding
    it, no gather needed, each replicated leaf split over the ranks, every
    chunk once."""
    from ..core.buffer import to_numpy
    from ..models.convert import MODULE_TO_JAX

    if isinstance(params, torch.nn.Module):
        to_jax = MODULE_TO_JAX.get(type(params))
        if to_jax is None:
            raise ValueError(f"no JAX-layout inverse for module "
                             f"{type(params).__name__}")
        return trained_tree(to_jax(params), gather)
    if isinstance(params, dict):
        return {k: trained_tree(v, gather) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(trained_tree(v, gather) for v in params)
    if isinstance(params, ShardedLeaf):
        return params.numpy() if gather else params.host()
    if isinstance(params, torch.Tensor):
        return to_numpy(params.detach().contiguous()).copy()
    return params
