"""Sharded model execution: the sharding rules and the data/model-parallel
invoke.

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

Not here yet: ``train_step`` and ``softmax_xent`` (the sharded training
step) come with the trainer (ROADMAP item 7).
"""

from __future__ import annotations

import copy
import itertools
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


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
    keeps the split; anything else sees the gathered tensor."""

    def __init__(self, slices: Sequence[torch.Tensor], dim: int,
                 spec: PartitionSpec, shape: Sequence[int]):
        self.slices = list(slices)
        self.split_dim = int(dim)
        self.spec = spec
        self._shape = torch.Size(shape)

    shape = property(lambda self: self._shape)
    ndim = property(lambda self: len(self._shape))
    dtype = property(lambda self: self.slices[0].dtype)
    device = property(lambda self: self.slices[0].device)

    def full(self) -> torch.Tensor:
        """The whole parameter, gathered on the first slice's device."""
        dev = self.slices[0].device
        return torch.cat([s.to(dev) for s in self.slices], self.split_dim)

    def to(self, *args, **kwargs):
        dt = kwargs.get("dtype") if not args else args[0]
        if isinstance(dt, torch.dtype) and len(args) <= 1 and \
                set(kwargs) <= {"dtype"}:
            return ShardedLeaf([s.to(dt) for s in self.slices],
                               self.split_dim,
                               self.spec, self._shape)
        return self.full().to(*args, **kwargs)

    def __repr__(self) -> str:
        return (f"ShardedLeaf(shape={tuple(self._shape)}, dim={self.split_dim}, "
                f"slices={len(self.slices)})")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d and len(args) >= 2 \
                and isinstance(args[1], cls) and args[1].split_dim == 0 \
                and not isinstance(args[0], cls) \
                and kwargs.get("bias") is None:
            x, w = args[0], args[1]
            outs = [func(x.to(s.device), s, *args[2:], **kwargs)
                    for s in w.slices]
            return torch.cat([o.to(x.device) for o in outs], 1)
        if func in _MATMULS and len(args) == 2 \
                and isinstance(args[1], cls) \
                and args[1].split_dim == args[1].ndim - 1 \
                and not isinstance(args[0], cls):
            x, w = args
            outs = [torch.matmul(x.to(s.device), s) for s in w.slices]
            return torch.cat([o.to(x.device) for o in outs], -1)
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
                group: Sequence[Any], model_axis: str):
    """``leaf`` split over the group's ``model`` devices per ``spec``, or
    None when the split dim does not divide (the leaf stays whole)."""
    dims = [i for i, s in enumerate(spec) if s is not None]
    if not dims or spec[dims[0]] != model_axis:
        return None
    dim, n = dims[0], len(group)
    if n <= 1 or leaf.shape[dim] % n:
        return None
    k = leaf.shape[dim] // n
    with torch.no_grad():
        slices = [leaf.detach().narrow(dim, j * k, k).contiguous()
                  .to(group[j].torch_device) for j in range(n)]
    return ShardedLeaf(slices, dim, spec, tuple(leaf.shape))


class MeshParams:
    """A params tree laid over a mesh per ``rules``: :meth:`tree` gives the
    tree a data shard's group runs with (its replica, model-split leaves
    as :class:`ShardedLeaf`), placed once per distinct group of
    ``torch.device``s — virtual records over one device share it."""

    def __init__(self, params: Any, rules: Callable, model_axis: str,
                 place: Callable[[Any, torch.device], Any] = _plain_place):
        self.params = params
        self.rules = rules
        self.model_axis = model_axis
        self._place = place
        self._trees: Dict[Tuple, Any] = {}
        #: leaf path ("a.b.w") -> PartitionSpec actually applied
        self.specs: Dict[str, PartitionSpec] = {}

    def tree(self, group: Sequence[Any]) -> Any:
        key = tuple(d.torch_device for d in group)
        t = self._trees.get(key)
        if t is None:
            t = self._trees[key] = self._build(group)
        return t

    def _build(self, group: Sequence[Any]) -> Any:
        base = self._place(self.params, group[0].torch_device)
        return self._shard(base, (), group)

    def _shard(self, obj: Any, path: Tuple, group) -> Any:
        if isinstance(obj, torch.nn.Module):
            named = list(obj.named_parameters()) + list(obj.named_buffers())
            for name, leaf in named:
                lpath = path + tuple(name.split("."))
                spec = P(*self.rules(lpath, leaf))
                sl = _split_leaf(leaf, spec, group, self.model_axis)
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
            sl = _split_leaf(obj, spec, group, self.model_axis)
            self.specs[".".join(map(str, path))] = \
                spec if sl is not None else P()
            return obj if sl is None else sl
        if isinstance(obj, dict):
            return {k: self._shard(v, path + (k,), group)
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._shard(v, path + (i,), group)
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


def shard_params(mesh, params, rules: Callable = mobilenet_param_rules,
                 model_axis: str = "model",
                 place: Callable[[Any, torch.device], Any] = _plain_place
                 ) -> MeshParams:
    """Lay a params tree over ``mesh`` per ``rules``; a leaf whose split
    dim does not divide over the ``model`` axis (or a mesh without one)
    stays replicated."""
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
    gathered on the mesh's first device."""

    def __init__(self, mesh, fn: Callable, params: Any = None,
                 rules: Callable = mobilenet_param_rules,
                 data_axis: str = "data", donate: bool = False,
                 name: str = ""):
        from .multihost import process_info

        self.mesh = mesh
        self.name = name or getattr(fn, "__name__", "sharded")
        self._fn = fn
        self._data_axis = data_axis
        self._groups = data_shard_groups(mesh, (data_axis,),
                                         process_index=process_info()[0])
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
