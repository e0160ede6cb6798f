"""Multi-process runtime: the process group and hybrid (DCN x local) meshes.

Counterpart of the JAX package's ``parallel/multihost.py``, on
``torch.distributed``.  Every process runs the same program;
:func:`initialize` joins the process group (NCCL for the card, gloo for
the host), and a hybrid mesh puts its outer (DCN) axes across processes
and its inner axes across each process's local devices, so the only
traffic that crosses processes is the data-parallel tier's.

- :func:`initialize` wraps ``torch.distributed.init_process_group``,
  passing only what it was given: the rendezvous comes from the
  environment (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``)
  unless the caller names it.  NCCL without a card raises; it never
  drops to gloo behind the caller's back.
- :func:`hybrid_mesh` builds a :class:`~.mesh.Mesh` whose leading axes
  span processes; :func:`_mesh_by_process` groups devices by
  ``process_index`` (there is no slice topology to ask on a GPU or CPU
  cluster).

NCCL puts one rank on one GPU: on a one-card host the only NCCL world is
a one-rank world.  Two-rank worlds run on gloo over the host.

A world of several ranks also trains one model: ``sharded.train_step``
on a mesh whose data shards lie on every rank (``make_mesh("data:-1")``
over ``mesh.devices()``) reduces each batch-norm layer's moments and the
gradients over the ranks (``syncbn.RankShards``), gloo staging card
tensors through the host; two ranks on one card are a gloo world.  Where
a ``model`` group spans ranks (``make_mesh("model:2,data:4")`` over two
ranks' records) the step forms process subgroups (:func:`subgroups`):
one a model group, over which its split layers gather, and one a set of
data peers, over which the moments and the split slices' gradients
reduce (the replicated gradients reduce over every rank).  Such a step
is saved by every rank together, through a :class:`Subgroup` of them
(:func:`as_subgroup`; ``trainers/orbax_write.py`` exchanges each rank's
leaves with :meth:`Subgroup.all_gather_object`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join (or form) the process group.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL);
    ``backend`` defaults to NCCL when a card is present, gloo otherwise.
    With no arguments nothing is passed but the backend: the
    environment's rendezvous applies.  Call once per process."""
    import torch

    dist = _dist()
    kw = {}
    if coordinator_address is not None:
        addr = str(coordinator_address)
        kw["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "multihost.initialize: the nccl backend needs a card and "
            "torch.cuda.is_available() is False; pass backend='gloo' to "
            "run the group on the host")
    if backend == "nccl" and process_id is not None:
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)


def shutdown() -> None:
    """Leave the process group (no-op when none was formed)."""
    dist = _dist()
    _GROUPS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> Tuple[int, int]:
    """(process_index, process_count) of this process; (0, 1) without a
    process group."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def backend() -> str:
    """The process group's backend ("" without one)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return ""


def world_key() -> int:
    """Changes when the process group forms or goes (placement caches
    key on it, so a placement resolved before ``initialize`` re-resolves
    after)."""
    rank, world = process_info()
    return world * 4099 + rank


class Subgroup:
    """A set of ranks of the process group (``ranks``, ascending) and the
    ``torch.distributed`` group its collectives run on: ``group`` None is
    the default group (a set of every rank), and a set of one rank runs no
    collective.  :meth:`all_reduce` raises where the collective fails."""

    __slots__ = ("ranks", "group")

    def __init__(self, ranks: Sequence[int], group=None):
        self.ranks = tuple(sorted(int(r) for r in ranks))
        self.group = group

    def all_reduce(self, t) -> None:
        """SUM ``t`` in place over the set's ranks."""
        if len(self.ranks) > 1:
            _dist().all_reduce(t, group=self.group)

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in the set's rank order; each
        rank of the set calls it with its own."""
        if len(self.ranks) == 1:
            return [obj]
        out = [None] * len(self.ranks)
        _dist().all_gather_object(out, obj, group=self.group)
        return out

    def __repr__(self) -> str:
        return f"Subgroup(ranks={list(self.ranks)})"


def as_subgroup(group) -> Optional[Subgroup]:
    """``group`` as a :class:`Subgroup`: a ``Subgroup`` as it is, a
    ``torch.distributed`` process group with its ranks, None as None.
    Raises ``ValueError`` where this process is not one of its ranks."""
    if group is None or isinstance(group, Subgroup):
        sub = group
    else:
        sub = Subgroup(_dist().get_process_group_ranks(group), group)
    if sub is not None and process_info()[0] not in sub.ranks:
        raise ValueError(f"{sub!r} does not hold this process (rank "
                         f"{process_info()[0]})")
    return sub


#: (world_key, ranks, n) -> the n-th torch.distributed group of that set
_GROUPS: Dict[Tuple, object] = {}


def subgroups(rank_sets: Sequence[Sequence[int]]) -> List[Subgroup]:
    """One :class:`Subgroup` a set of ranks, in the order given: a set of
    two or more ranks gets a ``torch.distributed.new_group`` of its own
    (the default group's backend: gloo under gloo, NCCL under NCCL), even
    where it is every rank or repeats an earlier set of this call, so that
    collectives issued from different threads never share a group; a set
    of one rank gets none.  The groups are kept for the life of the
    process group (:func:`shutdown` drops them): a later call with the
    same sets gets the same groups and forms none.  ``new_group`` is
    collective over the whole world: every rank calls this with the same
    sets in the same order."""
    dist = _dist()
    rank = process_info()[0]
    seen: Dict[Tuple[int, ...], int] = {}
    out = []
    for rs in rank_sets:
        sub = Subgroup(rs)
        if len(sub.ranks) > 1:
            n = seen[sub.ranks] = seen.get(sub.ranks, -1) + 1
            key = (world_key(), sub.ranks, n)
            if key not in _GROUPS:
                _GROUPS[key] = dist.new_group(list(sub.ranks))
            sub.group = _GROUPS[key] if rank in sub.ranks else None
        out.append(sub)
    return out


def hybrid_mesh(ici_axes: Sequence[Tuple[str, int]],
                dcn_axes: Optional[Sequence[Tuple[str, int]]] = None,
                devices=None):
    """Mesh with process-spanning outer axes and local inner axes.

    ``ici_axes``: (name, size) per local axis, e.g. ``[("model", 4),
    ("data", 2)]``.  ``dcn_axes``: (name, size) per cross-process axis,
    e.g. ``[("replica", num_processes)]``; defaults to a size-1
    ``replica`` axis so one-process runs use the same call."""
    from .mesh import Mesh, devices as all_devices

    dcn_axes = list(dcn_axes or [("replica", 1)])
    ici_axes = list(ici_axes)
    names = tuple(n for n, _ in dcn_axes) + tuple(n for n, _ in ici_axes)
    ici_shape = tuple(int(s) for _, s in ici_axes)
    dcn_shape = tuple(int(s) for _, s in dcn_axes)
    devs = list(devices) if devices is not None else all_devices()
    if all(s == 1 for s in dcn_shape):
        n = int(np.prod(ici_shape))
        local = [d for d in devs
                 if d.process_index == process_info()[0]] or devs
        if len(local) < n:
            raise ValueError(
                f"hybrid_mesh: need {n} devices for {ici_axes}, have "
                f"{len(local)}")
        arr = np.empty(n, dtype=object)
        arr[:] = local[:n]
        return Mesh(arr.reshape(dcn_shape + ici_shape), names,
                    dcn_axes=tuple(n for n, _ in dcn_axes))
    arr = _mesh_by_process(devs, dcn_shape, ici_shape)
    return Mesh(arr, names, dcn_axes=tuple(n for n, _ in dcn_axes))


def _mesh_by_process(devices, dcn_shape, ici_shape) -> np.ndarray:
    """Group ``devices`` by ``process_index``: the DCN axes span
    processes (in process order), the local axes each process's devices
    (lowest ids first)."""
    groups: dict = {}
    for d in devices:
        groups.setdefault(d.process_index, []).append(d)
    ndcn = int(np.prod(dcn_shape))
    nici = int(np.prod(ici_shape))
    if len(groups) != ndcn:
        raise ValueError(
            f"hybrid_mesh: dcn axes {tuple(dcn_shape)} want {ndcn} "
            f"processes, group has {len(groups)}")
    ordered = []
    for pi in sorted(groups):
        local = sorted(groups[pi], key=lambda d: d.id)
        if len(local) < nici:
            raise ValueError(
                f"hybrid_mesh: ici axes {tuple(ici_shape)} want {nici} "
                f"devices per process, process {pi} has {len(local)}")
        ordered.extend(local[:nici])
    arr = np.empty(len(ordered), dtype=object)
    arr[:] = ordered
    return arr.reshape(tuple(dcn_shape) + tuple(ici_shape))
