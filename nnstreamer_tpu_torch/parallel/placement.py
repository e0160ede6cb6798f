"""The ONE placement layer: where a model's programs run.

Counterpart of the JAX package's ``parallel/placement.py``.  The
``tensor_filter`` properties ``mesh=``/``sharding=``/``devices=`` resolve
here, once, into a mesh of device records, the named param-layout rules,
the batch (data) axes and a **canonical key** every equivalent spelling
shares — the ModelPool and shared-instance identity:

- :class:`Placement` — the declarative spec (the property strings,
  frozen + hashable).  Grammar: ``mesh="data:-1"``, ``"data:4,model:2"``,
  and DCN axes with a ``dcn.`` prefix (``"dcn.data:2,data:-1"``) that
  span the *processes* of a ``torch.distributed`` group, so a fleet of
  processes serves one logical pool: per-process window formation, the
  window's rows sharded over every process's devices.  In the port only
  ``dcn.`` axes span processes; every other axis lies over this
  process's devices.
- :class:`ResolvedPlacement` — the spec bound to device records
  (``parallel/mesh.py``): the mesh (DCN axes via
  :func:`~.multihost.hybrid_mesh`), the rules, the data axes, the data
  shards' device groups this process runs, and the key.

Every mesh consumer (the filter's programs, the ModelPool, the obs
placement labels) reads THIS object.  ``devices=`` subsets are checked
against each other process-wide (:func:`register_subset`): overlap is a
warning, or an error under ``NNS_TPU_TORCH_STRICT_PLACEMENT=1``.  The
registry keys subsets by device-record id, so virtual records over one
``torch.device`` are told apart.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.conf import ENV_PREFIX
from ..utils.device import parse_accel_kind  # noqa: F401 - re-exported

#: DCN axis marker in the mesh grammar: ``dcn.data:2`` declares a
#: cross-process axis (outer); unprefixed axes span this process's devices.
DCN_PREFIX = "dcn."

#: environment key turning subset overlap into an error
STRICT_ENV = f"{ENV_PREFIX}STRICT_PLACEMENT"

#: Force overlap detection into error mode (None = read
#: ``NNS_TPU_TORCH_STRICT_PLACEMENT`` at detection time).  Two pools
#: resolving OVERLAPPING explicit ``devices=`` subsets in one process
#: share devices silently: their dispatches contend for the same memory
#: and the per-shard attribution in ``obs/meshstat.py`` charges both
#: stages' frames to the shared devices.  Default is a loud warning.
STRICT_OVERLAP: Optional[bool] = None

_SUBSET_LOCK = threading.Lock()
#: platform -> {sorted device-id tuple -> registration count} of every
#: explicit ``devices=`` subset resolved in this process
_SUBSETS: Dict[str, Dict[Tuple[int, ...], int]] = {}
#: detected overlaps: (platform, subset_a, subset_b) -> detections
_OVERLAPS: Dict[Tuple[str, Tuple[int, ...], Tuple[int, ...]], int] = {}


def subset_label(ids: Sequence[int]) -> str:
    """Canonical short label of a device-index subset: contiguous runs
    collapse (``"0-3"``), everything else is a comma list (``"0,2,5"``)
    — the ``stage`` label on pool rows and ``nns_stage_*`` series."""
    ids = sorted(int(i) for i in ids)
    if not ids:
        return ""
    runs: List[List[int]] = [[ids[0], ids[0]]]
    for i in ids[1:]:
        if i == runs[-1][1] + 1:
            runs[-1][1] = i
        else:
            runs.append([i, i])
    return ",".join(str(a) if a == b else f"{a}-{b}" for a, b in runs)


def _strict_overlap() -> bool:
    if STRICT_OVERLAP is not None:
        return bool(STRICT_OVERLAP)
    return os.environ.get(STRICT_ENV, "") not in ("", "0", "false", "no")


def register_subset(platform: str, ids: Sequence[int]) -> None:
    """Record one explicit ``devices=`` subset and detect overlap with
    every DIFFERENT subset already resolved on the same platform, at
    ``resolve()`` time, before the placement serves a frame.  Overlap is
    logged and exported (``nns_placement_overlap``); under the strict
    flag it raises instead."""
    subset = tuple(sorted(int(i) for i in ids))
    if not subset:
        return
    hits: List[Tuple[int, ...]] = []
    with _SUBSET_LOCK:
        table = _SUBSETS.setdefault(str(platform), {})
        for other in table:
            if other != subset and set(other) & set(subset):
                pair = (str(platform),) + tuple(sorted((other, subset)))
                _OVERLAPS[pair] = _OVERLAPS.get(pair, 0) + 1
                hits.append(other)
        table[subset] = table.get(subset, 0) + 1
    for other in hits:
        shared = subset_label(set(other) & set(subset))
        msg = (f"placement overlap on {platform}: devices="
               f"{subset_label(subset)} shares device(s) {shared} with "
               f"already-resolved devices={subset_label(other)} — the "
               f"stages contend for the same memory and per-shard "
               f"attribution (obs/meshstat.py) is corrupted; split "
               f"the subsets or set {STRICT_ENV}=1 to make this an error")
        if _strict_overlap():
            raise ValueError(msg)
        from ..utils.log import logw

        logw(msg)


def overlap_snapshot() -> List[dict]:
    """One row per overlapping pair of subsets: the shared devices and
    how often the pair was resolved (the ``nns_placement_overlap``
    export)."""
    with _SUBSET_LOCK:
        pairs = dict(_OVERLAPS)
    return [{"platform": platform,
             "a": subset_label(a), "b": subset_label(b),
             "shared": subset_label(set(a) & set(b)),
             "count": n}
            for (platform, a, b), n in sorted(pairs.items())]


def reset_subsets() -> None:
    """Tests only: drop the subset inventory and overlap log."""
    with _SUBSET_LOCK:
        _SUBSETS.clear()
        _OVERLAPS.clear()


@dataclasses.dataclass(frozen=True)
class Placement:
    """Declarative placement: the ``tensor_filter`` property strings,
    normalized and hashable.  ``resolve()`` binds it to devices."""

    mesh: str = ""         # mesh grammar; "" = single-device placement
    sharding: str = ""     # named param-layout rules (PARAM_RULES)
    devices: str = ""      # device-index subset ("0-3", "4,5,6")
    accelerator: str = ""  # accelerator= grammar (selects the platform)

    @classmethod
    def from_props(cls, props: Any) -> "Placement":
        return cls(
            mesh=str(getattr(props, "mesh", "") or "").strip(),
            sharding=str(getattr(props, "sharding", "") or "").strip(),
            devices=str(getattr(props, "devices", "") or "").strip(),
            accelerator=str(getattr(props, "accelerator", "") or "").strip())

    @property
    def is_null(self) -> bool:
        """No mesh: the single-device placement."""
        return not self.mesh

    def axes(self) -> Tuple[Tuple[str, int, bool], ...]:
        """Parsed ``(name, size, is_dcn)`` triples in grammar order.  DCN
        axes must lead (outer DCN, inner local)."""
        out: List[Tuple[str, int, bool]] = []
        seen_ici = False
        for part in self.mesh.split(","):
            name, _, n = part.strip().partition(":")
            if not name:
                raise ValueError(f"empty axis in mesh {self.mesh!r}")
            dcn = name.startswith(DCN_PREFIX)
            if dcn and seen_ici:
                raise ValueError(
                    f"mesh {self.mesh!r}: dcn axes must come before "
                    f"local axes (outer-DCN, inner local)")
            seen_ici = seen_ici or not dcn
            out.append((name, int(n) if n.strip() else -1, dcn))
        return tuple(out)

    def resolve(self, dev_kind: Optional[str] = None
                ) -> Optional["ResolvedPlacement"]:
        """Bind to the visible devices; None for the null placement.
        Raises ``ValueError`` on an unsatisfiable spec."""
        if self.is_null:
            return None
        return ResolvedPlacement(self, dev_kind)

    def key(self, dev_kind: Optional[str] = None) -> Tuple:
        """Canonical placement key: equivalent spellings (``data:-1`` vs
        ``data:8`` on 8 devices, ``dp`` vs ``replicated``, ``gpu`` vs
        ``true:cuda``) map to ONE tuple.  Falls back to the raw strings
        when the spec cannot resolve here (the open reports the real
        error).  Only successful resolutions are cached, per
        (placement, kind, inventory)."""
        if dev_kind is None:
            dev_kind = parse_accel_kind(self.accelerator)
        if self.is_null:
            return ("device", dev_kind or "")
        return _cached_key(self, dev_kind)


@functools.lru_cache(maxsize=256)
def _resolved_key(placement: "Placement", dev_kind: Optional[str],
                  generation: int) -> Tuple:
    return placement.resolve(dev_kind).key


def _cached_key(placement: "Placement", dev_kind: Optional[str]) -> Tuple:
    from .mesh import generation

    try:
        # lru_cache never stores a raised call: a spec that fails now
        # (a dcn placement keyed before the process group formed)
        # re-resolves later instead of pinning a raw key
        return _resolved_key(placement, dev_kind, generation())
    except Exception:  # noqa: BLE001 - unresolvable spec: raw key keeps
        # the pools distinct; configure() raises the actual diagnostic
        return ("raw", placement.mesh, placement.sharding,
                placement.devices, dev_kind or "")


class ResolvedPlacement:
    """A :class:`Placement` bound to device records: the mesh, the param
    rules, the data axes, this process's data-shard groups and the
    canonical key."""

    def __init__(self, spec: Placement, dev_kind: Optional[str] = None):
        from .mesh import devices, local_devices, make_mesh, \
            parse_device_indices
        from .multihost import hybrid_mesh, process_info
        from .sharded import PARAM_RULES, data_shard_groups, get_param_rules

        self.spec = spec
        if dev_kind is None:
            dev_kind = parse_accel_kind(spec.accelerator)
        self.dev_kind = dev_kind
        rank, world = process_info()
        axes = spec.axes()
        self.dcn_axes = tuple((n, s) for n, s, d in axes if d)
        self.ici_axes = tuple((n, s) for n, s, d in axes if not d)
        if not self.ici_axes:
            raise ValueError(
                f"mesh {spec.mesh!r} declares no local axis")
        if self.dcn_axes:
            if spec.devices:
                raise ValueError(
                    f"devices={spec.devices!r} cannot restrict a "
                    f"multi-process (dcn) mesh — the DCN tier owns "
                    f"device assignment per process")
            dcn_sizes = self._fill_wildcard(
                [s for _, s in self.dcn_axes], world,
                f"dcn axes of mesh {spec.mesh!r}")
            self.dcn_axes = tuple(
                (n, s) for (n, _), s in zip(self.dcn_axes, dcn_sizes))
            local = local_devices(dev_kind)
            # a fixed local tier may use a PREFIX of the local devices;
            # only a wildcard must absorb them all
            ici_sizes = self._fill_wildcard(
                [s for _, s in self.ici_axes], len(local),
                f"local axes of mesh {spec.mesh!r}", exact=False)
            self.ici_axes = tuple(
                (n, s) for (n, _), s in zip(self.ici_axes, ici_sizes))
            self.mesh = hybrid_mesh(list(self.ici_axes),
                                    list(self.dcn_axes),
                                    devices=devices(dev_kind))
        else:
            devs = local_devices(dev_kind)
            if spec.devices:
                idx = parse_device_indices(spec.devices, len(devs))
                devs = [devs[i] for i in idx]
                # stage-subset inventory: validate THIS subset against
                # every explicit subset already resolved in the process
                register_subset(devs[0].platform if devs else "",
                                (d.id for d in devs))
            fixed = math.prod(s for _, s in self.ici_axes if s != -1)
            if not any(s == -1 for _, s in self.ici_axes):
                if len(devs) < fixed:
                    raise ValueError(
                        f"mesh {spec.mesh!r} wants {fixed} devices, "
                        f"have {len(devs)}")
                if spec.devices and len(devs) != fixed:
                    # an explicit placement is used exactly: a prefix
                    # would leave declared devices idle
                    raise ValueError(
                        f"devices={spec.devices!r} names {len(devs)} "
                        f"devices but mesh {spec.mesh!r} uses {fixed}")
                devs = devs[:fixed]
            sizes = self._fill_wildcard(
                [s for _, s in self.ici_axes], len(devs),
                f"mesh {spec.mesh!r}")
            self.ici_axes = tuple(
                (n, s) for (n, _), s in zip(self.ici_axes, sizes))
            self.mesh = make_mesh(self.ici_axes, devices=devs)
        self.rules = get_param_rules(spec.sharding)
        # canonical rules name: aliases resolve to one callable — key by
        # the first name that maps to it, not by what the user typed
        self.rules_name = sorted(
            k for k, v in PARAM_RULES.items() if v is self.rules)[0]
        # batch (data) axes: every axis whose base name is the primary
        # data name — "data" when present, else the first local axis —
        # DCN tier included, so a dcn.data window shards over processes
        # x local devices
        names = [n for n, _ in self.dcn_axes + self.ici_axes]
        base = [n[len(DCN_PREFIX):] if n.startswith(DCN_PREFIX) else n
                for n in names]
        primary = "data" if "data" in base else self.ici_axes[0][0]
        self.data_axes = tuple(
            n for n, b in zip(names, base) if b == primary)
        for n, _ in self.dcn_axes:
            if n not in self.data_axes:
                # the DCN tier is data-parallel ONLY: every process
                # contributes a batch slice; model parallelism over
                # processes would need a cross-process gather per layer
                raise ValueError(
                    f"mesh {spec.mesh!r}: dcn axis {n!r} is not a "
                    f"data axis — the DCN (cross-process) tier must "
                    f"be data-parallel (name it dcn.{primary}); put "
                    f"model/tensor parallelism on the local tier")
        #: the local data axis — the label single-axis consumers
        #: (meshstat attribution) report against
        self.data_axis = next(
            (n for n in self.data_axes if not n.startswith(DCN_PREFIX)),
            self.data_axes[0])
        self.num_processes = math.prod(
            s for _, s in self.dcn_axes) if self.dcn_axes else 1
        self.process_index = rank if self.dcn_axes else 0
        mesh_axes = tuple(
            (str(n), int(s)) for n, s in zip(self.mesh.axis_names,
                                             self.mesh.devices.shape))
        self.key = ("mesh", self.platform, mesh_axes, self.device_ids,
                    self.rules_name)
        #: canonical stage label ("0-3") when the spec pinned an explicit
        #: ``devices=`` subset; "" for auto-placed meshes
        self.stage = subset_label(self.device_ids) if spec.devices else ""
        #: this process's data shards, in shard order: the devices of
        #: each along the ``model`` axis (lead device first)
        self.groups = data_shard_groups(
            self.mesh, self.data_axes,
            process_index=rank if self.dcn_axes else None)
        if not self.groups:
            raise ValueError(f"mesh {spec.mesh!r}: no data shard on "
                             f"process {rank}")
        #: where this process gathers a dispatch's outputs
        self.lead = self.groups[0][0]

    @property
    def device_ids(self) -> Tuple[int, ...]:
        """The mesh's device ids in mesh order — membership test for the
        cross-stage handoff."""
        return self.mesh.device_ids

    @staticmethod
    def _fill_wildcard(sizes: List[int], total: int, what: str,
                       exact: bool = True) -> List[int]:
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"{what}: more than one -1 axis")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if fixed <= 0 or total % fixed or total == 0:
                raise ValueError(
                    f"{what}: {total} not divisible by fixed axes "
                    f"{fixed}")
            sizes = list(sizes)
            sizes[wild[0]] = total // fixed
        elif (fixed != total) if exact else (fixed > total):
            raise ValueError(f"{what}: wants {fixed}, have {total}")
        return list(sizes)

    # -- shardings ------------------------------------------------------------

    @property
    def data_axis_size(self) -> int:
        """GLOBAL batch parallelism: product of every data axis
        (processes x local devices on a multi-process placement)."""
        return math.prod(int(self.mesh.shape[a]) for a in self.data_axes)

    @property
    def local_data_axis_size(self) -> int:
        """Per-process share of the data parallelism."""
        return max(self.data_axis_size // max(self.num_processes, 1), 1)

    def batch_sharding(self):
        """A leading batch dim sharded over every data axis."""
        from .sharded import NamedSharding, P

        axes = self.data_axes
        return NamedSharding(
            self.mesh, P(axes[0] if len(axes) == 1 else tuple(axes)))

    def window_sharding(self, bucket: int):
        """Sharding for a window of ``bucket`` LOCAL slots
        (``num_processes * bucket`` global), or None when the window
        cannot split evenly over the data axes."""
        if (int(bucket) * self.num_processes) % self.data_axis_size:
            return None
        return self.batch_sharding()

    def shard_params(self, params, place=None):
        """Lay a params tree over the mesh per the named rules."""
        from .sharded import _plain_place, shard_params

        return shard_params(self.mesh, params, self.rules,
                            place=place or _plain_place)

    def describe(self) -> str:
        """Observability label: ``mesh(<axes>)`` with RESOLVED sizes."""
        axes = ",".join(f"{n}:{s}"
                        for n, s in zip(self.mesh.axis_names,
                                        self.mesh.devices.shape))
        return f"mesh({axes})"

    @property
    def platform(self) -> str:
        return next(iter(self.mesh.devices.flat)).platform

    # -- window feed (the "stack once, dispatch sharded" path) ---------------

    def feed_window(self, stacked: Sequence[Any]) -> List[List[Any]]:
        """Place stacked window tensors (host arrays or tensors, this
        process's ``(bucket, ...)`` block) shard by shard: every data
        shard's rows go straight to its own lead device.  Returns, per
        input, the list of per-shard row blocks (one block, on the lead
        device, when the window cannot split)."""
        from ..core.buffer import from_numpy

        n = len(self.groups)
        out = []
        for arr in stacked:
            rows = int(arr.shape[0])
            split = rows % n == 0
            parts = np.split(arr, n) if split and isinstance(
                arr, np.ndarray) else (arr.split(rows // n) if split
                                       else [arr])
            groups = self.groups if split else self.groups[:1]
            out.append([
                from_numpy(np.ascontiguousarray(p), g[0].torch_device)
                if isinstance(p, np.ndarray) else p.to(g[0].torch_device)
                for p, g in zip(parts, groups)])
        return out

    def local_rows(self, arr):
        """This process's rows of a global batch (``num_processes``
        equal blocks, process-major) — the demux side of a
        multi-process dispatch."""
        if self.num_processes <= 1:
            return arr
        k = int(arr.shape[0]) // self.num_processes
        return arr[self.process_index * k:(self.process_index + 1) * k]

    def gather_global(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's rows of a multi-process dispatch, concatenated
        in process order (``torch.distributed.all_gather``)."""
        if self.num_processes <= 1:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.num_processes)]
        dist.all_gather(parts, t)
        return torch.cat(parts)
