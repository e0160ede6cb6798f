"""Per-shard mesh attribution — who on the mesh actually did the work.

Counterpart of the JAX package's ``obs/meshstat.py``: every mesh dispatch
(the torch-cuda single-frame mesh path, ``invoke_batched`` windows over a
placement, and direct :class:`~nnstreamer_tpu_torch.parallel.sharded.
ShardedModel` calls) records into the process-wide :data:`MESH_STATS`:

- the **topology** it ran over (axis names/sizes, device list, the data
  axis batches shard along);
- the **per-shard useful-frame split**: micro-batch slots fill in stack
  order and the sharded invoke splits them in contiguous rows, so with
  ``frames`` real frames in a ``slots``-slot window over ``S`` shards,
  shard *i* holds the overlap of its slot range with ``[0, frames)``.
  The cumulative per-shard counts drive ``nns_shard_imbalance``
  (``max/mean - 1``: 0.0 on even splits);
- **pad-slot waste** per window (``slots - frames``): pad slots run the
  full computation on every window — the figure nns-torch-lint NNS509
  warns about statically;
- dispatches whose batch could not shard at all (not divisible by the
  data axis: the input is **replicated**).

Pulled by the metrics registry at scrape time: the snapshot's ``mesh``
table, the ``nns_shard_imbalance`` / ``nns_mesh_*`` families, and the
MESH section of ``nns-top`` (one row per device).  The store's lock is
a leaf: nothing is called while holding it.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import hooks as _hooks

#: fast-path flag (same contract as obs/transfer.py)
ACTIVE = not _hooks.DISABLED


class _Row:
    __slots__ = ("axes", "devices", "data_axis", "shards", "dispatches",
                 "frames", "slots", "pad_slots", "replicated_dispatches",
                 "shard_frames")

    def __init__(self, axes, devices, data_axis, shards):
        self.axes: Tuple[Tuple[str, int], ...] = axes
        self.devices: Tuple[str, ...] = devices
        self.data_axis = data_axis
        self.shards = shards
        self.dispatches = 0
        self.frames = 0
        self.slots = 0
        self.pad_slots = 0
        self.replicated_dispatches = 0
        self.shard_frames = [0] * shards


def shard_device_label(row: dict, shard: int, empty: str = "") -> str:
    """Device label of one data-shard of a snapshot ``mesh`` row.
    A shard is a GROUP of devices on a 2D mesh (data x model): label
    with the group's first device plus a ``+N`` suffix for the rest.
    The device list is the mesh array flattened in C order; a device's
    data-shard index combines its coordinates along every data axis
    (``row["data_axis"]`` may name several, ``+``-joined — a
    multi-host ``dcn.data+data`` window shards over both tiers)
    row-major in mesh-axis order, exactly how ``PartitionSpec``
    spreads a leading batch dim over an axis tuple.  For
    ``mesh=model:2,data:2`` shard 0 is devices {0, 2}, a strided
    column of the array.  Shared by the registry's
    ``nns_mesh_shard_frames_total`` exposition and the nns-top MESH
    section — one definition, one DEVICE column."""
    devices = row["devices"]
    names = {n for n in str(row["data_axis"]).split("+") if n}
    # C-order strides: product of the axis sizes after each axis
    dims = []  # (size, stride) of each data axis, mesh order
    stride = 1
    for name, size in reversed(list(row["axes"])):
        if name in names:
            dims.append((int(size), stride))
        stride *= int(size)
    dims.reverse()
    if not dims:  # data axis absent: the whole mesh is one shard
        devs = list(devices)
    else:
        def shard_of(f: int) -> int:
            idx = 0
            for size, st in dims:
                idx = idx * size + (f // st) % size
            return idx

        devs = [d for f, d in enumerate(devices) if shard_of(f) == shard]
    if not devs:
        return empty
    return devs[0] + (f"+{len(devs) - 1}" if len(devs) > 1 else "")


def shard_split(slots: int, frames: int, shards: int) -> List[int]:
    """Useful frames per shard of one window: ``slots`` micro-batch
    slots spread evenly over ``shards`` (callers guarantee
    divisibility on the sharded path), filled with ``frames`` real
    frames in stack order — the trailing ``slots - frames`` pad slots
    land on the highest shards."""
    per = slots // max(shards, 1)
    return [max(0, min(frames - i * per, per)) for i in range(shards)]


class MeshStats:
    """Process-wide, thread-safe per-source mesh dispatch attribution."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[str, _Row] = {}

    def record_dispatch(self, source: str, topology: dict,
                        data_axis, slots: int, frames: int,
                        sharded: bool) -> None:
        """Count one mesh dispatch.  ``slots`` is the physical
        micro-batch size the executable ran (bucket for a batched
        window, the batch dim for the single-frame path), ``frames``
        the real frames it carried; ``sharded=False`` means the input
        could not split over the data axis and was replicated.
        ``data_axis`` is one axis name or a tuple of them (a placement
        batch-sharding over several tiers, e.g. ``dcn.data`` x
        ``data``): the shard count is the product and the row stores
        the ``+``-joined label."""
        names = (data_axis,) if isinstance(data_axis, str) \
            else tuple(data_axis)
        axes = tuple((str(n), int(s)) for n, s in topology["axes"])
        devices = tuple(topology["devices"])
        shards = 1
        for name, size in axes:
            if name in names:
                shards *= size
        data_axis = "+".join(names)
        key = str(source)
        with self._lock:
            row = self._rows.get(key)
            if row is None or row.axes != axes or row.devices != devices:
                # topology changed (new mesh/devices): fresh attribution
                row = self._rows[key] = _Row(axes, devices,
                                             str(data_axis), shards)
            row.dispatches += 1
            row.frames += int(frames)
            row.slots += int(slots)
            if not sharded:
                row.replicated_dispatches += 1
                # every device computes every slot: attribute the full
                # load to each shard (imbalance 0 — the waste shows in
                # replicated_dispatches, not in the split)
                for i in range(row.shards):
                    row.shard_frames[i] += int(frames)
                return
            row.pad_slots += max(int(slots) - int(frames), 0)
            for i, n in enumerate(shard_split(int(slots), int(frames),
                                              row.shards)):
                row.shard_frames[i] += n

    # -- pull side -----------------------------------------------------------

    def snapshot(self) -> List[dict]:
        """Rows for the registry's ``mesh`` table (v5), sorted by
        source."""
        out: List[dict] = []
        with self._lock:
            items = sorted(self._rows.items())
        for source, row in items:
            sf = list(row.shard_frames)
            mean = sum(sf) / len(sf) if sf else 0.0
            imbalance = (max(sf) / mean - 1.0) if mean > 0 else 0.0
            out.append({
                "source": source,
                "axes": [[n, s] for n, s in row.axes],
                "devices": list(row.devices),
                "data_axis": row.data_axis,
                "shards": row.shards,
                "dispatches": row.dispatches,
                "frames": row.frames,
                "slots": row.slots,
                "pad_slots": row.pad_slots,
                "pad_frac": row.pad_slots / row.slots
                if row.slots else 0.0,
                "replicated_dispatches": row.replicated_dispatches,
                "shard_frames": sf,
                "imbalance": imbalance,
            })
        return out

    def get(self, source: str) -> Optional[dict]:
        for row in self.snapshot():
            if row["source"] == str(source):
                return row
        return None

    def reset(self) -> None:
        """Tests only: drop every row."""
        with self._lock:
            self._rows.clear()


#: the process-wide store every mesh dispatch seam feeds
MESH_STATS = MeshStats()

#: topology is invariant for a built mesh — cache it per mesh object
#: so the per-dispatch hot path stops re-stringifying every device
#: (weak keys: a dropped mesh must not be pinned by its telemetry)
_topo_cache: "weakref.WeakKeyDictionary" = None  # type: ignore[assignment]


def _topology_of(mesh) -> dict:
    global _topo_cache
    if _topo_cache is None:
        import weakref

        _topo_cache = weakref.WeakKeyDictionary()
    from ..parallel.mesh import mesh_topology

    try:
        topo = _topo_cache.get(mesh)
    except TypeError:  # unhashable/unweakrefable mesh stand-in
        return mesh_topology(mesh)
    if topo is None:
        topo = mesh_topology(mesh)
        try:
            _topo_cache[mesh] = topo
        except TypeError:
            pass
    return topo


def record_dispatch(source: str, mesh, data_axis: str, slots: int,
                    frames: int, sharded: bool) -> None:
    """Module-level shim: extract the topology and record (inert under
    the global obs kill switch; never raises into the hot path)."""
    if not ACTIVE:
        return
    try:
        MESH_STATS.record_dispatch(str(source), _topology_of(mesh),
                                   data_axis, slots, frames, sharded)
    except Exception:  # noqa: BLE001 - telemetry must not kill a dispatch
        pass
