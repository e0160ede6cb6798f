"""The device inventory and the mesh: the port's "device topology" service.

Counterpart of the JAX package's ``parallel/mesh.py``.  Where JAX hands
out ``jax.devices()`` and builds a ``jax.sharding.Mesh``, the port keeps
its own inventory of :class:`Device` records — a platform, an id, the
``process_index`` of the process that owns it and the ``torch.device``
it runs on — and a :class:`Mesh` is an ndarray of those records with
axis names (``data`` batches, ``model`` splits weights).

The inventory is ``torch.cuda.device_count()`` CUDA devices, or the one
host device.  On a multi-process group (``multihost.initialize``) every
process holds the same number of local devices and the global inventory
lists them process by process, ids ``rank * local + i``.

The **virtual-device seam** (:func:`set_virtual_devices`) is the
counterpart of ``--xla_force_host_platform_device_count``: ``n`` device
records with ids ``0..n-1`` laid over ONE real ``torch.device``.  The
tests and the card's correctness legs use it to run the sharded paths
over 8 devices on a one-device host; it is off unless a caller sets it,
and no pipeline property reaches it.  A tensor on a virtual inventory
cannot tell from its ``device`` which record holds it, so the sharded
paths tag what they produce with its home record (:func:`set_home`);
an untagged tensor lives on the first record over its ``torch.device``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Device:
    """One device record of the inventory."""

    platform: str           # "cuda", "cpu" or "meta"
    id: int                 # global id (unique across processes)
    process_index: int      # the process that owns it
    torch_device: torch.device

    def __str__(self) -> str:
        return f"{self.platform}:{self.id}"


_lock = threading.Lock()
#: (count, platform, torch.device) of the virtual inventory, or None
_virtual: Optional[Tuple[int, str, torch.device]] = None
#: bumped whenever the inventory changes; placement caches key on it
_generation = [0]


def set_virtual_devices(n: int, platform: str = "cpu") -> None:
    """Lay ``n`` device records (ids ``0..n-1``) over one real
    ``torch.device`` of ``platform`` ("cpu", or "cuda": the current
    card).  ``n <= 0`` turns the seam off."""
    global _virtual
    from ..utils.device import resolve_device

    with _lock:
        _virtual = (int(n), platform, resolve_device(platform)) \
            if int(n) > 0 else None
        _generation[0] += 1


def clear_virtual_devices() -> None:
    """Back to the real inventory."""
    set_virtual_devices(0)


def virtual_devices() -> Optional[Tuple[int, str]]:
    """``(count, platform)`` of the virtual inventory, or None."""
    v = _virtual
    return (v[0], v[1]) if v is not None else None


def generation() -> int:
    """A counter that changes whenever the inventory does."""
    from . import multihost

    return _generation[0] * 1000003 + multihost.world_key()


def _default_platform() -> str:
    v = _virtual
    if v is not None:
        return v[1]
    return "cuda" if torch.cuda.is_available() else "cpu"


def _local_records(platform: Optional[str], rank: int) -> List[Device]:
    v = _virtual
    kind = platform or _default_platform()
    if v is not None and kind in (v[1], "meta"):
        n, vplat, tdev = v
        if kind == "meta":
            vplat, tdev = "meta", torch.device("meta")
        return [Device(vplat, rank * n + i, rank, tdev) for i in range(n)]
    if kind == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [Device("cuda", rank * n + i, rank, torch.device("cuda", i))
                for i in range(n)]
    if kind in ("cpu", "meta"):
        return [Device(kind, rank, rank, torch.device(kind))]
    raise ValueError(f"unknown device platform {kind!r}")


def local_devices(platform: Optional[str] = None) -> List[Device]:
    """This process's device records of ``platform`` (default: the
    virtual platform when set, else cuda when a card is present, else
    cpu)."""
    from .multihost import process_info

    return _local_records(platform, process_info()[0])


def devices(platform: Optional[str] = None) -> List[Device]:
    """Every process's device records, process by process (one process:
    :func:`local_devices`)."""
    from .multihost import process_info

    rank, world = process_info()
    if world <= 1:
        return _local_records(platform, rank)
    out: List[Device] = []
    for p in range(world):
        out.extend(_local_records(platform, p))
    return out


def local_device_count(platform: Optional[str] = None) -> int:
    try:
        return len(local_devices(platform))
    except (RuntimeError, ValueError):
        return 0


HOME_ATTR = "_nns_home"


def set_home(t: torch.Tensor, device_ids) -> torch.Tensor:
    """Tag ``t`` with the ids of the device records that hold it — one
    id, or a mesh's ids for a dispatch's output (gathered on the mesh's
    first device, produced by all of it).  A virtual inventory cannot
    read this off ``t.device``."""
    ids = (int(device_ids),) if isinstance(device_ids, (int, np.integer)) \
        else tuple(int(i) for i in device_ids)
    try:
        setattr(t, HOME_ATTR, ids)
    except (AttributeError, RuntimeError):
        pass
    return t


def device_ids_of(t: torch.Tensor) -> Tuple[int, ...]:
    """Ids of the device records ``t`` lives on: its home tag, else the
    first local record over ``t.device``; empty when none matches."""
    home = getattr(t, HOME_ATTR, None)
    if home is not None:
        return home
    dev = getattr(t, "device", None)
    if dev is None:
        return ()
    try:
        recs = local_devices(dev.type)
    except (RuntimeError, ValueError):
        return ()
    for d in recs:
        if d.torch_device == dev or (
                d.torch_device.type == dev.type
                and d.torch_device.index in (None, dev.index)):
            return (d.id,)
    return ()


class Mesh:
    """An ndarray of :class:`Device` records with axis names; ``dcn_axes``
    names the axes that span processes (the outer, DCN tier)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 dcn_axes: Sequence[str] = ()):
        self.devices = devices
        self.axis_names = tuple(str(n) for n in axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of rank {devices.ndim} with axes "
                             f"{self.axis_names}")
        self.dcn_axes = tuple(str(n) for n in dcn_axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_ids(self) -> Tuple[int, ...]:
        return tuple(int(d.id) for d in self.devices.flat)

    def __repr__(self) -> str:
        axes = ",".join(f"{n}:{s}" for n, s in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.devices.flat]})"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh request: axis names + sizes; -1 = absorb remaining
    devices (at most one -1)."""

    axes: Tuple[Tuple[str, int], ...] = (("data", -1),)

    @classmethod
    def parse(cls, s: str) -> "MeshSpec":
        """Parse ``"data:-1"`` / ``"data:4,model:2"``."""
        axes = []
        for part in s.split(","):
            name, _, n = part.strip().partition(":")
            axes.append((name, int(n) if n else -1))
        return cls(tuple(axes))

    def resolve(self, n_devices: int) -> Tuple[Tuple[str, int], ...]:
        sizes = [n for _, n in self.axes]
        wild = [i for i, n in enumerate(sizes) if n == -1]
        if len(wild) > 1:
            raise ValueError(f"more than one -1 axis in {self.axes}")
        fixed = math.prod(n for n in sizes if n != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {self.axes} wants {fixed} devices, have {n_devices}")
        return tuple((name, n) for (name, _), n in zip(self.axes, sizes))


def parse_device_indices(s: str, n_devices: int) -> Tuple[int, ...]:
    """Parse a device-subset spec — ``"0-3"``, ``"4,5,6,7"``, ``"0-1,6"``
    — into a tuple of device indices (deduplicated, order-preserving).
    An index past the inventory raises: a stage never lands on a device
    it did not name."""
    out: list = []
    seen = set()
    for part in str(s).split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo_s, _, hi_s = part.partition("-")
            lo, hi = int(lo_s), int(hi_s)
            if hi < lo:
                raise ValueError(f"bad device range {part!r}")
            rng = range(lo, hi + 1)
        else:
            rng = (int(part),)
        for i in rng:
            if i < 0 or i >= n_devices:
                raise ValueError(
                    f"device index {i} out of range (have {n_devices})")
            if i not in seen:
                seen.add(i)
                out.append(i)
    if not out:
        raise ValueError(f"empty device subset {s!r}")
    return tuple(out)


def mesh_topology(mesh: Mesh) -> dict:
    """Describe a :class:`Mesh` for the observability layer
    (obs/meshstat.py): axis (name, size) pairs plus the device list in
    mesh order — the ``mesh`` table's topology fields."""
    return {
        "axes": [(str(name), int(size))
                 for name, size in zip(mesh.axis_names,
                                       mesh.devices.shape)],
        "devices": [str(d) for d in mesh.devices.flat],
    }


def make_mesh(spec: "MeshSpec | str | Sequence[Tuple[str, int]]" = "data:-1",
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """Build a :class:`Mesh` over ``devices`` (default: the whole
    inventory, in id order); the innermost axis varies fastest."""
    if isinstance(spec, str):
        spec = MeshSpec.parse(spec)
    elif not isinstance(spec, MeshSpec):
        spec = MeshSpec(tuple(spec))
    if devices is None:
        devices = globals()["devices"]()
    devs = list(devices)
    axes = spec.resolve(len(devs))
    shape = tuple(n for _, n in axes)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(name for name, _ in axes))
