"""``tensor_src_sensor`` — sensor device → tensor stream.

Counterpart of the JAX package's ``elements/sensorsrc.py`` (parity: the
reference's gsttensor_srciio.c): Linux IIO sources with channel
enable/auto discovery (``scan_elements/*_en``), ``frequency``,
``merge-channels-data``, ``buffer-capacity``, and raw vs processed
(scale/offset applied) values.
The reference's own unit tests drive it against a mock sysfs tree
(tests/nnstreamer_source/unittest_src_iio.cc) — the same contract this
element exposes through ``device-dir``.

Two backends:
- the default file-backed IIO reader (``device_dir=`` points at an IIO
  sysfs-style directory with ``in_<name>_raw`` value files, optional
  ``in_<name>_scale`` / ``in_<name>_offset`` and
  ``scan_elements/in_<name>_en`` enables);
- a registered Python callable (``register_sensor``/``sensor=NAME``)
  returning one sample vector per call — the hook for platform sensor
  frameworks (the Tizen sensor-fw analog, tensor_src_tizensensor.c).

Output: ``merge_channels_data=True`` (reference default) emits ONE
float32 tensor of shape (buffer_capacity, n_channels); ``False`` emits
one (buffer_capacity,) tensor per channel.  ``frequency`` paces
production; pts is synthesized from the sample clock.  The samples are
host data, as a sensor delivers them; the port keeps its own sensor
registry.
"""

from __future__ import annotations

import os
import re
import threading
import time
from fractions import Fraction
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import SECOND, Buffer, Tensor, TensorSpec, TensorsSpec
from ..runtime.element import NegotiationError, SourceElement
from ..runtime.registry import register_element

_sensors: Dict[str, Callable[[], "np.ndarray"]] = {}
_sensors_lock = threading.Lock()


def register_sensor(name: str, fn: Callable[[], "np.ndarray"]) -> str:
    """Register ``fn() -> (n_channels,) array`` as a named sensor."""
    with _sensors_lock:
        _sensors[name] = fn
    return name


def unregister_sensor(name: str) -> None:
    with _sensors_lock:
        _sensors.pop(name, None)


class _IIOChannel:
    __slots__ = ("name", "raw_path", "scale", "offset")

    def __init__(self, name: str, raw_path: str, scale: float,
                 offset: float):
        self.name, self.raw_path = name, raw_path
        self.scale, self.offset = scale, offset

    def read(self, process: bool) -> float:
        with open(self.raw_path) as f:
            v = float(f.read().strip() or 0)
        return (v + self.offset) * self.scale if process else v


def _read_float(path: str, default: float) -> float:
    try:
        with open(path) as f:
            return float(f.read().strip())
    except (OSError, ValueError):
        return default


def _scan_iio_dir(device_dir: str, channels: str) -> List[_IIOChannel]:
    """Discover ``in_<name>_raw`` channels; ``channels`` is ``auto``
    (honor scan_elements enables), ``all``, or a comma list of names."""
    pat = re.compile(r"^in_(.+)_raw$")
    found = []
    for fn in sorted(os.listdir(device_dir)):
        m = pat.match(fn)
        if not m:
            continue
        name = m.group(1)
        en_path = os.path.join(device_dir, "scan_elements",
                               f"in_{name}_en")
        if channels == "auto" and os.path.isfile(en_path):
            if _read_float(en_path, 1) == 0:
                continue
        elif channels not in ("auto", "all"):
            wanted = {c.strip() for c in channels.split(",") if c.strip()}
            if name not in wanted:
                continue
        found.append(_IIOChannel(
            name, os.path.join(device_dir, fn),
            scale=_read_float(os.path.join(device_dir,
                                           f"in_{name}_scale"), 1.0),
            offset=_read_float(os.path.join(device_dir,
                                            f"in_{name}_offset"), 0.0)))
    return found


@register_element("tensor_src_sensor")
class TensorSrcSensor(SourceElement):
    FACTORY = "tensor_src_sensor"

    def __init__(self, name=None, device_dir: str = "", sensor: str = "",
                 channels: str = "auto", frequency: float = 0.0,
                 merge_channels_data: bool = True,
                 buffer_capacity: int = 1, process: bool = True,
                 num_buffers: int = 0, **props):
        self.device_dir = device_dir
        self.sensor = sensor
        self.channels = channels
        self.frequency = frequency
        self.merge_channels_data = merge_channels_data
        self.buffer_capacity = buffer_capacity
        self.process = process
        self.num_buffers = num_buffers
        super().__init__(name, **props)
        self._chans: List[_IIOChannel] = []
        self._fn: Optional[Callable] = None
        self._nch = 0
        self._count = 0
        self._t0: Optional[float] = None

    # -- discovery / negotiation ---------------------------------------------

    def _discover(self) -> None:
        if self.sensor:
            with _sensors_lock:
                self._fn = _sensors.get(str(self.sensor))
            if self._fn is None:
                raise NegotiationError(
                    f"{self.name}: no sensor registered as "
                    f"{self.sensor!r}")
            self._nch = int(np.asarray(self._fn()).reshape(-1).shape[0])
            return
        if not self.device_dir:
            raise NegotiationError(
                f"{self.name}: set device-dir (IIO sysfs directory) or "
                "sensor (registered callable)")
        if not os.path.isdir(self.device_dir):
            raise NegotiationError(
                f"{self.name}: device dir not found: {self.device_dir}")
        # sampling_frequency file is the device default; the property
        # overrides it (parity: srciio frequency prop)
        if not self.frequency:
            self.frequency = _read_float(
                os.path.join(self.device_dir, "sampling_frequency"), 0.0)
        self._chans = _scan_iio_dir(self.device_dir, str(self.channels))
        if not self._chans:
            raise NegotiationError(
                f"{self.name}: no channels found in {self.device_dir} "
                f"(channels={self.channels!r})")
        self._nch = len(self._chans)

    def output_spec(self) -> TensorsSpec:
        self._discover()
        cap = max(int(self.buffer_capacity), 1)
        freq = Fraction(self.frequency).limit_denominator(10 ** 6) \
            if self.frequency else Fraction(0, 1)
        rate = freq / cap if freq else Fraction(0, 1)
        if self.merge_channels_data:
            return TensorsSpec.of(
                TensorSpec.from_shape((cap, self._nch), np.float32),
                rate=rate)
        return TensorsSpec.of(
            *[TensorSpec.from_shape((cap,), np.float32, name=c.name)
              for c in self._chans], rate=rate)

    # -- production ----------------------------------------------------------

    def _sample(self) -> np.ndarray:
        if self._fn is not None:
            return np.asarray(self._fn(), np.float32).reshape(-1)
        return np.array([c.read(bool(self.process)) for c in self._chans],
                        np.float32)

    def create(self) -> Optional[Buffer]:
        n = int(self.num_buffers)
        if n and self._count >= n:
            return None
        cap = max(int(self.buffer_capacity), 1)
        period = 1.0 / float(self.frequency) if self.frequency else 0.0
        if self._t0 is None:
            self._t0 = time.monotonic()
        rows = []
        for i in range(cap):
            if period:
                target = self._t0 + (self._count * cap + i) * period
                delay = target - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            if not self._running.is_set():
                return None
            rows.append(self._sample())
        block = np.stack(rows)  # (cap, nch)
        pts = int(self._count * cap * (period or 0) * SECOND)
        self._count += 1
        if self.merge_channels_data:
            tensors = [Tensor(block, TensorSpec.from_shape(
                block.shape, np.float32))]
        else:
            tensors = [Tensor(np.ascontiguousarray(block[:, j]),
                              TensorSpec.from_shape((cap,), np.float32,
                                                    name=c.name))
                       for j, c in enumerate(self._chans)]
        return Buffer(tensors=tensors, pts=pts)

    def start(self) -> None:
        self._count = 0
        self._t0 = None
        super().start()
