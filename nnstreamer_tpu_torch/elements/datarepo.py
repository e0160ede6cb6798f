"""``datareposrc`` / ``datareposink`` — MLOps dataset reader/writer.

Counterpart of the JAX package's ``elements/datarepo.py``.  Parity
targets: the reference's gst/datarepo/gstdatareposrc.c (props
``location``, ``json``, ``start-sample-index``, ``stop-sample-index``,
``epochs``, ``is-shuffle``, ``tensors-sequence``, ``caps`` — :81-141) and
gstdatareposink.c (``location``, ``json``; writes the JSON descriptor on
EOS).  The JSON descriptor keeps the reference's field names so datasets
interoperate: ``gst_caps`` (caps string), ``total_samples``,
``sample_size`` (static streams), and for flexible streams
``sample_offset`` / ``tensor_size`` / ``tensor_count`` arrays
(gstdatareposrc.c:1437-1506).

Storage layout:
- static tensors: samples are fixed-size records — every tensor's raw
  payload concatenated in declaration order, ``sample_size`` bytes each.
- flexible tensors: each tensor is stored in its self-describing
  MetaInfo-headed wire form; ``sample_offset[i]`` is the file offset of
  sample i, ``tensor_count[i]`` its tensor count, and ``tensor_size``
  the flat list of per-tensor byte sizes (headers included).
- image mode: ``location`` contains a printf-style index pattern
  (e.g. ``img_%04d.png``) — one file per sample, read/written as one
  uint8 octet tensor per buffer (flexible caps).

The port reads and writes the JAX package's files byte for byte: a
dataset one package writes, the other reads.  Samples are read on the
host (sequential I/O off the hot path); a device tensor is written
through one device→host copy of its bytes.
"""

from __future__ import annotations

import json as _json
import os
from typing import List, Optional

import numpy as np

from ..core import Buffer, Tensor, TensorFormat, TensorSpec, TensorsSpec
from ..runtime.element import NegotiationError, SinkElement, SourceElement
from ..runtime.registry import register_element


def _is_pattern(location: str) -> bool:
    return "%" in (location or "")


@register_element("datareposink")
class DataRepoSink(SinkElement):
    FACTORY = "datareposink"

    def __init__(self, name=None, location: str = "", json: str = "",
                 **props):
        self.location = location
        self.json = json
        super().__init__(name, **props)
        self._file = None
        self._count = 0
        self._offsets: List[int] = []
        self._tensor_sizes: List[int] = []
        self._tensor_counts: List[int] = []
        self._sample_size: Optional[int] = None
        self._flexible = False
        self._finalized = False
        self._touched = False  # any output file opened (even if the
        #                        write then failed): data may be clobbered

    def start(self) -> None:
        if not self.location or not self.json:
            raise NegotiationError(
                f"{self.name}: datareposink needs location= and json=")

    def render(self, buf: Buffer) -> None:
        if _is_pattern(self.location):
            path = self.location % self._count
            with open(path, "wb") as f:
                # opened (truncated) — existing data may be clobbered
                # even if a write below fails
                self._touched = True
                for t in buf.tensors:
                    f.write(t.tobytes())
            self._count += 1
            return
        if self._file is None:
            self._file = open(self.location, "wb")
        self._touched = True
        self._flexible = self._flexible or \
            buf.format != TensorFormat.STATIC
        if self._flexible:
            self._offsets.append(self._file.tell())
            self._tensor_counts.append(buf.num_tensors)
            for p in buf.pack_flexible():
                self._tensor_sizes.append(len(p))
                self._file.write(p)
        else:
            start = self._file.tell()
            for t in buf.tensors:
                self._file.write(t.tobytes())
            size = self._file.tell() - start
            if self._sample_size is None:
                self._sample_size = size
            elif self._sample_size != size:
                raise ValueError(
                    f"{self.name}: static stream produced varying sample "
                    f"sizes ({self._sample_size} then {size})")
        self._count += 1

    def _write_json(self) -> None:
        desc = {
            "gst_caps": str(self.sinkpad.caps) if self.sinkpad.caps else "",
            "total_samples": self._count,
        }
        if _is_pattern(self.location):
            desc["location_pattern"] = self.location
        elif self._flexible:
            desc["sample_offset"] = self._offsets
            desc["tensor_size"] = self._tensor_sizes
            desc["tensor_count"] = self._tensor_counts
        else:
            desc["sample_size"] = self._sample_size or 0
        with open(self.json, "w") as f:
            _json.dump(desc, f, indent=2)

    def on_eos(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        self._write_json()
        self._finalized = True

    def stop(self) -> None:
        # No EOS seen (early teardown): still finalize the descriptor, in
        # every mode — image-pattern mode never opens self._file, but its
        # dataset is unreadable without the JSON (reference writes it on
        # EOS, gstdatareposink.c).  Zero-sample exception: a pipeline
        # that errored before the first render() must not clobber a
        # PRE-EXISTING descriptor with an empty one — UNLESS render ran
        # at all (it opens/truncates output files — in pattern mode too —
        # before it can fail): then the old descriptor may describe
        # bytes that no longer exist, and rewriting it (total_samples =
        # what was actually completed) keeps the pair consistent.  A
        # fresh location always gets a valid empty descriptor.
        if not self._finalized and self.json and (
                self._touched or not os.path.exists(self.json)):
            self.on_eos()


@register_element("datareposrc")
class DataRepoSrc(SourceElement):
    FACTORY = "datareposrc"

    def __init__(self, name=None, location: str = "", json: str = "",
                 start_sample_index: int = 0,
                 stop_sample_index: Optional[int] = None,
                 epochs: int = 1, is_shuffle: bool = True,
                 tensors_sequence: str = "", caps=None, seed: int = 0,
                 **props):
        self.location = location
        self.json = json
        self.start_sample_index = start_sample_index
        self.stop_sample_index = stop_sample_index
        self.epochs = epochs
        self.is_shuffle = is_shuffle
        self.tensors_sequence = tensors_sequence
        self.caps = caps
        self.seed = seed
        super().__init__(name, **props)
        if isinstance(self.caps, str):
            from ..runtime.parser import parse_caps_string

            self.caps = parse_caps_string(self.caps)
        self._desc = None
        self._spec: Optional[TensorsSpec] = None
        self._file = None
        self._epoch = 0
        self._pos = 0
        self._order: List[int] = []
        self._rng = np.random.default_rng(seed)
        self._count_prefix: Optional[List[int]] = None

    # -- descriptor -----------------------------------------------------------

    def _load_desc(self) -> dict:
        if self._desc is None:
            if self.json:
                with open(self.json) as f:
                    self._desc = _json.load(f)
            else:
                self._desc = {}
        return self._desc

    def _sequence(self) -> Optional[List[int]]:
        s = str(self.tensors_sequence or "").strip()
        if not s:
            return None
        return [int(x) for x in s.split(",") if x.strip() != ""]

    def output_spec(self) -> TensorsSpec:
        if self._spec is not None:
            return self._spec
        desc = self._load_desc()
        spec: Optional[TensorsSpec] = None
        if self.caps is not None:
            spec = self.caps.to_spec()
        elif desc.get("gst_caps"):
            from ..runtime.parser import parse_caps_string

            spec = parse_caps_string(desc["gst_caps"]).to_spec()
        elif "sample_offset" in desc or "location_pattern" in desc:
            # self-describing storage (MetaInfo-headed / per-file): the
            # schema travels per sample, no caps needed
            spec = TensorsSpec(format=TensorFormat.FLEXIBLE)
        else:
            raise NegotiationError(
                f"{self.name}: need json= descriptor or caps= to know the "
                "sample format")
        seq = self._sequence()
        if seq is not None and spec.is_static():
            spec = TensorsSpec(
                tensors=tuple(spec.tensors[i] for i in seq),
                format=spec.format, rate=spec.rate)
        self._spec = spec
        return spec

    # -- sample window --------------------------------------------------------

    def _window(self) -> List[int]:
        desc = self._load_desc()
        total = int(desc.get("total_samples", 0))
        if not total and not self.json:
            # raw mode without JSON: derive from file size / sample size
            total = os.path.getsize(self.location) // self._static_size()
        start = int(self.start_sample_index)
        # None = read to the end; an explicit 0 selects exactly sample 0
        stop = total - 1 if self.stop_sample_index is None \
            else int(self.stop_sample_index)
        if not (0 <= start <= stop < total):
            raise NegotiationError(
                f"{self.name}: sample window [{start},{stop}] outside "
                f"dataset of {total} samples")
        return list(range(start, stop + 1))

    def _static_size(self) -> int:
        desc = self._load_desc()
        if "sample_size" in desc:
            return int(desc["sample_size"])
        spec = self.output_spec()
        if not spec.is_static():
            raise NegotiationError(f"{self.name}: unknown sample size")
        # sequence-selected specs still read the FULL stored sample
        full = self.caps.to_spec() if self.caps is not None else spec
        return sum(t.nbytes for t in full.tensors)

    def _next_index(self) -> Optional[int]:
        if not self._order:
            self._order = self._window()
            if self.is_shuffle:
                self._rng.shuffle(self._order)
        if self._pos >= len(self._order):
            self._epoch += 1
            if 0 <= int(self.epochs) <= self._epoch:
                return None
            self._pos = 0
            if self.is_shuffle:
                self._rng.shuffle(self._order)
        i = self._order[self._pos]
        self._pos += 1
        return i

    # -- reading --------------------------------------------------------------

    def _read_static(self, index: int) -> Buffer:
        if self._file is None:
            self._file = open(self.location, "rb")
        size = self._static_size()
        self._file.seek(index * size)
        data = self._file.read(size)
        if len(data) != size:
            raise IOError(
                f"{self.name}: short read at sample {index}")
        desc_spec = self.caps.to_spec() if self.caps is not None else None
        if desc_spec is None:
            from ..runtime.parser import parse_caps_string

            desc_spec = parse_caps_string(
                self._load_desc()["gst_caps"]).to_spec()
        tensors, off = [], 0
        for t in desc_spec.tensors:
            tensors.append(Tensor(data[off:off + t.nbytes], t))
            off += t.nbytes
        seq = self._sequence()
        if seq is not None:
            tensors = [tensors[i] for i in seq]
        return Buffer(tensors=tensors, offset=index)

    def _read_flexible(self, index: int) -> Buffer:
        desc = self._load_desc()
        if self._file is None:
            self._file = open(self.location, "rb")
        if self._count_prefix is None:
            # prefix sums: O(1) first-tensor lookup per read instead of
            # O(index) summing per sample
            acc, pref = 0, [0]
            for c in desc["tensor_count"]:
                acc += c
                pref.append(acc)
            self._count_prefix = pref
        counts = desc["tensor_count"]
        sizes = desc["tensor_size"]
        first_tensor = self._count_prefix[index]
        self._file.seek(desc["sample_offset"][index])
        payloads = []
        for k in range(counts[index]):
            payloads.append(self._file.read(sizes[first_tensor + k]))
        buf = Buffer.unpack_flexible(payloads)
        buf.offset = index
        return buf

    def _read_image(self, index: int) -> Buffer:
        path = (self._load_desc().get("location_pattern")
                or self.location) % index
        with open(path, "rb") as f:
            data = f.read()
        t = Tensor(data, TensorSpec.from_shape((len(data),), np.uint8))
        return Buffer(tensors=[t], offset=index,
                      format=TensorFormat.FLEXIBLE)

    def create(self) -> Optional[Buffer]:
        index = self._next_index()
        if index is None:
            return None
        if _is_pattern(self.location) or \
                "location_pattern" in self._load_desc():
            buf = self._read_image(index)
        elif self.output_spec().is_static():
            buf = self._read_static(index)
        else:
            buf = self._read_flexible(index)
        buf.meta["epoch"] = self._epoch
        return buf

    def stop(self) -> None:
        super().stop()
        if self._file is not None:
            self._file.close()
            self._file = None

    @property
    def current_epoch(self) -> int:
        return self._epoch
