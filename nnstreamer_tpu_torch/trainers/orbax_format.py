"""The orbax step directories the JAX package's ``load_orbax`` reads,
read without orbax.

``nnstreamer_tpu/trainers/checkpoint.py`` saves a pytree with
``orbax.checkpoint.StandardCheckpointer`` and restores one with its
``restore``, which reads whatever tensorstore opens: steps written by any
orbax client, not only by ``save_orbax``.  A step directory holds:

- ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path (a
  tuple's string) to its ``key_metadata`` (each key with ``key_type`` 2
  for a dict key, 1 for a sequence index) and ``value_metadata``
  (``value_type`` ``np.ndarray``, ``jax.Array`` or ``scalar`` for an
  array, ``None``/``Dict``/``List`` for an empty node); ``use_ocdbt`` and
  ``use_zarr3`` say how the arrays are stored;
- with ``use_ocdbt``: an OCDBT store (``trainers/ocdbt.py``: single or
  numbered manifests) holding each leaf, named by its keys joined with
  ``.``, as a zarr array; without it, the same keys as files under the
  directory.

Zarr v2 (``use_zarr3: false``, :func:`read_zarr`): ``<name>/.zarray`` and
one chunk a key (``<name>/0.1``, separator ``.`` or ``/``; ``0`` for a
0-d array).  Read: dtypes ``f2``/``f4``/``f8``, ``c8``/``c16``, signed
and unsigned integers of 1 to 8 bytes, ``|b1`` in either byte order
(big-endian arrays come back native-endian, as orbax's restore gives
them) and ``bfloat16``; the shape and chunk grid (edge chunks stored at
the full chunk shape and cut); ``fill_value`` (a missing chunk holds it;
null reads as zeros; where ``_METADATA`` says every chunk was stored,
``store_array_data_equal_to_fill_value``, a missing chunk raises as
orbax's restore does); order ``C`` and ``F``; chunks raw or compressed
with zstd (``native/nns_zstd.cc``), blosc (``native/nns_blosc.cc``),
zlib, gzip or bz2 (the standard library).

Zarr v3 (``use_zarr3: true``, :func:`read_zarr3`): ``<name>/zarr.json``
(``zarr_format`` 3, ``node_type`` array, the dtypes above by their v3
names, ``fill_value`` a number, ``NaN``, ``Infinity``, ``-Infinity`` or
the hex string of its bits, ``[real, imag]`` for complex), the
``regular`` chunk grid, the ``default`` (``<name>/c/0/1``, ``<name>/c``
for 0-d; separator ``/`` or ``.``) and ``v2`` chunk key encodings, and the
codec chain: ``transpose``; then ``bytes`` (either endian) or
``sharding_indexed`` (inner chunks with their own chain, an index of
(offset, length) pairs in ``bytes`` with an optional ``crc32c``, at the
start or the end; an inner chunk of offset and length 2^64-1 holds the
fill value, or is damage where every chunk was stored); then ``zstd``,
``gzip``, ``blosc`` and ``crc32c`` (checked).  Orbax's own ``use_zarr3``
step is one ``sharding_indexed`` chunk a leaf: inner ``bytes`` +
``zstd``, index ``bytes`` + ``crc32c`` at the end.

Refused, each raising :class:`OrbaxFormatError` naming its field: zarr
v2 ``filters`` (tensorstore refuses to write them, so orbax's restore
never meets them) and a compressor other than those above; dtypes outside
the set above (strings, objects, structured types, ``f16``: no orbax
leaf is one); any other zarr v3 codec, index codec, chunk grid or chunk
key encoding, and non-empty ``storage_transformers`` (tensorstore writes
none of them into an orbax step); malformed metadata.

:func:`load_orbax` gives the tree ``load_orbax`` of the JAX package gives:
nested dicts and lists of numpy arrays (0-d arrays stay 0-d), scalars as
Python numbers, except that a bf16 leaf is a ``torch.bfloat16`` tensor as
in ``models/params_io.py`` (numpy has no bf16 of its own).  With a
template, each leaf takes the template's dtype (a Python number in the
template makes the leaf a number of its type, as orbax's restore does);
where the template's structure differs from the step's, it raises as
orbax raises, and a leaf's stored shape wins over the template's, as
orbax's does.
"""

from __future__ import annotations

import bz2
import itertools
import json
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.params_io import _bf16_tensor
from ..nativelib import blosc_decompress, crc32c, zstd_decompress
from .ocdbt import Ocdbt

METADATA = "_METADATA"
KEY_SEQUENCE, KEY_DICT = 1, 2
ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
EMPTY_TYPES = {"None": lambda: None, "Dict": dict, "List": list}


class OrbaxFormatError(ValueError):
    """The step is not an orbax step in a form this reader reads."""


def is_orbax_dir(path: str) -> bool:
    """A directory holding an orbax step's ``_METADATA``."""
    return os.path.isfile(os.path.join(path, METADATA))


class _Files:
    """The per-file zarr layout of ``use_ocdbt: false``: keys are paths
    under the step directory."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def read(self, key: str) -> Optional[bytes]:
        path = os.path.normpath(os.path.join(self.root, key))
        if os.path.commonpath([path, self.root]) != self.root:
            raise OrbaxFormatError(f"key {key!r} lies outside {self.root}")
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None


# -- the dtypes and fill values of both zarr versions --------------------------

#: zarr v3 ``data_type`` names and the zarr v2 dtype each is
V3_TYPES = {"bool": "|b1", "int8": "|i1", "uint8": "|u1", "int16": "<i2",
            "uint16": "<u2", "int32": "<i4", "uint32": "<u4", "int64": "<i8",
            "uint64": "<u8", "float16": "<f2", "float32": "<f4",
            "float64": "<f8", "complex64": "<c8", "complex128": "<c16",
            "bfloat16": "bfloat16"}
_ALL_ONES = (1 << 64) - 1                 # a sharding index's "no chunk"


def _dtype(desc: Any, name: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype the chunks hold, is bf16) of a ``.zarray`` dtype."""
    if desc == "bfloat16":
        return np.dtype("<u2"), True
    try:
        dt = np.dtype(desc)
    except TypeError:
        raise OrbaxFormatError(f"{name}: dtype {desc!r} is not read") \
            from None
    if dt.kind not in "fiubc" or dt.itemsize > 16 or dt.fields \
            or dt.kind == "f" and dt.itemsize not in (2, 4, 8) \
            or dt.kind == "c" and dt.itemsize not in (8, 16) \
            or dt.kind in "iub" and dt.itemsize > 8:
        raise OrbaxFormatError(f"{name}: dtype {desc!r} is not read")
    return dt, False


def _number(value: Any, dt: np.dtype, name: str):
    """One fill value of a real dtype: a number, a special float's name,
    or (zarr v3) the hex string of its bits."""
    if isinstance(value, str):
        if value.startswith("0x"):
            try:
                bits = int(value, 16)
                return np.array(bits, f"<u{dt.itemsize}").view(
                    dt.newbyteorder("<"))
            except (ValueError, OverflowError):
                raise OrbaxFormatError(f"{name}: fill_value {value!r} is "
                                       "not read") from None
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special:
            raise OrbaxFormatError(f"{name}: fill_value {value!r} is not "
                                   "read")
        return special[value]
    if not isinstance(value, (bool, int, float)):
        raise OrbaxFormatError(f"{name}: fill_value {value!r} is not read")
    return value


def _fill(value: Any, dt: np.dtype, bf16: bool, name: str) -> np.ndarray:
    """The 0-d array (native byte order) a missing chunk is filled with."""
    dt = dt.newbyteorder("=")
    if value is None:
        return np.zeros((), dt)
    if dt.kind == "c":
        if not (isinstance(value, (list, tuple)) and len(value) == 2):
            raise OrbaxFormatError(f"{name}: fill_value {value!r} of a "
                                   "complex dtype is not [real, imag]")
        part = np.dtype(f"f{dt.itemsize // 2}")
        re, im = (np.asarray(_number(v, part, name), part) for v in value)
        return np.array(complex(re.item(), im.item()), dt)
    if bf16:
        v = _number(value, dt, name)
        if isinstance(v, np.ndarray):               # hex: the bits
            return v.astype(np.uint16)
        t = torch.tensor(float(v), dtype=torch.float32)
        return np.asarray(t.to(torch.bfloat16).view(torch.int16).numpy()
                          .view(np.uint16))
    v = _number(value, dt, name)
    try:
        return np.asarray(v).astype(dt) if isinstance(v, np.ndarray) \
            else np.array(v, dt)
    except (OverflowError, ValueError):
        raise OrbaxFormatError(f"{name}: fill_value {value!r} does not fit "
                               f"{dt}") from None


def _assemble(store, name: str, shape: tuple, chunks: tuple, dt: np.dtype,
              fill: np.ndarray, key, decode, fill_missing: bool
              ) -> np.ndarray:
    """The array from its chunk grid: ``key(idx)`` names chunk ``idx``,
    ``decode(data, key, valid)`` gives its array of the chunk shape
    (``valid``: the extent inside the array); edge chunks are cut, a
    missing chunk holds ``fill`` or raises where ``fill_missing`` is
    false."""
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} for shape {shape}")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = None
    for idx in itertools.product(*map(range, grid)):
        k = key(idx)
        data = store.read(k)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        if data is None:
            if not fill_missing:
                raise OrbaxFormatError(f"chunk {k!r} is missing")
            block = None
        else:
            block = decode(data, k, tuple(b - a for a, b in zip(lo, hi)))
        if block is not None and chunks == shape:
            out = block if block.flags.c_contiguous else block.copy()
            break
        if out is None:
            out = np.empty(shape, dt)
        region = tuple(slice(a, b) for a, b in zip(lo, hi))
        if block is None:
            out[region] = fill
        else:
            out[region] = block[tuple(slice(0, b - a) for a, b in
                                      zip(lo, hi))]
    if out is None:                          # a shape with a 0 dimension
        out = np.empty(shape, dt)
    return out


def _stdlib(codec: str, data: bytes, size: int, key: str) -> bytes:
    """``data`` inflated by the standard library's ``codec`` (zlib, gzip
    or bz2), at most ``size`` bytes."""
    try:
        if codec == "bz2":
            d = bz2.BZ2Decompressor()
        else:
            d = zlib.decompressobj(31 if codec == "gzip" else 15)
        out = d.decompress(bytes(data), size + 1)
        done = d.eof and not d.unused_data
    except (zlib.error, OSError, ValueError, EOFError) as e:
        raise OrbaxFormatError(f"{key}: {codec}: {e}") from None
    if len(out) > size or not done:
        raise OrbaxFormatError(f"{key}: {codec}: the stream does not end "
                               f"within {size} bytes")
    return out


def _inflate(codec: str, data, size: Optional[int], cap: int, key: str):
    """The bytes a compressed chunk holds (a uint8 array from the native
    decoders, else ``bytes``); ``size`` the exact decoded size where
    known, else at most ``cap``."""
    try:
        if codec == "zstd":
            return zstd_decompress(data, size, limit=cap)
        if codec == "blosc":
            return blosc_decompress(data, size)
    except ValueError as e:
        raise OrbaxFormatError(f"{key}: {e}") from None
    out = _stdlib(codec, data, size if size is not None else cap, key)
    if size is not None and len(out) != size:
        raise OrbaxFormatError(f"{key}: {codec}: {len(out)} bytes, expected "
                               f"{size}")
    return out


def _as_array(data, dt: np.dtype) -> np.ndarray:
    """A writable 1-D array of ``dt`` over a chunk's bytes: a decoder's
    own array as it is, anything else copied once."""
    if isinstance(data, np.ndarray) and data.flags.writeable:
        return data.view(dt)
    return np.frombuffer(bytearray(data), dt)


# -- zarr v2 -------------------------------------------------------------------

V2_COMPRESSORS = ("zstd", "blosc", "zlib", "gzip", "bz2")


def read_zarr(store, name: str, fill_missing: bool = True
              ) -> Tuple[np.ndarray, bool]:
    """(the zarr v2 array ``name`` of ``store``, is bf16): ``store.read``
    gives a key's bytes or None.  A bf16 array comes back as its uint16
    words, every array in native byte order.  A missing chunk holds the
    fill value, or raises where ``fill_missing`` is false."""
    raw = store.read(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"{name}: no .zarray")
    try:
        meta = json.loads(bytes(raw).decode("utf-8"))
        shape = tuple(int(s) for s in meta["shape"])
        chunks = tuple(int(s) for s in meta["chunks"])
    except (ValueError, KeyError, TypeError):
        raise OrbaxFormatError(f"{name}: malformed .zarray") from None
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr_format "
                               f"{meta.get('zarr_format')!r} is not read")
    comp = meta.get("compressor")
    codec = comp.get("id") if isinstance(comp, dict) else comp
    if comp is not None and (not isinstance(comp, dict)
                             or codec not in V2_COMPRESSORS):
        raise OrbaxFormatError(f"{name}: compressor {codec!r} is not read "
                               f"({', '.join(V2_COMPRESSORS)} or none)")
    if meta.get("filters"):
        # tensorstore writes no filters, so orbax's restore never meets them
        raise OrbaxFormatError(f"{name}: filters {meta['filters']!r} are "
                               "not read")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise OrbaxFormatError(f"{name}: order {order!r} is not read")
    dt, bf16 = _dtype(meta.get("dtype"), name)
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OrbaxFormatError(f"{name}: dimension_separator {sep!r} is "
                               "not read")
    fill = _fill(meta.get("fill_value"), dt, bf16, name)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    native = dt.newbyteorder("=")

    def decode(data, key, valid):
        if codec is not None:
            data = _inflate(codec, data, chunk_bytes, chunk_bytes, key)
        elif len(data) != chunk_bytes:
            raise OrbaxFormatError(f"{key}: {len(data)} bytes, expected "
                                   f"{chunk_bytes}")
        block = _as_array(data, dt)
        block = block.reshape(chunks[::-1]).T if order == "F" else \
            block.reshape(chunks)
        return block if dt == native else block.astype(native)

    out = _assemble(store, name, shape, chunks, native, fill,
                    lambda idx: f"{name}/{sep.join(map(str, idx)) or '0'}",
                    decode, fill_missing)
    return out, bf16


# -- zarr v3 -------------------------------------------------------------------

ARRAY_TO_ARRAY = ("transpose",)
ARRAY_TO_BYTES = ("bytes", "sharding_indexed")
BYTES_TO_BYTES = ("zstd", "gzip", "blosc", "crc32c")


def _config(spec: Any, name: str, where: str) -> Tuple[str, dict]:
    """(name, configuration) of one codec or grid entry."""
    if not isinstance(spec, dict) or not isinstance(spec.get("name"), str):
        raise OrbaxFormatError(f"{name}: {where}: malformed entry {spec!r}")
    conf = spec.get("configuration", {})
    if not isinstance(conf, dict):
        raise OrbaxFormatError(f"{name}: {where}: malformed configuration")
    return spec["name"], conf


def _ints(value: Any, name: str, what: str) -> tuple:
    if not isinstance(value, list) or not all(
            isinstance(v, int) and not isinstance(v, bool) for v in value):
        raise OrbaxFormatError(f"{name}: {what} {value!r} is not a list of "
                               "integers")
    return tuple(value)


class _Chain:
    """A zarr v3 codec chain over chunks of ``shape`` (the decoded form):
    :meth:`decode` gives a chunk's array (native byte order) from its
    bytes."""

    def __init__(self, codecs: Any, shape: tuple, dt: np.dtype,
                 fill: np.ndarray, fill_missing: bool, name: str,
                 where: str = "codecs"):
        if not isinstance(codecs, list) or not codecs:
            raise OrbaxFormatError(f"{name}: {where}: {codecs!r} is not a "
                                   "list of codecs")
        self.name, self.dt, self.fill = name, dt, fill
        self.fill_missing = fill_missing
        self.perms: List[tuple] = []                 # transposes, in order
        enc = shape
        specs = [_config(c, name, where) for c in codecs]
        i = 0
        while i < len(specs) and specs[i][0] in ARRAY_TO_ARRAY:
            perm = self._order(specs[i][1].get("order"), len(enc), where)
            self.perms.append(perm)
            enc = tuple(enc[p] for p in perm)
            i += 1
        if i == len(specs) or specs[i][0] not in ARRAY_TO_BYTES:
            what = specs[i][0] if i < len(specs) else None
            raise OrbaxFormatError(
                f"{name}: {where}: codec {what!r} is not read (the array "
                f"to bytes codec must be one of {', '.join(ARRAY_TO_BYTES)}"
                f", after {', '.join(ARRAY_TO_ARRAY)})")
        self.enc = enc
        self.kind, conf = specs[i]
        self.size: Optional[int] = None        # the bytes codec's output
        if self.kind == "bytes":
            self.order = self._endian(conf, dt, where)
            self.size = int(np.prod(enc, dtype=np.int64)) * dt.itemsize
        else:
            self._sharding(conf, where)
        self.bytes_codecs = []
        for codec, c in specs[i + 1:]:
            if codec not in BYTES_TO_BYTES:
                raise OrbaxFormatError(
                    f"{name}: {where}: codec {codec!r} is not read (bytes "
                    f"to bytes: {', '.join(BYTES_TO_BYTES)})")
            self.bytes_codecs.append(codec)
        raw = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        self.cap = 2 * raw + (1 << 16)         # a bound for unsized streams

    def _order(self, order: Any, rank: int, where: str) -> tuple:
        if order == "C":
            return tuple(range(rank))
        if order == "F":
            return tuple(reversed(range(rank)))
        perm = _ints(order, self.name, f"{where}: transpose order")
        if sorted(perm) != list(range(rank)):
            raise OrbaxFormatError(f"{self.name}: {where}: transpose order "
                                   f"{list(perm)} for rank {rank}")
        return perm

    def _endian(self, conf: dict, dt: np.dtype, where: str) -> str:
        endian = conf.get("endian", "little" if dt.itemsize == 1 else None)
        if endian not in ("little", "big"):
            raise OrbaxFormatError(f"{self.name}: {where}: bytes endian "
                                   f"{endian!r} is not read")
        return "<" if endian == "little" else ">"

    def _sharding(self, conf: dict, where: str) -> None:
        inner = _ints(conf.get("chunk_shape"), self.name,
                      f"{where}: sharding_indexed chunk_shape")
        if len(inner) != len(self.enc) or any(
                c < 1 or s % c for s, c in zip(self.enc, inner)):
            raise OrbaxFormatError(
                f"{self.name}: {where}: sharding_indexed chunk_shape "
                f"{list(inner)} does not divide the shard {list(self.enc)}")
        self.inner = inner
        self.grid = tuple(s // c for s, c in zip(self.enc, inner))
        self.inner_chain = _Chain(conf.get("codecs"), inner, self.dt,
                                  self.fill, self.fill_missing, self.name,
                                  f"{where}: sharding_indexed codecs")
        index = [_config(c, self.name, f"{where}: index_codecs")
                 for c in conf.get("index_codecs") or []]
        if not index or index[0][0] != "bytes" or \
                [n for n, _ in index[1:]] not in ([], ["crc32c"]):
            raise OrbaxFormatError(
                f"{self.name}: {where}: index_codecs "
                f"{[n for n, _ in index]} are not read (bytes, then "
                "crc32c or nothing)")
        self.index_order = self._endian(index[0][1], np.dtype("<u8"), where)
        self.index_crc = len(index) == 2
        loc = conf.get("index_location", "end")
        if loc not in ("start", "end"):
            raise OrbaxFormatError(f"{self.name}: {where}: index_location "
                                   f"{loc!r} is not read")
        self.index_at_start = loc == "start"
        n = int(np.prod(self.grid, dtype=np.int64))
        self.index_bytes = 16 * n + 4 * self.index_crc

    def decode(self, data: bytes, key: str, valid: tuple) -> np.ndarray:
        """The chunk ``key``'s array from its bytes; ``valid`` is its
        extent inside the array (inner chunks beyond it are not read)."""
        sizes = [self.size]
        for codec in self.bytes_codecs[:-1]:
            sizes.append(sizes[-1] + 4 if codec == "crc32c" and
                         sizes[-1] is not None else None)
        for codec, size in zip(reversed(self.bytes_codecs), reversed(sizes)):
            if codec == "crc32c":
                data = _crc_checked(data, key)
            else:
                data = _inflate(codec, data, size, self.cap, key)
        for perm in self.perms:
            valid = tuple(valid[p] for p in perm)
        if self.kind == "bytes":
            if len(data) != self.size:
                raise OrbaxFormatError(f"{key}: {len(data)} bytes, expected "
                                       f"{self.size}")
            dt = self.dt.newbyteorder(self.order)
            arr = _as_array(data, dt).reshape(self.enc)
            if dt != self.dt.newbyteorder("="):
                arr = arr.astype(self.dt.newbyteorder("="))
        else:
            arr = self._shard(data, key, valid)
        for perm in reversed(self.perms):
            arr = arr.transpose(np.argsort(perm))
        return arr

    def _shard(self, data, key: str, valid: tuple) -> np.ndarray:
        data = memoryview(data).cast("B")       # inner chunks as views
        if len(data) < self.index_bytes:
            raise OrbaxFormatError(f"{key}: shard of {len(data)} bytes, "
                                   f"its index alone takes "
                                   f"{self.index_bytes}")
        raw = data[:self.index_bytes] if self.index_at_start else \
            data[len(data) - self.index_bytes:]
        if self.index_crc:
            raw = _crc_checked(raw, f"{key} (shard index)")
        index = np.frombuffer(raw, np.dtype("u8").newbyteorder(
            self.index_order)).reshape(self.grid + (2,))
        out = None
        if self.inner != self.enc:
            out = np.empty(self.enc, self.dt.newbyteorder("="))
        for idx in itertools.product(*map(range, self.grid)):
            lo = [i * c for i, c in zip(idx, self.inner)]
            if any(a >= v for a, v in zip(lo, valid)):
                continue                 # wholly outside the array: unread
            off, nb = (int(v) for v in index[idx])
            region = tuple(slice(a, a + c) for a, c in zip(lo, self.inner))
            what = f"{key} inner chunk {list(idx)}"
            if off == _ALL_ONES and nb == _ALL_ONES:
                if not self.fill_missing:
                    raise OrbaxFormatError(f"{what} is missing")
                if out is None:
                    return np.full(self.enc, self.fill)
                out[region] = self.fill
                continue
            if off + nb > len(data):
                raise OrbaxFormatError(f"{what}: [{off}, {off + nb}) runs "
                                       f"past the shard's {len(data)} bytes")
            block = self.inner_chain.decode(
                data[off:off + nb], what,
                tuple(min(c, v - a) for a, c, v in zip(lo, self.inner,
                                                       valid)))
            if out is None:                  # one inner chunk: the shard
                return block
            out[region] = block
        return out


def _crc_checked(data, key: str):
    """``data`` less its trailing CRC-32C, which must match."""
    if len(data) < 4:
        raise OrbaxFormatError(f"{key}: crc32c: {len(data)} bytes")
    body = data[:-4]
    if crc32c(body) != int.from_bytes(bytes(data[-4:]), "little"):
        raise OrbaxFormatError(f"{key}: crc32c mismatch")
    return body


def read_zarr3(store, name: str, fill_missing: bool = True
               ) -> Tuple[np.ndarray, bool]:
    """(the zarr v3 array ``name`` of ``store``, is bf16), as
    :func:`read_zarr` gives a zarr v2 array."""
    raw = store.read(f"{name}/zarr.json")
    if raw is None:
        raise OrbaxFormatError(f"{name}: no zarr.json")
    try:
        meta = json.loads(bytes(raw).decode("utf-8"))
        shape = tuple(int(s) for s in meta["shape"])
    except (ValueError, KeyError, TypeError):
        raise OrbaxFormatError(f"{name}: malformed zarr.json") from None
    if meta.get("zarr_format") != 3:
        raise OrbaxFormatError(f"{name}: zarr_format "
                               f"{meta.get('zarr_format')!r} is not read")
    if meta.get("node_type") != "array":
        raise OrbaxFormatError(f"{name}: node_type "
                               f"{meta.get('node_type')!r} is not read")
    if meta.get("storage_transformers"):
        raise OrbaxFormatError(f"{name}: storage_transformers "
                               f"{meta['storage_transformers']!r} are not "
                               "read")
    dtype = meta.get("data_type")
    if dtype not in V3_TYPES:
        raise OrbaxFormatError(f"{name}: data_type {dtype!r} is not read")
    dt, bf16 = _dtype(V3_TYPES[dtype], name)
    grid, conf = _config(meta.get("chunk_grid"), name, "chunk_grid")
    if grid != "regular":
        raise OrbaxFormatError(f"{name}: chunk_grid {grid!r} is not read "
                               "(regular only)")
    chunks = _ints(conf.get("chunk_shape"), name, "chunk_shape")
    enc, conf = _config(meta.get("chunk_key_encoding",
                                 {"name": "default"}), name,
                        "chunk_key_encoding")
    if enc not in ("default", "v2"):
        raise OrbaxFormatError(f"{name}: chunk_key_encoding {enc!r} is not "
                               "read")
    sep = conf.get("separator", "/" if enc == "default" else ".")
    if sep not in ("/", "."):
        raise OrbaxFormatError(f"{name}: chunk_key_encoding separator "
                               f"{sep!r} is not read")
    fill = _fill(meta.get("fill_value"), dt, bf16, name)
    chain = _Chain(meta.get("codecs"), chunks, dt, fill, fill_missing, name)
    if enc == "default":
        def key(idx):
            return f"{name}/c" + "".join(f"{sep}{i}" for i in idx)
    else:
        def key(idx):
            return f"{name}/{sep.join(map(str, idx)) or '0'}"
    out = _assemble(store, name, shape, chunks, dt.newbyteorder("="), fill,
                    key, chain.decode, fill_missing)
    return out, bf16


# -- the tree ------------------------------------------------------------------


def _leaf(arr: np.ndarray, bf16: bool, value_type: str) -> Any:
    if bf16:
        leaf = _bf16_tensor(arr)
        return leaf.item() if value_type == "scalar" else leaf
    if value_type == "scalar":
        return arr.item()
    return arr


def _nest(entries: List[Tuple[List[Tuple[str, int]], Any]], what: str):
    """Nested dicts and lists from (key path, leaf) pairs."""
    def build(items, depth):
        kinds = {path[depth][1] for path, _ in items}
        if len(kinds) != 1:
            raise OrbaxFormatError(f"{what}: mixed key types under one node")
        groups: Dict[str, list] = {}
        for path, leaf in items:
            groups.setdefault(path[depth][0], []).append((path, leaf))
        node = {}
        for key, group in groups.items():
            if len(group) == 1 and len(group[0][0]) == depth + 1:
                node[key] = group[0][1]
            elif any(len(p) == depth + 1 for p, _ in group):
                raise OrbaxFormatError(f"{what}: {key!r} is a leaf and a node")
            else:
                node[key] = build(group, depth + 1)
        if kinds == {KEY_SEQUENCE}:
            idx = sorted(node, key=int)
            if [int(k) for k in idx] != list(range(len(idx))):
                raise OrbaxFormatError(f"{what}: sequence indices {idx}")
            return [node[k] for k in idx]
        return node

    return build(entries, 0) if entries else {}


def _paths(template: Any, prefix=()) -> Dict[tuple, Any]:
    """Template leaves by key path (the metadata's form)."""
    if isinstance(template, dict):
        if not template:
            return {prefix: template}
        out = {}
        for k, v in template.items():
            out.update(_paths(v, prefix + ((str(k), KEY_DICT),)))
        return out
    if isinstance(template, (list, tuple)):
        if not template:
            return {prefix: template}
        out = {}
        for i, v in enumerate(template):
            out.update(_paths(v, prefix + ((str(i), KEY_SEQUENCE),)))
        return out
    return {prefix: template}


def _cast(leaf: Any, like: Any, where: str) -> Any:
    """``leaf`` in the dtype of the template leaf ``like``."""
    if like is None:
        return None
    if isinstance(like, (dict, list, tuple)):      # an empty node
        return leaf
    if isinstance(like, (bool, int, float)) and \
            not isinstance(like, np.generic):   # a number: its type, as orbax
        return type(like)(leaf.item() if hasattr(leaf, "item") else leaf)
    dt = getattr(like, "dtype", None)
    if dt is None:
        raise OrbaxFormatError(f"template leaf {where} has no dtype: "
                               f"{type(like).__name__}")
    if not isinstance(leaf, (np.ndarray, torch.Tensor)):
        return leaf
    want_bf16 = str(dt) in ("bfloat16", "torch.bfloat16")
    if isinstance(leaf, torch.Tensor):           # a bf16 leaf
        if want_bf16:
            return leaf
        leaf = leaf.float().numpy()
    if want_bf16:
        return torch.from_numpy(np.ascontiguousarray(
            leaf.astype(np.float32))).to(torch.bfloat16)
    if isinstance(dt, torch.dtype):
        dt = torch.empty((), dtype=dt).numpy().dtype
    return leaf.astype(np.dtype(dt), copy=False)


def _read_entries(store, meta: dict, path: str) -> List[tuple]:
    """(key path, leaf) of every entry of ``_METADATA``'s tree, each array
    read as zarr v3 where ``use_zarr3`` says so, else as zarr v2."""
    read = read_zarr3 if meta.get("use_zarr3") else read_zarr
    # orbax stores every chunk where this is set, and its restore then
    # takes a missing one for damage
    fill_missing = not meta.get("store_array_data_equal_to_fill_value")
    entries = []
    for key, entry in meta.get("tree_metadata", {}).items():
        try:
            keys = [(str(k["key"]), int(k["key_type"]))
                    for k in entry["key_metadata"]]
            vt = entry.get("value_metadata", {}).get("value_type")
        except (KeyError, TypeError, ValueError, AttributeError):
            raise OrbaxFormatError(f"{path}: {key}: malformed entry") \
                from None
        if not keys:
            raise OrbaxFormatError(f"{path}: {key}: no key path")
        if vt in EMPTY_TYPES:
            entries.append((keys, EMPTY_TYPES[vt]()))
        elif vt in ARRAY_TYPES:
            arr, bf16 = read(store, ".".join(k for k, _ in keys),
                             fill_missing)
            entries.append((keys, _leaf(arr, bf16, vt)))
        else:
            raise OrbaxFormatError(f"{path}: {key}: value_type {vt!r} is "
                                   "not read")
    return entries


def load_orbax(path: str, template: Optional[Any] = None) -> Any:
    """The tree of the orbax step ``path`` (the JAX package's
    ``load_orbax``): with ``template``, its structure must match the
    step's and each leaf takes its dtype."""
    path = os.path.abspath(path)
    try:
        with open(os.path.join(path, METADATA), encoding="utf-8") as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise OrbaxFormatError(f"{path}: {METADATA} unreadable: {e}") \
            from None
    store = Ocdbt(path) if meta.get("use_ocdbt", True) else _Files(path)
    try:
        entries = _read_entries(store, meta, path)
    finally:
        if isinstance(store, Ocdbt):
            store.close()
    if template is not None:
        want = _paths(template)
        have = {tuple(k) for k, _ in entries}
        only_step = sorted(have - set(want))
        only_template = sorted(set(want) - have)
        if only_step or only_template:
            raise OrbaxFormatError(
                f"{path}: the template's tree structure does not match the "
                f"step's: in the step only {_names(only_step)}, in the "
                f"template only {_names(only_template)}")
        entries = [(k, _cast(v, want[tuple(k)], ".".join(n for n, _ in k)))
                   for k, v in entries]
    return _nest(entries, path)


def _names(paths) -> List[str]:
    return [".".join(k for k, _ in p) for p in paths]
