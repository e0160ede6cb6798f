"""Orbax step directories written without orbax: the JAX package's
``save_orbax``/``save_orbax_step`` for the port.

The JAX package saves a tree with ``orbax.checkpoint.StandardCheckpointer``
(orbax 0.11).  This module writes the layout that checkpointer writes, so
the JAX package's ``load_orbax`` (orbax's own restore) and the port's
reader (``trainers/orbax_format.py``) read each leaf bit for bit:

- ``_METADATA``: ``tree_metadata`` keyed by each leaf's key tuple, dict
  keys ``key_type`` 2, sequence indices 1; arrays ``np.ndarray``, Python
  numbers ``scalar`` (a bool as ``|b1``, an int as ``<i8``, a float as
  ``<f8``), empty dicts, lists and ``None`` as ``Dict``/``List``/``None``
  with no array; ``use_ocdbt`` true, ``use_zarr3`` false,
  ``store_array_data_equal_to_fill_value`` true.
- ``_CHECKPOINT_METADATA``: the handler's name and the timestamps.
- ``manifest.ocdbt``: one version whose root is one b-tree leaf node;
  ``d/<name>``: every value that is not inline, then the node
  (``trainers/ocdbt.py`` reads the same framing: magic, length, format
  version 0, zstd, CRC-32C).
- each leaf ``a.b`` (its keys joined with ``.``): ``a.b/.zarray`` (zarr
  v2, compressor zstd, separator ``.``, ``fill_value`` null, order C) and
  its chunks ``a.b/0.0`` … (``0`` for a 0-d array): one chunk a leaf, or
  one chunk a slice of a leaf split over the ``model`` axis
  (``parallel/sharded.py`` :class:`ShardedLeaf`), each slice copied to the
  host on its own, as orbax stores a sharded ``jax.Array``.
- chunks and nodes are zstd frames of raw blocks: valid frames that need
  no compressor; a bf16 leaf (a ``torch.bfloat16`` tensor, or numpy's
  ``ml_dtypes`` bf16) is a ``bfloat16`` zarr array of its 16-bit words.

Zarr v3, other compressors, filters and order F are never written.  A
zero-size array is refused, as orbax refuses it.

:func:`save_orbax` writes the step whole in a hidden directory beside
``path`` and renames it into place (replacing an older directory there),
so a reader of ``root@latest`` never sees a half-written step.

Across processes (``group=``: a tree trained by several
``torch.distributed`` ranks, every rank calling it) the step is the one
orbax writes when every process of a JAX run calls ``save_orbax``: each
rank writes its share into a store of its own, ``ocdbt.process_<rank>/``
(its ``manifest.ocdbt`` and ``d/``), and the root ``manifest.ocdbt`` is
one b-tree leaf node whose entries point into those stores' data files
(base path ``ocdbt.process_<rank>/``), written by the lowest rank once
every rank has written.  The ranks first exchange which leaves and
slices each holds (:func:`held`), and every rank derives the same
:func:`plan`: each chunk is written by one rank.  A slice of a leaf split
over ranks, or a replicated leaf (slice 0 of 1, held by every rank), is
written as orbax writes a shard over its replicas: split along its first
axis the count of ranks holding it divides, part *i* by the *i*-th of
them, or whole by the lowest where no axis divides; every ``.zarray`` by
the lowest rank (orbax's primary host).  A JAX run splits a replicated
array over its devices, the port over its ranks, so the two steps' chunk
grids differ; each reader reads either.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import time
from typing import (Any, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np

from .ocdbt import BTREE_MAGIC, MANIFEST, MANIFEST_MAGIC

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
KEY_SEQUENCE, KEY_DICT = 1, 2
MAX_INLINE = 100                  # values up to this many bytes stay inline
MAX_NODE = 100_000_000            # orbax's max_decoded_node_bytes
RAW_BLOCK = 128 * 1024
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")

#: a value of the store: bytes as they are, or a chunk's raw bytes (uint8)
#: to be framed as it is written
Value = Union[bytes, np.ndarray]


# -- checksums and codecs ------------------------------------------------------


def _crc_table() -> List[int]:
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        out.append(c)
    return out


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli): the native library's where it builds
    (``nativelib.crc32c``), else a table over the bytes (the writer's
    nodes are small)."""
    from ..nativelib import NativeBuildError
    from ..nativelib import crc32c as native_crc32c

    try:
        return native_crc32c(data)
    except NativeBuildError:
        pass
    c = 0xFFFFFFFF
    for b in bytes(data):
        c = (c >> 8) ^ _CRC[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def _frame_head(size: int) -> bytes:
    """A zstd frame header: single segment, 8-byte content size."""
    return struct.pack("<IBQ", 0xFD2FB528, 0xE0, size)


def _raw_blocks(data: memoryview):
    """The raw blocks of a frame holding ``data``: (3-byte header, bytes)."""
    pos = 0
    while True:
        block = data[pos:pos + RAW_BLOCK]
        pos += len(block)
        last = pos >= len(data)
        yield struct.pack("<I", (len(block) << 3) | int(last))[:3], block
        if last:
            return


def frame_size(size: int) -> int:
    """Bytes of the raw-block frame of ``size`` bytes."""
    return 13 + size + 3 * max(1, -(-size // RAW_BLOCK))


def zstd_raw_frame(data: bytes) -> bytes:
    """A zstd frame of raw blocks: single segment, 8-byte content size."""
    view = memoryview(bytes(data))
    out = [_frame_head(len(view))]
    for head, block in _raw_blocks(view):
        out += [head, bytes(block)]
    return b"".join(out)


def varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(varint(v) for v in values)


def _framed(magic: int, body: bytes) -> bytes:
    """An OCDBT file or node: magic, length, version 0, zstd, CRC-32C."""
    payload = varint(0) + varint(1) + zstd_raw_frame(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload)
                                                 + 4)
    blob = head + payload
    return blob + struct.pack("<I", crc32c(blob))


def _file_table(files: Sequence[Tuple[str, int]]) -> bytes:
    """A data-file table of (path from the store's root, base path
    length) pairs."""
    enc = [(p.encode(), base) for p, base in files]
    return (varint(len(enc)) + _varints([0] * max(len(enc) - 1, 0))
            + _varints(len(p) for p, _ in enc) + _varints(b for _, b in enc)
            + b"".join(p for p, _ in enc))


# -- leaves --------------------------------------------------------------------


def leaves(tree: Any, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) pairs in the metadata's ((key, key_type), ...)
    form; an empty dict or list is a leaf of its own, as orbax keeps it."""
    if isinstance(tree, dict):
        if not tree and prefix:
            return [(prefix, tree)]
        out = []
        for k, v in tree.items():
            out += leaves(v, prefix + ((str(k), KEY_DICT),))
        return out
    if isinstance(tree, (list, tuple)):
        if not tree and prefix:
            return [(prefix, tree)]
        out = []
        for i, v in enumerate(tree):
            out += leaves(v, prefix + ((str(i), KEY_SEQUENCE),))
        return out
    return [(prefix, tree)]


def flat_leaves(tree: Any) -> Dict[str, Any]:
    """Every leaf of ``tree`` by its orbax name (keys joined with ``.``)."""
    return {".".join(k for k, _ in keys): leaf
            for keys, leaf in leaves(tree)}


def _empty_type(leaf: Any):
    if leaf is None:
        return "None"
    if isinstance(leaf, dict) and not leaf:
        return "Dict"
    if isinstance(leaf, (list, tuple)) and not leaf:
        return "List"
    return None


def _is_number(leaf: Any) -> bool:
    """A Python number (orbax's ``scalar``); a numpy scalar is an array."""
    return isinstance(leaf, (bool, int, float)) and \
        not isinstance(leaf, np.generic)


def host_array(leaf: Any) -> Tuple[np.ndarray, bool]:
    """(numpy array, is bf16) of an array leaf: a torch tensor copied to
    the host (bf16 as its 16-bit words), a numpy (``ml_dtypes``) bf16
    array the same way, a Python number as orbax stores it."""
    if _is_number(leaf):
        return np.asarray(leaf, np.bool_ if isinstance(leaf, bool) else
                          np.int64 if isinstance(leaf, int) else
                          np.float64), False
    if hasattr(leaf, "detach"):                    # a torch tensor
        import torch

        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), True
    return arr, False


def zarray(shape: Sequence[int], dtype: str,
           chunks: Sequence[int]) -> bytes:
    """A zarr v2 ``.zarray`` as orbax writes it (zstd level 1)."""
    meta = {"chunks": list(chunks),
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": list(shape),
            "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def zarr_dtype(arr: np.ndarray, bf16: bool) -> str:
    return "bfloat16" if bf16 else arr.dtype.str


def chunk_key(name: str, idx: Sequence[int]) -> str:
    return f"{name}/{'.'.join(map(str, idx)) if len(idx) else '0'}"


def chunk_items(name: str, arr: np.ndarray, chunks: Sequence[int]):
    """(key, raw bytes as uint8) of every chunk of ``arr``, edge chunks
    zero-padded to the full chunk shape."""
    grid = [-(-s // c) for s, c in zip(arr.shape, chunks)]
    for idx in np.ndindex(*grid):
        region = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
        part = arr[region]
        if part.shape != tuple(chunks):
            full = np.zeros(chunks, arr.dtype)
            full[tuple(slice(0, s) for s in part.shape)] = part
            part = full
        yield chunk_key(name, idx), _raw(part)


def _raw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _is_split(leaf: Any) -> bool:
    from ..parallel.sharded import ShardedLeaf

    return isinstance(leaf, ShardedLeaf)


def leaf_entry(keys: tuple, value_type: str) -> Dict[str, Any]:
    """The ``tree_metadata`` entry of one leaf."""
    vm: Dict[str, Any] = {"value_type": value_type,
                          "skip_deserialize": value_type in
                          ("Dict", "List", "None")}
    return {"key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": vm}


def tree_values(tree: Any) -> Tuple[Dict[str, Any], Dict[bytes, Value]]:
    """(``tree_metadata``, store values) of ``tree`` written by one
    process (:func:`plan` over one rank): one chunk a leaf, one a slice of
    a split leaf."""
    table = held(tree)
    for name, (_, _, _, dim, count, index) in table:
        if dim >= 0 and len(index) != count:
            raise ValueError(
                f"orbax: {name} holds slices {list(index)} of {count} on "
                f"this rank; a leaf split over ranks is written by every "
                f"rank of its group together: pass the group "
                f"(save_orbax(path, tree, group=...))")
    return tree_meta(tree, table), share(tree, plan({0: table}), 0, True)


def tree_meta(tree: Any, table: List[Tuple[str, tuple]]) -> Dict[str, Any]:
    """The ``tree_metadata`` of ``tree`` from its :func:`held` table."""
    return {str(tuple(k for k, _ in keys)): leaf_entry(keys, row[0])
            for (keys, _), (_, row) in zip(leaves(tree), table)}


# -- the files -----------------------------------------------------------------


class Ref(NamedTuple):
    """A value that lies in a data file of another store under the root:
    the file's path from the root, the length of its base path (the other
    store's directory, ``ocdbt.process_<rank>/``), the value's offset and
    length."""

    path: str
    base: int
    offset: int
    length: int


def write_store(path: str, values: Dict[bytes, Union[Value, Ref]],
                token: bytes = b"") -> Dict[bytes, Union[bytes, Ref]]:
    """The OCDBT store of ``values`` under ``path``: one data file ``d/<name>``
    (each value that is not inline, in key order, then the b-tree leaf
    node) and ``manifest.ocdbt``.  A uint8 array value is framed as it is
    written; a :class:`Ref` stays where it lies, the node pointing into
    its file; ``token`` (32 bytes) names the data file and the manifest's
    uuid, else random.  Returns each key's entry: its inline bytes, or
    the :class:`Ref` of where it lies (in ``d/<name>``, base path 0)."""
    token = token or os.urandom(32)
    os.makedirs(os.path.join(path, "d"), exist_ok=True)
    data_name = "d/" + token[:16].hex()
    keys = sorted(values)
    refs = sorted({(v.path, v.base) for v in values.values()
                   if isinstance(v, Ref)})
    own = not refs or any(
        not isinstance(v, Ref) and (frame_size(v.size) if isinstance(
            v, np.ndarray) else len(v)) > MAX_INLINE for v in values.values())
    table = [(data_name, 0)] * own + refs
    fid = {p: i for i, (p, _) in enumerate(table)}
    kinds, files, where, sizes = [], [], [], []
    entries: Dict[bytes, Union[bytes, Ref]] = {}
    inline = bytearray()
    at = 0
    with open(os.path.join(path, data_name), "wb") as f:
        for k in keys:
            v = values[k]
            if isinstance(v, Ref):
                sizes.append(v.length)
                kinds.append(1)
                files.append(fid[v.path])
                where.append(v.offset)
                entries[k] = v
                continue
            framed = isinstance(v, np.ndarray)
            size = frame_size(v.size) if framed else len(v)
            sizes.append(size)
            if size <= MAX_INLINE:
                kinds.append(0)
                entries[k] = zstd_raw_frame(v.tobytes()) if framed \
                    else bytes(v)
                inline += entries[k]
                continue
            kinds.append(1)
            files.append(fid[data_name])
            where.append(at)
            entries[k] = Ref(data_name, 0, at, size)
            if framed:
                f.write(_frame_head(v.size))
                for head, block in _raw_blocks(memoryview(v)):
                    f.write(head)
                    f.write(block)
            else:
                f.write(v)
            at += size
        prefix = [len(os.path.commonprefix([a, b]))
                  for a, b in zip(keys, keys[1:])]
        suffix = [len(keys[0])] + [len(b) - p
                                   for b, p in zip(keys[1:], prefix)] \
            if keys else []
        body = (b"\x00" + _file_table(table) + varint(len(keys))
                + _varints(prefix) + _varints(suffix)
                + b"".join(k[p:] for k, p in zip(keys, [0] + prefix))
                + _varints(sizes) + _varints(kinds)
                + _varints(files) + _varints(where)
                + bytes(inline))
        node = _framed(BTREE_MAGIC, body)
        f.write(node)
    node_at = at
    now = time.time_ns()
    manifest = (token[16:32] + varint(0) + varint(MAX_INLINE)
                + varint(MAX_NODE) + bytes([4]) + varint(1)
                + struct.pack("<i", 0) + _file_table([(data_name, 0)])
                + varint(1) + varint(1) + bytes([0]) + varint(0)
                + varint(node_at) + varint(len(node)) + varint(len(keys))
                + varint(len(node)) + varint(node_at)
                + struct.pack("<Q", now) + varint(0))
    with open(os.path.join(path, MANIFEST), "wb") as f:
        f.write(_framed(MANIFEST_MAGIC, manifest))
    return entries


def process_store(rank: int) -> str:
    """The directory of rank ``rank``'s store in a step written across
    ranks, as orbax names a process's."""
    return f"ocdbt.process_{int(rank)}"


def merge_stores(path: str, stores: Dict[int, Dict[bytes, Any]]) -> None:
    """The root store of a step written across ranks: ``stores`` holds,
    by rank, the entries :func:`write_store` returned for the rank's store
    under ``path`` (:func:`process_store`).  One b-tree leaf node in the
    root's own ``d/``: inline values copied, every other entry pointing
    into the rank's data file (base path ``ocdbt.process_<rank>/``), as
    orbax's merge of the per-process stores points.  A key two ranks
    wrote keeps the lower rank's entry."""
    values: Dict[bytes, Union[bytes, Ref]] = {}
    for rank in sorted(stores):
        base = process_store(rank) + "/"
        for k, v in stores[rank].items():
            if k not in values:
                values[k] = v if isinstance(v, bytes) else Ref(
                    base + v.path, len(base), v.offset, v.length)
    write_store(path, values)


def write_metadata(path: str, tree_meta: Dict[str, Any]) -> None:
    """``_METADATA`` and ``_CHECKPOINT_METADATA`` of a step."""
    with open(os.path.join(path, METADATA), "w") as f:
        f.write(json.dumps({"tree_metadata": tree_meta, "use_ocdbt": True,
                            "use_zarr3": False,
                            "store_array_data_equal_to_fill_value": True,
                            "custom_metadata": None}))
    now = time.time_ns()
    with open(os.path.join(path, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": now,
                   "commit_timestamp_nsecs": now, "custom_metadata": {}}, f)


# -- a step written across ranks -----------------------------------------------


class OrbaxWriteError(ValueError):
    """A write across ranks failed on one or more of them; every rank
    raises it, naming each failed rank and what it raised."""


class Piece(NamedTuple):
    """One chunk of a leaf written across ranks: the rank that writes it,
    the slice of the leaf it comes from (0 for a leaf held whole), its
    key, and its region of that slice."""

    writer: int
    slice: int
    key: str
    region: Tuple[slice, ...]


class LeafPlan(NamedTuple):
    """How a leaf is written across ranks: its shape, zarr dtype and chunk
    shape, the split dim (-1 held whole) and its :class:`Piece` s."""

    shape: Tuple[int, ...]
    dtype: str
    chunks: Tuple[int, ...]
    dim: int
    pieces: List[Piece]


def _zarr_dtype_of(x: Any) -> str:
    """The zarr dtype of an array leaf, read without copying it."""
    if hasattr(x, "detach"):                       # a torch tensor
        import torch

        return "bfloat16" if x.dtype == torch.bfloat16 else \
            torch.empty(0, dtype=x.dtype).numpy().dtype.str
    if _is_number(x):
        return zarr_dtype(*host_array(x))
    dt = np.asarray(x).dtype
    return "bfloat16" if dt.name == "bfloat16" else dt.str


def held(tree: Any) -> List[Tuple[str, tuple]]:
    """This rank's row of the ownership table, leaf by leaf: (name, (value
    type, shape, zarr dtype, split dim or -1, slices over the group,
    the slice indices held here)); a leaf held whole is slice 0 of 1."""
    out = []
    for keys, leaf in leaves(tree):
        name = ".".join(k for k, _ in keys)
        empty = _empty_type(leaf)
        if empty is not None:
            out.append((name, (empty, (), "", -1, 1, (0,))))
        elif _is_split(leaf):
            out.append((name, ("np.ndarray", tuple(leaf.shape),
                               _zarr_dtype_of(leaf.slices[0]),
                               leaf.split_dim, leaf.count,
                               tuple(leaf.index))))
        else:
            kind = "scalar" if _is_number(leaf) else "np.ndarray"
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") else \
                tuple(np.shape(leaf))
            out.append((name, (kind, shape, _zarr_dtype_of(leaf), -1, 1,
                               (0,))))
    return out


def _leaf_plan(name: str, rows: Dict[int, tuple]) -> Optional[LeafPlan]:
    """One leaf's :class:`LeafPlan` from every rank's row of it (None for
    an empty node).  Each slice (the whole leaf where it is not split) is
    written as orbax writes a shard over its replicas, the ranks that hold
    it: split along its first axis that the count of them divides, rank i
    of them writing part i, or, where no axis divides, whole by the
    lowest; a split leaf's slices are split alike, over as many of their
    holders as every slice has."""
    forms = {rank: row[:5] for rank, row in rows.items()}
    if len(set(forms.values())) != 1:
        raise ValueError(f"orbax: {name} differs between the ranks (value "
                         f"type, shape, dtype, split dim, slices by rank: "
                         f"{forms})")
    kind, shape, dtype, dim, count = next(iter(forms.values()))
    if kind in ("Dict", "List", "None"):
        return None
    if 0 in shape:
        raise ValueError(f"orbax: cannot save arrays with zero size: {name}")
    holders = [sorted(r for r, row in rows.items() if j in row[5])
               for j in range(count)]
    lost = [j for j, h in enumerate(holders) if not h]
    if lost:
        raise ValueError(f"orbax: {name}: slices {lost} of {count} are held "
                         f"by no rank")
    unit = list(shape)
    if dim >= 0:
        unit[dim] //= count
    n = min(len(h) for h in holders)
    axis = next((a for a, s in enumerate(unit) if s % n == 0), None) \
        if n > 1 else None
    if axis is None:
        n = 1
    chunks = list(unit)
    if axis is not None:
        chunks[axis] //= n
    pieces = []
    for j, h in enumerate(holders):
        for i in range(n):
            idx = [0] * len(shape)
            region = [slice(None)] * len(shape)
            if dim >= 0:
                idx[dim] = j * (n if axis == dim else 1)
            if axis is not None:
                idx[axis] += i
                region[axis] = slice(i * chunks[axis], (i + 1) * chunks[axis])
            pieces.append(Piece(h[i], j, chunk_key(name, idx),
                                tuple(region)))
    return LeafPlan(tuple(shape), dtype, tuple(chunks), dim, pieces)


def plan(tables: Dict[int, List[Tuple[str, tuple]]]) -> Dict[str,
                                                             LeafPlan]:
    """Every leaf's :class:`LeafPlan` (None for an empty node) from every
    rank's :func:`held` table, the same on every rank."""
    names = {rank: [n for n, _ in t] for rank, t in tables.items()}
    first = min(names)
    for rank, ns in names.items():
        if ns != names[first]:
            raise ValueError(
                f"orbax: the ranks' trees differ: rank {rank} holds "
                f"{sorted(set(ns) - set(names[first]))} and not "
                f"{sorted(set(names[first]) - set(ns))} of rank {first}'s")
    rows = {rank: dict(t) for rank, t in tables.items()}
    return {name: _leaf_plan(name, {r: rows[r][name] for r in rows})
            for name in names[first]}


def _piece(leaf: Any, region: Tuple[slice, ...]) -> np.ndarray:
    """A region of an array leaf on the host: a tensor cut where it lies
    and only the cut copied; bf16 as its 16-bit words."""
    if not region:
        return host_array(leaf)[0]
    if hasattr(leaf, "detach"):
        return host_array(leaf.detach()[region])[0]
    return host_array(leaf)[0][region]


def share(tree: Any, plans: Dict[str, Optional[LeafPlan]], rank: int,
          primary: bool) -> Dict[bytes, Value]:
    """The values rank ``rank`` writes into its store: the chunks the
    plans give it and, on the ``primary`` rank, every ``.zarray``."""
    flat = flat_leaves(tree)
    values: Dict[bytes, Value] = {}
    for name, lp in plans.items():
        if lp is None:
            continue
        if primary:
            values[f"{name}/.zarray".encode()] = zarray(lp.shape, lp.dtype,
                                                        lp.chunks)
        leaf = flat[name]
        for p in lp.pieces:
            if p.writer != rank:
                continue
            src = leaf.slices[leaf.index.index(p.slice)] \
                if lp.dim >= 0 else leaf
            try:
                values[p.key.encode()] = _raw(_piece(src, p.region))
            except Exception as e:
                raise ValueError(f"orbax: chunk {p.key} of {name} cannot be "
                                 f"written: {type(e).__name__}: {e}") from e
    return values


class _Across:
    """The ranks of one write across processes.  :meth:`step` runs a part
    of the write on every rank and gathers each rank's result; where any
    rank failed, the lowest rank removes ``undo``, every rank waits for
    that, and every rank raises :class:`OrbaxWriteError`."""

    def __init__(self, sub, path: str):
        from ..parallel.multihost import process_info

        self.sub, self.path = sub, path
        self.rank = process_info()[0]
        self.primary = self.rank == sub.ranks[0]
        self.undo: Optional[str] = None

    def step(self, what: str, fn) -> list:
        err = None
        try:
            got = (True, fn())
        except Exception as e:     # every rank learns of it, then raises
            err = e
            got = (False, f"{type(e).__name__}: {e}")
        every = self.sub.all_gather_object(got)
        failed: Dict[str, List[int]] = {}
        for rank, (ok, v) in zip(self.sub.ranks, every):
            if not ok:
                failed.setdefault(v, []).append(rank)
        if not failed:
            return [v for _, v in every]
        if self.primary and self.undo:
            shutil.rmtree(self.undo, ignore_errors=True)
        self.sub.all_gather_object(None)       # the undo is done
        raise OrbaxWriteError(
            f"orbax: {what} of {self.path} across ranks "
            f"{list(self.sub.ranks)} failed: " + "; ".join(
                f"rank{'s' * (len(r) > 1)} {', '.join(map(str, r))}: {msg}"
                for msg, r in failed.items())) from err


def _write_across(across: _Across, path: str, tree: Any) -> None:
    """Every rank's share of ``tree`` into its store under ``path``, then
    the lowest rank's root store and metadata."""
    tables = across.step("exchanging the leaves each rank holds",
                         lambda: held(tree))
    rank, primary = across.rank, across.primary

    def write_share():
        plans = plan(dict(zip(across.sub.ranks, tables)))
        store = os.path.join(path, process_store(rank))
        return write_store(store, share(tree, plans, rank, primary))

    stores = across.step("writing each rank's store", write_share)

    def commit():
        if primary:
            merge_stores(path, dict(zip(across.sub.ranks, stores)))
            write_metadata(path, tree_meta(tree, tables[0]))

    across.step("merging the stores", commit)


def _group(group):
    """``group`` as a ``multihost.Subgroup`` of two or more ranks, or None
    (no group, or a group of one rank: one process writes alone)."""
    from ..parallel.multihost import as_subgroup

    sub = as_subgroup(group)
    return sub if sub is not None and len(sub.ranks) > 1 else None


def write_orbax(path: str, tree: Any, group=None) -> str:
    """Write ``tree`` (nested dicts/lists of numpy arrays, torch tensors,
    :class:`ShardedLeaf` s, Python numbers, empty nodes) as an orbax step
    into the new or empty directory ``path``.  With ``group`` (two or more
    ranks) every rank of it calls this with its own tree, as
    :func:`save_orbax`; a failure removes ``path``."""
    sub = _group(group)
    if sub is None:
        meta, values = tree_values(tree)
        os.makedirs(path, exist_ok=True)
        write_store(path, values)
        write_metadata(path, meta)
        return path
    across = _Across(sub, os.path.abspath(path))

    def prepare():
        if across.primary:
            if os.path.isdir(path) and os.listdir(path):
                raise ValueError(f"{path} is not empty")
            os.makedirs(path, exist_ok=True)

    across.step("preparing", prepare)
    across.undo = path
    _write_across(across, path, tree)
    return path


def _replace(tmp: str, path: str) -> None:
    """Rename ``tmp`` to ``path``; an older directory there is replaced,
    and kept where the rename fails."""
    if not os.path.isdir(path):
        os.rename(tmp, path)
        return
    parent, base = os.path.split(path)
    old = tempfile.mkdtemp(prefix=f".{base}-old-", dir=parent)
    os.rename(path, os.path.join(old, base))
    try:
        os.rename(tmp, path)
    except BaseException:
        os.rename(os.path.join(old, base), path)
        os.rmdir(old)
        raise
    shutil.rmtree(old, ignore_errors=True)


def save_orbax(path: str, tree: Any, group=None) -> str:
    """``tree`` as the orbax step ``path``, written whole in a hidden
    directory beside it and renamed into place; an older directory at
    ``path`` is replaced.  Returns ``path``.

    ``group`` (a ``torch.distributed`` process group or a
    ``multihost.Subgroup``, e.g. a train step's ``ranks.every``) names
    the ranks that hold the tree; with two or more, every rank of it calls
    this with its own tree (the replicated leaves alike on every rank, a
    :class:`ShardedLeaf` holding the rank's slices), and the step is the
    one orbax writes from every process of a JAX run.  The lowest rank
    makes the hidden directory; each rank writes its share into
    ``ocdbt.process_<rank>/`` (each chunk once: a slice by the ranks
    holding it, a replicated leaf split over every rank as orbax splits a
    replicated array over its replicas, the ``.zarray`` s by the lowest
    rank); after every rank has written, the lowest writes the root
    ``manifest.ocdbt`` over the ranks' data files and the metadata, and
    renames the directory into place; no rank returns before that.  The
    ranks must share a filesystem, as orbax's processes must.  An error
    on any rank raises :class:`OrbaxWriteError` on every rank and leaves
    no step and no hidden directory; an older step at ``path`` stays."""
    path = os.path.abspath(path)
    parent, base = os.path.split(path)
    sub = _group(group)
    if sub is None:
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".{base}-", dir=parent)
        try:
            write_orbax(tmp, tree)
            _replace(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return path
    across = _Across(sub, path)

    def hide():
        if across.primary:
            os.makedirs(parent, exist_ok=True)
            return tempfile.mkdtemp(prefix=f".{base}-", dir=parent)

    across.undo = across.step("making the hidden directory", hide)[0]
    _write_across(across, across.undo, tree)
    across.step("renaming the step into place",
                lambda: _replace(across.undo, path) if across.primary
                else None)
    return path


def step_bytes(path: str) -> int:
    """Bytes of every file under a step directory."""
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)
