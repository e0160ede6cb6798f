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
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import time
from typing import Any, Dict, Iterable, List, Sequence, Tuple, Union

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


def _file_table(paths: Sequence[str]) -> bytes:
    enc = [p.encode() for p in paths]
    return (varint(len(enc)) + _varints([0] * max(len(enc) - 1, 0))
            + _varints(len(p) for p in enc) + _varints([0] * len(enc))
            + b"".join(enc))


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
    """(``tree_metadata``, store values) of ``tree``: one chunk a leaf, one
    a slice of a split leaf."""
    meta: Dict[str, Any] = {}
    values: Dict[bytes, Value] = {}
    for keys, leaf in leaves(tree):
        name = ".".join(k for k, _ in keys)
        key = str(tuple(k for k, _ in keys))
        empty = _empty_type(leaf)
        if empty is not None:
            meta[key] = leaf_entry(keys, empty)
            continue
        scalar = _is_number(leaf)
        meta[key] = leaf_entry(keys, "scalar" if scalar else "np.ndarray")
        if _is_split(leaf):
            if len(leaf.slices) != leaf.count:
                raise ValueError(
                    f"orbax: {name} holds slices {list(leaf.index)} of "
                    f"{leaf.count} on this rank; a leaf split over ranks is "
                    f"not written yet: gather it first "
                    f"(trained_tree(params, gather=True))")
            parts = [host_array(s) for s in leaf.slices]
            arr, bf16 = parts[0]
            shape = tuple(leaf.shape)
            if 0 in shape:
                raise ValueError(f"orbax: cannot save arrays with zero "
                                 f"size: {name}")
            values[f"{name}/.zarray".encode()] = zarray(
                shape, zarr_dtype(arr, bf16), arr.shape)
            for j, (part, _) in enumerate(parts):
                idx = [0] * len(shape)
                idx[leaf.split_dim] = j
                values[chunk_key(name, idx).encode()] = _raw(part)
            continue
        arr, bf16 = host_array(leaf)
        if arr.size == 0:
            raise ValueError(f"orbax: cannot save arrays with zero size: "
                             f"{name}")
        values[f"{name}/.zarray".encode()] = zarray(
            arr.shape, zarr_dtype(arr, bf16), arr.shape)
        for ck, raw in chunk_items(name, arr, arr.shape):
            values[ck.encode()] = raw
    return meta, values


# -- the files -----------------------------------------------------------------


def write_store(path: str, values: Dict[bytes, Value],
                token: bytes = b"") -> None:
    """The OCDBT store of ``values`` under ``path``: one data file ``d/<name>``
    (each value that is not inline, in key order, then the b-tree leaf
    node) and ``manifest.ocdbt``.  A uint8 array value is framed as it is
    written; ``token`` (32 bytes) names the data file and the manifest's
    uuid, else random."""
    token = token or os.urandom(32)
    os.makedirs(os.path.join(path, "d"), exist_ok=True)
    data_name = "d/" + token[:16].hex()
    keys = sorted(values)
    kinds, where, sizes = [], [], []
    inline = bytearray()
    at = 0
    with open(os.path.join(path, data_name), "wb") as f:
        for k in keys:
            v = values[k]
            framed = isinstance(v, np.ndarray)
            size = frame_size(v.size) if framed else len(v)
            sizes.append(size)
            if size <= MAX_INLINE:
                kinds.append(0)
                inline += zstd_raw_frame(v.tobytes()) if framed else v
                continue
            kinds.append(1)
            where.append(at)
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
        body = (b"\x00" + _file_table([data_name]) + varint(len(keys))
                + _varints(prefix) + _varints(suffix)
                + b"".join(k[p:] for k, p in zip(keys, [0] + prefix))
                + _varints(sizes) + _varints(kinds)
                + _varints([0] * len(where)) + _varints(where)
                + bytes(inline))
        node = _framed(BTREE_MAGIC, body)
        f.write(node)
    node_at = at
    now = time.time_ns()
    manifest = (token[16:32] + varint(0) + varint(MAX_INLINE)
                + varint(MAX_NODE) + bytes([4]) + varint(1)
                + struct.pack("<i", 0) + _file_table([data_name])
                + varint(1) + varint(1) + bytes([0]) + varint(0)
                + varint(node_at) + varint(len(node)) + varint(len(keys))
                + varint(len(node)) + varint(node_at)
                + struct.pack("<Q", now) + varint(0))
    with open(os.path.join(path, MANIFEST), "wb") as f:
        f.write(_framed(MANIFEST_MAGIC, manifest))


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


def write_orbax(path: str, tree: Any) -> str:
    """Write ``tree`` (nested dicts/lists of numpy arrays, torch tensors,
    :class:`ShardedLeaf` s, Python numbers, empty nodes) as an orbax step
    into the new or empty directory ``path``."""
    meta, values = tree_values(tree)
    os.makedirs(path, exist_ok=True)
    write_store(path, values)
    write_metadata(path, meta)
    return path


def save_orbax(path: str, tree: Any) -> str:
    """``tree`` as the orbax step ``path``, written whole in a hidden
    directory beside it and renamed into place; an older directory at
    ``path`` is replaced.  Returns ``path``."""
    path = os.path.abspath(path)
    parent, base = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{base}-", dir=parent)
    try:
        write_orbax(tmp, tree)
        if os.path.isdir(path):
            old = tempfile.mkdtemp(prefix=f".{base}-old-", dir=parent)
            os.rename(path, os.path.join(old, base))
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def step_bytes(path: str) -> int:
    """Bytes of every file under a step directory."""
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)
