"""Orbax step directories written in pure numpy, struct and json.

The port reads the JAX package's orbax steps without orbax
(``nnstreamer_tpu_torch/trainers/orbax_format.py``).  The card machine has
no orbax, tensorstore or zstd package, so ``chip_smoke.py`` phase 22
writes its full-width steps with :func:`write_orbax_step`, in the layout
``orbax.checkpoint.StandardCheckpointer`` writes (OCDBT, zarr v2); the
tests hold the writer's output against orbax's own restore.

- ``_METADATA``: ``tree_metadata`` keyed by each leaf's key tuple, dict
  keys ``key_type`` 2, sequence indices 1; arrays ``np.ndarray``, Python
  numbers ``scalar``; ``use_ocdbt`` true, ``use_zarr3`` false.
- ``manifest.ocdbt``: one version whose root is one b-tree leaf node;
  ``d/<name>``: every value that is not inline, then the node.
- each leaf ``a.b`` (its keys joined with ``.``): ``a.b/.zarray`` (zstd
  level 1, separator ``.``, ``fill_value`` null, order C) and its chunks
  ``a.b/0.0`` … (``0`` for a 0-d array), edge chunks padded to the full
  chunk shape.  ``chunks=`` sets a leaf's chunk shape (default: one
  chunk), ``missing=`` leaves chunks out (read back as the fill value).
- OCDBT nodes and zarr chunks are zstd frames of raw blocks (valid
  frames that need no compressor), with a single segment and the
  content size; every OCDBT file ends with its CRC-32C.

:func:`fixture_tree` is the tree of the committed step
``tests/data/orbax_step/`` (from a numpy seed); :func:`regenerate_fixture`
rewrites that step with the JAX package's ``save_orbax`` (it imports the
JAX package: run it where JAX and orbax are installed).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "orbax_step")
FIXTURE_SEED = 20261018

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MAX_INLINE = 100                  # values up to this many bytes stay inline
MAX_NODE = 100_000_000            # orbax's max_decoded_node_bytes
RAW_BLOCK = 128 * 1024


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
    """CRC-32C (Castagnoli), table-driven."""
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ _CRC[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def zstd_raw_frame(data: bytes) -> bytes:
    """A zstd frame of raw blocks: single segment, 8-byte content size."""
    out = [struct.pack("<IBQ", 0xFD2FB528, 0xE0, len(data))]
    view = memoryview(data)
    pos = 0
    while True:
        block = view[pos:pos + RAW_BLOCK]
        pos += len(block)
        last = pos >= len(data)
        out.append(struct.pack("<I", (len(block) << 3) | int(last))[:3])
        out.append(bytes(block))
        if last:
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


# -- zarr leaves ---------------------------------------------------------------


def _zarr_dtype(arr: np.ndarray, bf16: bool) -> str:
    if bf16:
        return "bfloat16"
    return arr.dtype.str


def _host(leaf: Any) -> Tuple[np.ndarray, bool]:
    """(numpy array, is bf16) of a leaf: a torch bf16 tensor as its raw
    words, a numpy (ml_dtypes) bf16 array the same way."""
    if hasattr(leaf, "detach"):                    # a torch tensor
        t = leaf.detach().cpu().contiguous()
        if str(t.dtype) == "torch.bfloat16":
            import torch

            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), True
    return arr, False


def _zarray(arr: np.ndarray, bf16: bool, chunks: Sequence[int]) -> bytes:
    meta = {"chunks": list(chunks),
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".",
            "dtype": _zarr_dtype(arr, bf16), "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape),
            "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def _chunk_items(name: str, arr: np.ndarray, chunks: Sequence[int]):
    """(key, raw bytes) of every chunk, edge chunks zero-padded."""
    grid = [-(-s // c) for s, c in zip(arr.shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}"
        region = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))
        part = arr[region]
        if part.shape != tuple(chunks):
            full = np.zeros(chunks, arr.dtype)
            full[tuple(slice(0, s) for s in part.shape)] = part
            part = full
        yield key, np.ascontiguousarray(part).tobytes()


# -- the tree ------------------------------------------------------------------


def _leaves(tree: Any, prefix=()) -> List[Tuple[tuple, Any]]:
    """(key path, leaf) pairs in the metadata's (key, key_type) form."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, prefix + ((str(k), 2),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, prefix + ((str(i), 1),))
        return out
    return [(prefix, tree)]


def flat_leaves(tree: Any) -> Dict[str, Any]:
    """Every leaf of ``tree`` by its orbax name (keys joined with ``.``)."""
    return {".".join(k for k, _ in keys): leaf
            for keys, leaf in _leaves(tree)}


def write_orbax_step(path: str, tree: Any,
                     chunks: Optional[Dict[str, Sequence[int]]] = None,
                     missing: Iterable[str] = (), seed: int = 0) -> str:
    """Write ``tree`` (nested dicts/lists of numpy arrays, torch tensors
    or Python numbers) as an orbax step at ``path`` (replaced if it
    exists); ``chunks`` maps a leaf's name to its chunk shape."""
    chunks = dict(chunks or {})
    missing = set(missing)
    rng = np.random.default_rng(seed)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(os.path.join(path, "d"))
    tree_meta: Dict[str, Any] = {}
    values: Dict[bytes, bytes] = {}
    for keys, leaf in _leaves(tree):
        name = ".".join(k for k, _ in keys)
        scalar = isinstance(leaf, (bool, int, float)) and \
            not isinstance(leaf, np.generic)
        arr, bf16 = _host(np.float64(leaf) if isinstance(leaf, float)
                          else np.int64(leaf) if scalar else leaf)
        tree_meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": "scalar" if scalar
                               else "np.ndarray",
                               "skip_deserialize": False}}
        shape = chunks.get(name, arr.shape)
        values[f"{name}/.zarray".encode()] = _zarray(arr, bf16, shape)
        for key, raw in _chunk_items(name, arr, shape):
            if key not in missing:
                values[key.encode()] = zstd_raw_frame(raw)
    data_name = "d/" + rng.bytes(16).hex()
    keys = sorted(values)
    blob = bytearray()
    kinds, where = [], []
    inline = bytearray()
    for k in keys:
        v = values[k]
        if len(v) <= MAX_INLINE:
            kinds.append(0)
            inline += v
        else:
            kinds.append(1)
            where.append(len(blob))
            blob += v
    prefix = [len(os.path.commonprefix([a, b]))
              for a, b in zip(keys, keys[1:])]
    suffix = [len(keys[0])] + [len(b) - p for b, p in zip(keys[1:], prefix)]
    body = (b"\x00" + _file_table([data_name]) + varint(len(keys))
            + _varints(prefix) + _varints(suffix)
            + b"".join(k[p:] for k, p in zip(keys, [0] + prefix))
            + _varints(len(values[k]) for k in keys) + _varints(kinds)
            + _varints([0] * len(where)) + _varints(where) + bytes(inline))
    node = _framed(BTREE_MAGIC, body)
    node_at = len(blob)
    blob += node
    with open(os.path.join(path, data_name), "wb") as f:
        f.write(blob)
    now = time.time_ns()
    manifest = (rng.bytes(16) + varint(0) + varint(MAX_INLINE)
                + varint(MAX_NODE) + bytes([4]) + varint(1)
                + struct.pack("<i", 0) + _file_table([data_name])
                + varint(1) + varint(1) + bytes([0]) + varint(0)
                + varint(node_at) + varint(len(node)) + varint(len(keys))
                + varint(len(node)) + varint(node_at)
                + struct.pack("<Q", now) + varint(0))
    with open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(_framed(MANIFEST_MAGIC, manifest))
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "standard_checkpoint_handler.StandardCheckpointHandler",
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now,
                   "commit_timestamp_nsecs": now, "custom_metadata": {}},
                  f)
    return path


def step_bytes(path: str) -> int:
    """Bytes of every file under a step directory."""
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


# -- the committed fixture -----------------------------------------------------


def fixture_tree() -> Dict[str, Any]:
    """The tree of ``tests/data/orbax_step/``: a 144x256 f32 leaf of
    small normals (a chunk of two zstd blocks whose literals are Huffman
    coded), a 192x256 f32 leaf of quarter steps (repeats: FSE-coded
    sequences), and small leaves of every other kind."""
    rng = np.random.default_rng(FIXTURE_SEED)
    return {
        "dense": {"w": (rng.standard_normal((144, 256)) * 0.05)
                  .astype(np.float32),
                  "b": rng.standard_normal(256).astype(np.float32)},
        "quant": (np.round(rng.standard_normal((192, 256)) * 4) / 4)
        .astype(np.float32),
        "layers": [{"scale": rng.standard_normal(8).astype(np.float16)},
                   {"ids": rng.integers(-9, 9, (3, 5)).astype(np.int32)}],
        "step": np.int64(1234),
        "mask": rng.integers(0, 2, 11).astype(np.bool_),
    }


def regenerate_fixture(path: str = FIXTURE_DIR) -> str:
    """Rewrite the committed step from :func:`fixture_tree` with the JAX
    package's ``save_orbax`` (orbax 0.11, tensorstore's zstd level 1)."""
    from nnstreamer_tpu.trainers.checkpoint import save_orbax

    if os.path.isdir(path):
        shutil.rmtree(path)
    save_orbax(path, fixture_tree())
    return path
