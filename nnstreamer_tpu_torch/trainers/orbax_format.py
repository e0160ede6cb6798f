"""The JAX package's orbax step directories, read without orbax.

``nnstreamer_tpu/trainers/checkpoint.py`` saves a pytree with
``orbax.checkpoint.StandardCheckpointer``.  A step directory then holds:

- ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path (a
  tuple's string) to its ``key_metadata`` (each key with ``key_type`` 2
  for a dict key, 1 for a sequence index) and ``value_metadata``
  (``value_type`` ``np.ndarray``, ``jax.Array`` or ``scalar`` for an
  array, ``None``/``Dict``/``List`` for an empty node); ``use_ocdbt`` and
  ``use_zarr3`` say how the arrays are stored;
- with ``use_ocdbt``: an OCDBT store (``trainers/ocdbt.py``) holding, for
  each leaf named by its keys joined with ``.``, a zarr v2 array:
  ``<name>/.zarray`` and one chunk a key (``<name>/0.1``; ``0`` for a 0-d
  array); without it, the same keys as files under the directory.

A ``.zarray`` is read for its dtype (``<f2``/``<f4``/``<f8``, signed and
unsigned integers of 1 to 8 bytes, ``|b1``, ``bfloat16``;
little-endian), shape, chunk grid, ``fill_value`` (a missing chunk holds it;
null reads as zeros; where ``_METADATA`` says every chunk was stored,
``store_array_data_equal_to_fill_value``, a missing chunk raises as
orbax's restore does) and order ``C``.  Edge chunks are stored at the full
chunk shape and cut.  Chunks are zstd frames (``native/nns_zstd.cc``) or
raw bytes.  Not read yet, each refused naming its field: ``use_zarr3:
true``, a compressor other than zstd or none, ``filters``, order ``F``.

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

import itertools
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.params_io import _bf16_tensor
from ..nativelib import zstd_decompress
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


# -- zarr v2 -------------------------------------------------------------------


def _dtype(desc: Any, name: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype the chunks hold, is bf16) of a ``.zarray`` dtype."""
    if desc == "bfloat16":
        return np.dtype("<u2"), True
    try:
        dt = np.dtype(desc)
    except TypeError:
        raise OrbaxFormatError(f"{name}: dtype {desc!r} is not read") \
            from None
    if dt.kind not in "fiub" or dt.byteorder == ">" or dt.itemsize > 8 \
            or dt.kind == "f" and dt.itemsize not in (2, 4, 8):
        raise OrbaxFormatError(f"{name}: dtype {desc!r} is not read")
    return dt, False


def _fill(value: Any, dt: np.dtype, bf16: bool, name: str) -> np.ndarray:
    """The 0-d array a missing chunk is filled with."""
    if value is None:
        return np.zeros((), dt)
    if isinstance(value, str):
        value = {"NaN": np.nan, "Infinity": np.inf,
                 "-Infinity": -np.inf}.get(value)
        if value is None:
            raise OrbaxFormatError(f"{name}: fill_value is not read")
    if bf16:
        t = torch.tensor(float(value), dtype=torch.float32)
        return np.asarray(t.to(torch.bfloat16).view(torch.int16).numpy()
                          .view(np.uint16))
    return np.array(value, dt)


def read_zarr(store, name: str, fill_missing: bool = True
              ) -> Tuple[np.ndarray, bool]:
    """(the zarr v2 array ``name`` of ``store``, is bf16): ``store.read``
    gives a key's bytes or None.  A bf16 array comes back as its uint16
    words.  A missing chunk holds the fill value, or raises where
    ``fill_missing`` is false."""
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
    if comp is not None and (not isinstance(comp, dict)
                             or comp.get("id") != "zstd"):
        what = comp.get("id") if isinstance(comp, dict) else comp
        raise OrbaxFormatError(f"{name}: compressor {what!r} is not read "
                               "(zstd or none)")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: filters {meta['filters']!r} are "
                               "not read")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {meta['order']!r} is not "
                               "read (C only)")
    dt, bf16 = _dtype(meta.get("dtype"), name)
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    fill = _fill(meta.get("fill_value"), dt, bf16, name)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dt.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = None
    for idx in itertools.product(*map(range, grid)):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = store.read(key)
        if data is None:
            if not fill_missing:
                raise OrbaxFormatError(f"chunk {key!r} is missing")
            block = None
        else:
            if comp is not None:
                try:
                    buf = zstd_decompress(data, chunk_bytes)
                except ValueError as e:
                    raise OrbaxFormatError(f"{key}: {e}") from None
            elif len(data) != chunk_bytes:
                raise OrbaxFormatError(f"{key}: {len(data)} bytes, expected "
                                       f"{chunk_bytes}")
            else:
                buf = np.frombuffer(bytearray(data), np.uint8)
            block = buf.view(dt).reshape(chunks)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        if block is not None and chunks == shape:
            out = block                      # the one chunk is the array
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
    """(key path, leaf) of every entry of ``_METADATA``'s tree."""
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
            arr, bf16 = read_zarr(store, ".".join(k for k, _ in keys),
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
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: use_zarr3: true (zarr v3 arrays) "
                               "is not read yet")
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
