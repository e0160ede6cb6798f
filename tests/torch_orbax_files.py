"""Orbax steps for the tests: the package's writer with the test-only knobs.

The port writes orbax steps itself
(``nnstreamer_tpu_torch/trainers/orbax_write.py``: OCDBT, zarr v2, one
chunk a leaf or a slice).  This module keeps only what the package must
not offer, for the tests and the reader's edge cases:

- :func:`write_orbax_step` with ``chunks=`` (a leaf's chunk shape: a grid
  that need not divide the shape, edge chunks padded) and ``missing=``
  (chunks left out, read back as the fill value or refused as damage),
  and a seeded data-file name; ``form="zarr3"`` writes zarr v3 arrays
  instead, as orbax's ``use_zarr3`` writes them (one ``sharding_indexed``
  chunk a leaf: inner ``bytes`` + ``zstd``, index ``bytes`` + ``crc32c``
  at the end), with ``inner=`` a leaf's inner chunk shape; it needs no
  orbax, so the card's smoke test writes full-width zarr v3 steps with
  it;
- :func:`fixture_tree`, the tree of the committed step
  ``tests/data/orbax_step/`` (from a numpy seed), and
  :func:`regenerate_fixture`, which rewrites that step with the JAX
  package's ``save_orbax`` (it imports the JAX package: run it where JAX
  and orbax are installed).

``crc32c``, ``zstd_raw_frame``, ``flat_leaves`` and ``step_bytes`` are the
package's, named here for the tests that use them.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from nnstreamer_tpu_torch.trainers import orbax_write as OW
from nnstreamer_tpu_torch.trainers.orbax_format import V3_TYPES
from nnstreamer_tpu_torch.trainers.orbax_write import (  # noqa: F401
    crc32c,
    flat_leaves,
    step_bytes,
    zstd_raw_frame,
)

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "orbax_step")
FIXTURE_SEED = 20261018


def write_orbax_step(path: str, tree: Any,
                     chunks: Optional[Dict[str, Sequence[int]]] = None,
                     missing: Iterable[str] = (), seed: int = 0,
                     form: str = "zarr2",
                     inner: Optional[Dict[str, Sequence[int]]] = None) -> str:
    """Write ``tree`` as an orbax step at ``path`` (replaced if it
    exists) with the package's encoder; ``chunks`` maps a leaf's name to
    its chunk shape, ``missing`` names chunks left out.  ``form="zarr3"``
    writes zarr v3 arrays, one shard a leaf, ``inner`` mapping a leaf's
    name to its inner chunk shape (else the leaf's shape)."""
    if form == "zarr3":
        meta, _ = OW.tree_values(tree)
        values = zarr3_values(tree, inner or {})
    elif form != "zarr2":
        raise ValueError(f"form {form!r}: zarr2 or zarr3")
    else:
        meta, values = OW.tree_values(tree)
    flat = flat_leaves(tree)
    for name, shape in (chunks or {}).items():
        arr, bf16 = OW.host_array(flat[name])
        for key in [k for k in values if k.startswith(f"{name}/".encode())]:
            del values[key]
        values[f"{name}/.zarray".encode()] = OW.zarray(
            arr.shape, OW.zarr_dtype(arr, bf16), shape)
        for key, raw in OW.chunk_items(name, arr, shape):
            values[key.encode()] = raw
    for key in missing:
        del values[key.encode()]
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    OW.write_store(path, values, np.random.default_rng(seed).bytes(32))
    OW.write_metadata(path, meta)
    if form == "zarr3":
        with open(os.path.join(path, OW.METADATA)) as f:
            top = json.load(f)
        top["use_zarr3"] = True
        with open(os.path.join(path, OW.METADATA), "w") as f:
            json.dump(top, f)
    return path


def zarr3_json(shape: Sequence[int], dtype: str,
               inner: Sequence[int]) -> bytes:
    """A zarr v3 ``zarr.json`` as orbax's ``use_zarr3`` writes it: one
    shard over the array, ``inner`` its inner chunk shape."""
    half = [{"name": "bytes", "configuration": {"endian": "little"}}]
    meta = {"chunk_grid": {"name": "regular",
                           "configuration": {"chunk_shape": list(shape)}},
            "chunk_key_encoding": {"name": "default"},
            "codecs": [{"name": "sharding_indexed", "configuration": {
                "chunk_shape": list(inner),
                "codecs": half + [{"name": "zstd", "configuration": {
                    "level": 3, "checksum": False}}],
                "index_codecs": half + [{"name": "crc32c"}]}}],
            "data_type": dtype, "fill_value": [0, 0] if dtype.startswith(
                "complex") else False if dtype == "bool" else 0,
            "node_type": "array",
            "shape": list(shape), "zarr_format": 3}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def zarr3_shard(arr: np.ndarray, inner: Sequence[int]) -> bytes:
    """The one shard of ``arr``: each inner chunk a zstd frame of raw
    blocks, in C order over the inner grid, then the index (offset,
    length as u64 LE) and its CRC-32C."""
    inner = tuple(inner)
    if any(s % c for s, c in zip(arr.shape, inner)):
        raise ValueError(f"inner chunks {inner} do not divide {arr.shape}")
    grid = [s // c for s, c in zip(arr.shape, inner)]
    body, index = bytearray(), []
    for idx in np.ndindex(*grid):
        part = arr[tuple(slice(i * c, (i + 1) * c)
                         for i, c in zip(idx, inner))]
        frame = zstd_raw_frame(np.ascontiguousarray(part).tobytes())
        index.append((len(body), len(frame)))
        body += frame
    raw = b"".join(struct.pack("<QQ", o, n) for o, n in index)
    return bytes(body) + raw + struct.pack("<I", crc32c(raw))


def zarr3_values(tree: Any, inner: Dict[str, Sequence[int]]
                 ) -> Dict[bytes, bytes]:
    """The store values of ``tree`` as zarr v3 arrays: ``<name>/zarr.json``
    and the shard ``<name>/c/0/...`` (``<name>/c`` for a 0-d leaf)."""
    values: Dict[bytes, bytes] = {}
    for keys, leaf in OW.leaves(tree):
        if OW._empty_type(leaf) is not None:
            continue
        name = ".".join(k for k, _ in keys)
        arr, bf16 = OW.host_array(leaf)
        v3 = "bfloat16" if bf16 else _v3_type(arr)
        shape = inner.get(name, arr.shape)
        values[f"{name}/zarr.json".encode()] = zarr3_json(arr.shape, v3,
                                                          shape)
        key = f"{name}/c" + "".join(f"/0" for _ in arr.shape)
        values[key.encode()] = zarr3_shard(arr, shape)
    return values


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


# -- the committed forms ---------------------------------------------------------

FORMS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "data", "orbax_forms")
FORMS_SEED = 20261025


def forms_tree() -> Dict[str, Any]:
    """The tree every committed form holds: f32 leaves large enough for
    several chunks and blosc blocks, and small leaves of the other
    dtypes (f16, f64, complex64, the integers, bool, a 0-d int64)."""
    rng = np.random.default_rng(FORMS_SEED)
    return {
        "dense": {"w": (rng.standard_normal((64, 96)) * 0.05)
                  .astype(np.float32),
                  "b": rng.standard_normal(96).astype(np.float32)},
        "quant": (np.round(rng.standard_normal((40, 64)) * 4) / 4)
        .astype(np.float16),
        "ids": rng.integers(-9, 9, (5, 7, 3)).astype(np.int32),
        "pix": rng.integers(0, 256, (24, 40)).astype(np.uint8),
        "z": (rng.standard_normal((6, 5))
              + 1j * rng.standard_normal((6, 5))).astype(np.complex64),
        "f64": rng.standard_normal(9),
        "mask": rng.integers(0, 2, 11).astype(np.bool_),
        "step": np.array(1234, np.int64),
    }


def _v3_type(a: np.ndarray) -> str:
    """The zarr v3 data type of a (little-endian) numpy array."""
    return {v: k for k, v in V3_TYPES.items()}[a.dtype.str]


def _v3_fill(a: np.ndarray, special: bool = False):
    if a.dtype.kind == "c":
        return [0.0, "Infinity"] if special else [0.0, 0.0]
    if a.dtype.kind == "f":
        return "NaN" if special else 0.0
    return False if a.dtype.kind == "b" else 0


def _part(shape, k: int):
    """A chunk shape of about 1/k of ``shape`` a dimension."""
    return [max(1, -(-s // k)) for s in shape]


def _inner_start(name: str, a: np.ndarray) -> dict:
    """Shards of twice the inner chunk (a third of each dimension), so
    the last shard runs past the array and its outside inner chunks are
    never written; the index at the start."""
    inner = _part(a.shape, 3)
    half = [{"name": "bytes", "configuration": {"endian": "little"}}]
    return {"shape": list(a.shape), "data_type": _v3_type(a),
            "fill_value": _v3_fill(a),
            "chunk_grid": {"name": "regular", "configuration": {
                "chunk_shape": [2 * c for c in inner]}},
            "codecs": [{"name": "sharding_indexed", "configuration": {
                "chunk_shape": inner,
                "codecs": half + [{"name": "zstd",
                                   "configuration": {"level": 1}}],
                "index_codecs": half + [{"name": "crc32c"}],
                "index_location": "start"}}]}


def _transpose_gzip_crc(name: str, a: np.ndarray) -> dict:
    """Reversed axes, big-endian bytes, gzip, CRC-32C; the chunk keys
    ``c.i.j``; NaN (Infinity) fill values."""
    return {"shape": list(a.shape), "data_type": _v3_type(a),
            "fill_value": _v3_fill(a, special=True),
            "chunk_grid": {"name": "regular", "configuration": {
                "chunk_shape": _part(a.shape, 2)}},
            "chunk_key_encoding": {"name": "default",
                                   "configuration": {"separator": "."}},
            "codecs": [{"name": "transpose", "configuration": {
                "order": list(range(a.ndim))[::-1]}},
                {"name": "bytes", "configuration": {"endian": "big"}},
                {"name": "gzip", "configuration": {"level": 5}},
                {"name": "crc32c"}]}


#: blosc settings by leaf of the ``zarr2_blosc`` form: lz4 bitshuffle
#: for the large leaf, zstd over 1 KiB blocks (several a chunk), every
#: other cname elsewhere
BLOSC_LEAVES = {
    "dense.w": {"cname": "lz4", "shuffle": 2},
    "dense.b": {"cname": "blosclz", "shuffle": 1},
    "quant": {"cname": "zstd", "shuffle": 1, "blocksize": 1024},
    "ids": {"cname": "snappy", "shuffle": 0},
    "pix": {"cname": "zlib", "shuffle": 2},
    "z": {"cname": "lz4hc", "shuffle": 1},
    "f64": {"cname": "blosclz", "shuffle": 2},
    "mask": {"cname": "lz4", "shuffle": 0},
    "step": {"cname": "snappy", "shuffle": 1},
}


def _zarr2(compressor: Callable[[str], dict], order: str = "C"):
    def meta(name: str, a: np.ndarray) -> dict:
        return {"shape": list(a.shape), "chunks": _part(a.shape, 2),
                "dtype": a.dtype.str, "compressor": compressor(name),
                "order": order if a.ndim > 1 else "C", "fill_value": None}
    return meta


#: form name -> (what it holds, how it is written): ``("orbax", kwargs)``
#: saves with ``PyTreeCheckpointHandler(**kwargs)``; ``("ts", zarr3,
#: metadata of a leaf, OCDBT config)`` rewrites the arrays with tensorstore
FORMS = {
    "zarr3_orbax": ("orbax's use_zarr3 (sharding_indexed, zstd)",
                    ("orbax", {"use_zarr3": True})),
    "zarr3_orbax_raw": ("orbax's use_zarr3 without compression",
                        ("orbax", {"use_zarr3": True,
                                   "use_compression": False})),
    "zarr3_inner_start": ("zarr v3 shards of inner chunks, the index at "
                          "the start", ("ts", True, _inner_start, None)),
    "zarr3_transpose_gzip_crc32c": (
        "zarr v3 transpose + big-endian bytes + gzip + crc32c",
        ("ts", True, _transpose_gzip_crc, None)),
    "zarr2_blosc": ("zarr v2 blosc, lz4 bitshuffle and every other cname",
                    ("ts", False, _zarr2(lambda n: dict(
                        {"id": "blosc", "clevel": 5}, **BLOSC_LEAVES[n])),
                     None)),
    "zarr2_bz2_order_f": ("zarr v2 bz2, order F",
                          ("ts", False, _zarr2(lambda n: {
                              "id": "bz2", "level": 9}, "F"), None)),
    "ocdbt_numbered": ("OCDBT with numbered manifests and zstd nodes, "
                       "written twice", ("ts", False, _zarr2(lambda n: {
                           "id": "zstd", "level": 3}),
                           {"manifest_kind": "numbered",
                            "compression": {"id": "zstd"}})),
}


def ts_step(path: str, tree: Dict[str, Any], zarr3: bool,
            meta_of: Callable[[str, np.ndarray], dict],
            config: Optional[dict] = None, use_ocdbt: bool = True,
            first: Optional[Dict[str, Any]] = None,
            store_fill: bool = True) -> str:
    """``tree`` (a dict of dicts of numpy arrays) saved by orbax
    (``use_zarr3=zarr3``), then its arrays written anew by tensorstore in
    one commit, each with the zarr metadata ``meta_of(name, array)`` and
    every chunk stored (``store_data_equal_to_fill_value``, as orbax
    stores them), into a new OCDBT store of ``config`` (or per-file
    arrays where ``use_ocdbt`` is false).  With ``first``, that tree is
    committed first, so the store holds two versions.  With ``store_fill``
    false, chunks equal to the fill value are left out (and inner chunks
    marked missing), and ``_METADATA`` says so."""
    import orbax.checkpoint as ocp
    import tensorstore as ts

    if os.path.isdir(path):
        shutil.rmtree(path)
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
        use_zarr3=zarr3, use_ocdbt=use_ocdbt)).save(
        path, args=ocp.args.PyTreeSave(tree))
    leaves = flat_leaves(tree)
    for n in os.listdir(path):
        if n.startswith(("manifest.", "ocdbt.process_")) or n == "d" or \
                n in leaves:
            full = os.path.join(path, n)
            shutil.rmtree(full) if os.path.isdir(full) else os.remove(full)
    if use_ocdbt:
        base = {"driver": "ocdbt", "base": f"file://{path}/",
                **({"config": config} if config else {})}
    else:
        base = None
    ctx = ts.Context()
    for version in ([first] if first is not None else []) + [tree]:
        txn = ts.Transaction()
        for name, arr in flat_leaves(version).items():
            arr = np.asarray(arr)
            t = ts.open({"driver": "zarr3" if zarr3 else "zarr",
                         "kvstore": dict(base, path=f"{name}/") if base
                         else f"file://{path}/{name}/",
                         "metadata": meta_of(name, arr),
                         "store_data_equal_to_fill_value": store_fill},
                        create=True, delete_existing=True, context=ctx,
                        transaction=txn).result()
            t.write(arr).result()
        txn.commit_sync()
    if not store_fill:
        meta_path = os.path.join(path, OW.METADATA)
        with open(meta_path) as f:
            meta = json.load(f)
        meta["store_array_data_equal_to_fill_value"] = False
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    return path


def regenerate_forms(root: str = FORMS_DIR) -> Dict[str, str]:
    """Rewrite every committed form under ``root`` from
    :func:`forms_tree` (orbax and tensorstore; new data-file names)."""
    import orbax.checkpoint as ocp

    tree = forms_tree()
    out = {}
    for form, (_, how) in FORMS.items():
        path = os.path.join(root, form)
        if how[0] == "orbax":
            if os.path.isdir(path):
                shutil.rmtree(path)
            ocp.Checkpointer(ocp.PyTreeCheckpointHandler(**how[1])).save(
                path, args=ocp.args.PyTreeSave(tree))
        else:
            _, zarr3, meta_of, config = how
            first = None
            if config and config.get("manifest_kind") == "numbered":
                first = {k: (np.zeros_like(v) if not isinstance(v, dict) else
                             {kk: np.zeros_like(vv) for kk, vv in v.items()})
                         for k, v in tree.items()}
            ts_step(path, tree, zarr3, meta_of, config, first=first)
        out[form] = path
    return out
