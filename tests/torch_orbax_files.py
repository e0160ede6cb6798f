"""Orbax steps for the tests: the package's writer with the test-only knobs.

The port writes orbax steps itself
(``nnstreamer_tpu_torch/trainers/orbax_write.py``: OCDBT, zarr v2, one
chunk a leaf or a slice).  This module keeps only what the package must
not offer, for the tests and the reader's edge cases:

- :func:`write_orbax_step` with ``chunks=`` (a leaf's chunk shape: a grid
  that need not divide the shape, edge chunks padded) and ``missing=``
  (chunks left out, read back as the fill value or refused as damage),
  and a seeded data-file name;
- :func:`fixture_tree`, the tree of the committed step
  ``tests/data/orbax_step/`` (from a numpy seed), and
  :func:`regenerate_fixture`, which rewrites that step with the JAX
  package's ``save_orbax`` (it imports the JAX package: run it where JAX
  and orbax are installed).

``crc32c``, ``zstd_raw_frame``, ``flat_leaves`` and ``step_bytes`` are the
package's, named here for the tests that use them.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np

from nnstreamer_tpu_torch.trainers import orbax_write as OW
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
                     missing: Iterable[str] = (), seed: int = 0) -> str:
    """Write ``tree`` as an orbax step at ``path`` (replaced if it
    exists) with the package's encoder; ``chunks`` maps a leaf's name to
    its chunk shape, ``missing`` names chunks left out."""
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
    return path


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
