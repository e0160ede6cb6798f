"""Checkpoints of in-pipeline training: file paths and step directories.

Counterpart of the JAX package's ``trainers/checkpoint.py``
(``model-save-path``/``model-load-path`` on the trainer).  Two formats:

- file paths (``.pkl``) hold the ``torch-cuda`` filter's model dict
  (``apply``, ``params``, ``in_shapes``, ``in_dtypes``), so an inference
  pipeline loads the trained model directly;
- directory paths hold an orbax step, as the JAX trainer's do: the port
  writes the layout of orbax's ``StandardCheckpointer``
  (``trainers/orbax_write.py``: ``_METADATA`` beside an OCDBT
  ``manifest.ocdbt``, zarr v2 arrays), which the JAX package's
  ``load_orbax`` reads.  :func:`load_dir` reads those, the JAX package's
  own, every other step orbax's restore reads (zarr v3, other
  compressors, per-file arrays, numbered manifests), and the port's
  older steps, one ``params.safetensors`` (``models/params_io.py``), all
  without orbax: ``trainers/orbax_format.py`` over ``trainers/ocdbt.py``
  and the zstd and blosc decoders of ``native/nns_zstd.cc`` and
  ``native/nns_blosc.cc`` (built with g++ on first use).
  Which format a directory holds is read from the files it holds, never
  from its name.

Step layout: a checkpoint ROOT directory holds numbered step
subdirectories (``root/100/``, ``root/200/``, …).  The step helpers
(copies of the JAX package's) resolve ``root@123`` / ``root@latest``
references (``filters/modeluri.py``) to a step directory and its version
tag, which is how a serving pool's hot-swap path
(``runtime/lifecycle.py``) loads the newest trained weights, from a port
step or a JAX one.  :func:`save_dir` and :func:`save_step` write a step
whole in a hidden directory of its root and rename it to its name, so
``root@latest`` never names a step still being written, in either
package; a step trained across processes is saved by every rank
together (``group=``), one ``ocdbt.process_<rank>/`` store a rank under
one merged ``manifest.ocdbt``, as the JAX package's ``save_orbax``
called from every process saves it.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

from ..models.params_io import load_safetensors
from .orbax_write import save_orbax

#: the one file of a step directory of PRs before the port wrote orbax
STEP_FILE = "params.safetensors"


def is_dir_path(path: str) -> bool:
    """Directory-shaped paths (trailing separator or an extension-less
    basename) save a step directory; ANY file extension means a
    single-file format (``model.ckpt`` is never turned into a
    directory).  The JAX package's ``is_orbax_path`` rule."""
    if path.endswith(os.sep) or path.endswith("/"):
        return True
    return os.path.splitext(os.path.basename(path))[1] == ""


def list_steps(root: str) -> List[int]:
    """Numeric step subdirectories of a checkpoint root, ascending."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(root, n)))


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, str(int(step)))


def resolve_step_dir(root: str, tag: str) -> Tuple[str, str]:
    """``(step directory, concrete tag)`` for a ``root@tag`` reference:
    ``latest`` picks the highest numbered step; a numeric tag must name
    an existing step.  Raises ``ValueError`` with the available steps —
    the caller (``filters/modeluri.py``) wraps it with the full URI."""
    tag = str(tag).strip()
    if tag.lower() in ("latest", "newest", "last"):
        step = latest_step(root)
        if step is None:
            raise ValueError(
                f"no numeric step directories under {root!r}")
        return step_dir(root, step), str(step)
    if not tag.isdigit():
        raise ValueError(
            f"step tag {tag!r} is neither numeric nor 'latest'")
    path = step_dir(root, int(tag))
    if not os.path.isdir(path):
        avail = list_steps(root)
        raise ValueError(
            f"step {tag} not found (available: "
            f"{avail if avail else 'none'})")
    return path, str(int(tag))


def save_dir(path: str, tree: Any, group=None) -> str:
    """Write ``tree`` as the orbax step directory ``path``
    (``orbax_write.save_orbax``: written whole beside it and renamed into
    place, replacing what was there), as the JAX trainer's ``save_orbax``
    does.  Leaves split over the ``model`` axis are written a chunk a
    slice.  With ``group`` (two or more ranks, e.g. a train step's
    ``ranks.every``) every rank of it calls this with its own tree: each
    writes its share into ``ocdbt.process_<rank>/``, the lowest rank
    merges the stores and renames the step into place, and no rank
    returns before it is there (the ranks share a filesystem)."""
    return save_orbax(path, tree, group)


def save_step(root: str, step: int, tree: Any, group=None) -> str:
    """Save one training step under the step layout (``root/<step>/``)
    and return its directory — the producer side of the ``root@latest``
    hot-swap reference, the JAX package's ``save_orbax_step``; ``group``
    as :func:`save_dir`'s."""
    return save_dir(step_dir(root, step), tree, group)


def load_dir(path: str, template: Optional[Any] = None) -> Any:
    """The tree a step directory holds: an orbax step, the port's or the
    JAX package's (``orbax_format.load_orbax``; ``template`` gives each
    leaf its dtype there, as the JAX trainer's resume does), or an older
    port step's ``params.safetensors`` (``template`` not used).  Raises
    ``ValueError`` for a directory that holds neither."""
    file = os.path.join(path, STEP_FILE)
    if os.path.isfile(file):
        return load_safetensors(file)[0]
    from .orbax_format import is_orbax_dir, load_orbax

    if is_orbax_dir(path):
        return load_orbax(path, template)
    raise ValueError(
        f"{path!r} is not a step directory: it holds neither {STEP_FILE} "
        "(an older step of this port) nor _METADATA (an orbax step)")
