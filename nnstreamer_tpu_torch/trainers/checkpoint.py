"""Checkpoints of in-pipeline training: file paths and step directories.

Counterpart of the JAX package's ``trainers/checkpoint.py``
(``model-save-path``/``model-load-path`` on the trainer).  Two formats:

- file paths (``.pkl``) hold the ``torch-cuda`` filter's model dict
  (``apply``, ``params``, ``in_shapes``, ``in_dtypes``), so an inference
  pipeline loads the trained model directly;
- directory paths hold one ``params.safetensors``
  (``models/params_io.py``) with the JAX-layout tree.  The JAX package
  writes orbax checkpoints there; orbax is a JAX library this port does
  not use, so a JAX-written orbax step does not load here (a later
  ROADMAP item), and a port step directory is not an orbax one.

Step layout: a checkpoint ROOT directory holds numbered step
subdirectories (``root/100/``, ``root/200/``, …).  The step helpers
(copies of the JAX package's) resolve ``root@123`` / ``root@latest``
references (``filters/modeluri.py``) to a step directory and its version
tag, which is how a serving pool's hot-swap path
(``runtime/lifecycle.py``) loads the newest trained weights.
:func:`save_step` writes a new step whole before it appears under its
number, so ``root@latest`` never names a step still being written.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

from ..models.params_io import load_safetensors, save_safetensors

#: the one file of a step directory
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


def save_dir(path: str, tree: Any) -> str:
    """Write ``tree`` as the directory ``path``'s ``params.safetensors``
    (through a temporary file, so a reader sees the old file or the new
    one)."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, STEP_FILE)
    tmp = final + ".tmp"
    save_safetensors(tmp, tree)
    os.replace(tmp, final)
    return path


def save_step(root: str, step: int, tree: Any) -> str:
    """Save one training step under the step layout (``root/<step>/``)
    and return its directory — the producer side of the ``root@latest``
    hot-swap reference.  A new step is written in a hidden directory and
    renamed to its number once whole."""
    path = step_dir(root, step)
    if os.path.isdir(path):
        return save_dir(path, tree)
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".step-{int(step)}-", dir=root)
    try:
        save_dir(tmp, tree)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def load_dir(path: str) -> Any:
    """The tree a step directory holds.  Raises ``ValueError`` for a
    directory without ``params.safetensors`` (a JAX orbax step among
    them)."""
    file = os.path.join(path, STEP_FILE)
    if not os.path.isfile(file):
        raise ValueError(
            f"{path!r} holds no {STEP_FILE}: not a step directory of this "
            "port (a JAX orbax checkpoint does not load here)")
    return load_safetensors(file)[0]
