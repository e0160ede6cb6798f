"""Persistent kernel cache: skip the ``nvcc`` builds across process restarts.

Counterpart of the JAX package's ``runtime/compilecache.py``.  The port
has no XLA executables; what a fresh PyTorch process rebuilds is the
shared library of each hand-written CUDA kernel (``ops/build.py``).  With
``NNS_TPU_TORCH_COMPILE_CACHE_DIR`` naming a writable directory, those
libraries are stored and looked up there, keyed by everything that makes
two builds interchangeable::

    (source digest, nvcc flags, `nvcc --version` string, target arch)

so an edited kernel, other flags, another toolkit or another card misses
instead of loading a library built for something else.  Every lookup is
counted (:data:`CACHE_STATS`: hits, misses, stores, errors).

Failure policy, as in the JAX package: the cache can make a start
faster, never wronger or broken.  An entry that fails to load
(``ctypes.CDLL`` on a truncated or foreign file) is removed, counted as an
error and rebuilt — a rebuild, never the kernel's plain version.  A set
but missing or unwritable directory warns once and the libraries build
into the default directory (``build/nnstreamer_tpu_torch/`` in the
checkout), as they do when the variable is unset.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Iterable, Optional

_log = logging.getLogger("nnstreamer_tpu_torch")

#: the one switch: set to a directory to arm the persistent cache
CACHE_ENV = "NNS_TPU_TORCH_COMPILE_CACHE_DIR"

_lock = threading.Lock()
#: cache dirs already warned about (unwritable/missing): once each
_warned_dirs: set = set()


class CacheStats:
    """Process-wide persistent-cache accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.errors = 0  # entries that failed to load, failed stores

    def _bump(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    def snapshot(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "stores": self.stores, "errors": self.errors}

    def reset(self) -> None:
        with self._lock:
            self.hits = self.misses = self.stores = self.errors = 0


#: the process-wide persistent-cache stats
CACHE_STATS = CacheStats()


def cache_dir() -> Optional[str]:
    """The armed cache directory, or None when the variable is unset.  A
    set but missing or unwritable directory returns None too, with one
    warning per directory: a misconfigured cache degrades to "no
    cache", never to a failure."""
    path = os.environ.get(CACHE_ENV, "").strip()
    if not path:
        return None
    if not os.path.isdir(path) or not os.access(path, os.W_OK):
        with _lock:
            if path not in _warned_dirs:
                _warned_dirs.add(path)
                _log.warning(
                    "compilecache: %s=%r is not a writable directory — "
                    "persistent kernel cache disabled, libraries build "
                    "into the default directory", CACHE_ENV, path)
        return None
    return path


def enabled() -> bool:
    return cache_dir() is not None


def make_key(source_digest: str, flags: Iterable[str], compiler: str,
             arch: str) -> str:
    """The persistent key: source digest, compiler flags, the compiler's
    version string and the target arch, hashed to a filename-safe id."""
    h = hashlib.sha256()
    for part in (source_digest, " ".join(flags), compiler, arch):
        h.update(str(part).encode())
        h.update(b"\x00")
    return h.hexdigest()


def drop(path: str, err: BaseException) -> None:
    """An entry that failed to load: counted as an error and removed
    (best effort) so the caller's rebuild replaces it."""
    CACHE_STATS._bump("errors")
    _log.warning("compilecache: dropping unloadable entry %s (%s: %s)",
                 os.path.basename(path), type(err).__name__, err)
    try:
        os.remove(path)
    except OSError:
        pass
