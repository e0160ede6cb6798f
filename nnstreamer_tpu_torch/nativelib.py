"""Loader for the port's native (C++) host code: the protobuf wire codec.

Counterpart of the JAX package's ``nativelib.py``.  ``native/nns_wire.cc``
(a copy of the JAX package's) is compiled by ``g++`` on first use into
``build/nnstreamer_tpu_torch/native/`` at the root of the checkout, named
by a hash of the source and the flags (an edited source builds anew, an
unchanged one is reused), and loaded with :mod:`ctypes`.  Processes that
build at once each write their own temporary file and rename it into
place.  ``converters/codecs.py`` tries the library first for protobuf
frames and falls back to its Python loops when there is no toolchain, the
build fails, or ``NNS_TPU_TORCH_NO_NATIVE`` is set.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_lock = threading.Lock()
_lib = None
_tried = False

SOURCE = Path(__file__).resolve().parent / "native" / "nns_wire.cc"
BUILD_DIR = (Path(__file__).resolve().parents[1] / "build"
             / "nnstreamer_tpu_torch" / "native")
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")

RANK_LIMIT = 16


def _configure(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.nns_pb_encode_bound.restype = ctypes.c_uint64
    lib.nns_pb_encode_bound.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32]
    lib.nns_pb_encode.restype = ctypes.c_uint64
    lib.nns_pb_encode.argtypes = [
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
        u8p, ctypes.c_uint64]
    lib.nns_pb_decode.restype = ctypes.c_int32
    lib.nns_pb_decode.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32)]


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libnns_tpu_torch_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    """Compile the source into ``so``; False when there is no compiler or
    the build fails."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    tmp = so.with_name(f".{so.name}.{os.getpid()}.{threading.get_ident()}")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        try:
            tmp.unlink()
        except OSError:
            pass


def get_native() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None = fallback."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("NNS_TPU_TORCH_NO_NATIVE"):
            return None
        try:
            so = library_path()
        except OSError:
            return None
        if not so.is_file() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
            _configure(lib)
            _lib = lib
        except OSError:
            _lib = None
    return _lib
