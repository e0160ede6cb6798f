"""Loader for the port's native (C++) host code, one library a source.

Counterpart of the JAX package's ``nativelib.py``, for three sources
under ``native/``:

- ``nns_wire.cc`` (a copy of the JAX package's): the protobuf wire codec.
  ``converters/codecs.py`` tries it first for protobuf frames and falls
  back to its Python loops when there is no toolchain, the build fails,
  or ``NNS_TPU_TORCH_NO_NATIVE`` is set (:func:`get_native`).
- ``nns_zstd.cc``: the zstd decoder (RFC 8878) and the CRC-32C that read
  the JAX package's orbax steps (``trainers/ocdbt.py``,
  ``trainers/orbax_format.py``).  It has no fallback: where it cannot be
  built, :func:`get_zstd` raises :class:`NativeBuildError` naming the
  cause (no ``g++``, or the compiler's own message).  The kill switch
  leaves it alone.

Each source is compiled by ``g++`` on first use into
``build/nnstreamer_tpu_torch/native/`` at the root of the checkout, named
by a hash of the source and the flags (an edited source builds anew, an
unchanged one is reused), and loaded with :mod:`ctypes`.  Processes that
build at once each write their own temporary file and rename it into
place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Callable, Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False
_zstd = None
_zstd_error: Optional[str] = None
_blosc = None
_blosc_error: Optional[str] = None
_zstd_fn = None                  # nns_zstd_decompress, handed to the blosc one

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SOURCE = NATIVE_DIR / "nns_wire.cc"
ZSTD_SOURCE = NATIVE_DIR / "nns_zstd.cc"
BLOSC_SOURCE = NATIVE_DIR / "nns_blosc.cc"
BUILD_DIR = (Path(__file__).resolve().parents[1] / "build"
             / "nnstreamer_tpu_torch" / "native")
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")

RANK_LIMIT = 16

#: ``nns_zstd_decompress`` status codes (``native/nns_zstd.cc``)
ZSTD_STATUS = {-1: "corrupt frame", -2: "truncated frame",
               -3: "output larger than expected",
               -4: "unsupported frame (dictionary or reserved bit)",
               -5: "content checksum mismatch",
               -6: "frame content size mismatch", -7: "out of memory"}
#: ``nns_blosc_decompress`` status codes (``native/nns_blosc.cc``)
BLOSC_STATUS = {-1: "corrupt frame", -2: "truncated frame",
                -3: "output larger than expected",
                -4: "unsupported frame (format version or block codec)",
                -5: "a zlib or zstd stream inside the frame is corrupt",
                -6: "no decoder for the frame's block codec",
                -7: "out of memory"}


class NativeBuildError(RuntimeError):
    """A native library could not be built or loaded."""


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


def _configure_zstd(lib) -> None:
    lib.nns_zstd_decompress.restype = ctypes.c_int32
    lib.nns_zstd_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.nns_zstd_content_size.restype = ctypes.c_int32
    lib.nns_zstd_content_size.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64)]
    lib.nns_crc32c.restype = ctypes.c_uint32
    lib.nns_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]


#: a decoder of one whole stream, as ``nns_blosc.cc``'s ``StreamFn``
STREAM_FN = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
    ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64))


def _configure_blosc(lib) -> None:
    lib.nns_blosc_nbytes.restype = ctypes.c_int32
    lib.nns_blosc_nbytes.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)]
    lib.nns_blosc_decompress.restype = ctypes.c_int32
    lib.nns_blosc_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p, STREAM_FN]


def _inflate(src, n, dst, cap, got) -> int:
    """A blosc zlib stream (``compress2``'s form) through :mod:`zlib`."""
    try:
        d = zlib.decompressobj()
        out = d.decompress(ctypes.string_at(src, n), cap + 1)
        if len(out) > cap:
            return -3
        if not d.eof or d.unused_data:
            return -1
    except zlib.error:
        return -1
    ctypes.memmove(dst, out, len(out))
    got[0] = len(out)
    return 0


_INFLATE = STREAM_FN(_inflate)


def library_path(source: Path = SOURCE) -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / (f"libnns_tpu_torch_{source.stem}-"
                        f"{h.hexdigest()[:16]}.so")


def _compile(source: Path, so: Path) -> None:
    """Compile ``source`` into ``so``; raises :class:`NativeBuildError`
    naming the cause."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeBuildError(
            f"building {source.name} needs g++ (or c++) on PATH; none found")
    tmp = so.with_name(f".{so.name}.{os.getpid()}.{threading.get_ident()}")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            err = r.stderr.decode(errors="replace").strip()[-2000:]
            raise NativeBuildError(
                f"g++ failed to build {source.name} (exit {r.returncode}): "
                f"{err}")
        os.replace(tmp, so)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(
            f"g++ could not build {source.name}: {e}") from e
    finally:
        try:
            tmp.unlink()
        except OSError:
            pass


def load_library(source: Path, configure: Callable) -> ctypes.CDLL:
    """The library built from ``source`` (built on first use), with its
    function types set by ``configure``; raises :class:`NativeBuildError`."""
    try:
        so = library_path(source)
    except OSError as e:
        raise NativeBuildError(f"cannot read {source}: {e}") from e
    if not so.is_file():
        _compile(source, so)
    try:
        lib = ctypes.CDLL(str(so))
        configure(lib)
    except (OSError, AttributeError) as e:
        raise NativeBuildError(f"cannot load {so}: {e}") from e
    return lib


def get_native() -> Optional[ctypes.CDLL]:
    """The wire codec's library, building it on first use; None =
    fallback."""
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
            _lib = load_library(SOURCE, _configure)
        except NativeBuildError:
            _lib = None
    return _lib


def get_zstd() -> ctypes.CDLL:
    """The zstd decoder's library, building it on first use; raises
    :class:`NativeBuildError` (the same one again after a failed
    build)."""
    global _zstd, _zstd_error
    if _zstd is not None:
        return _zstd
    with _lock:
        if _zstd is None:
            if _zstd_error is not None:
                raise NativeBuildError(_zstd_error)
            try:
                _zstd = load_library(ZSTD_SOURCE, _configure_zstd)
            except NativeBuildError as e:
                _zstd_error = (f"the zstd decoder for orbax steps is not "
                               f"available: {e}")
                raise NativeBuildError(_zstd_error) from e
    return _zstd


def get_blosc() -> ctypes.CDLL:
    """The blosc decoder's library, building it on first use; raises
    :class:`NativeBuildError` (the same one again after a failed
    build)."""
    global _blosc, _blosc_error
    if _blosc is not None:
        return _blosc
    with _lock:
        if _blosc is None:
            if _blosc_error is not None:
                raise NativeBuildError(_blosc_error)
            try:
                _blosc = load_library(BLOSC_SOURCE, _configure_blosc)
            except NativeBuildError as e:
                _blosc_error = (f"the blosc decoder for orbax steps is not "
                                f"available: {e}")
                raise NativeBuildError(_blosc_error) from e
    return _blosc


def blosc_decompress(src: bytes, size: Optional[int] = None) -> np.ndarray:
    """The bytes the blosc frame ``src`` holds, as a uint8 array; ``size``
    (where given) must equal the size its header declares.  Raises
    ``ValueError`` on a corrupt frame."""
    lib = get_blosc()
    src = bytes(src)
    nbytes = ctypes.c_uint64()
    rc = lib.nns_blosc_nbytes(src, len(src), ctypes.byref(nbytes))
    if rc != 0:
        raise ValueError(f"blosc: {BLOSC_STATUS.get(rc, rc)}")
    if size is not None and nbytes.value != size:
        raise ValueError(f"blosc: frame holds {nbytes.value} bytes, "
                         f"expected {size}")
    global _zstd_fn
    if _zstd_fn is None:
        _zstd_fn = ctypes.cast(get_zstd().nns_zstd_decompress,
                               ctypes.c_void_p)
    out = np.empty(max(nbytes.value, 1), np.uint8)
    got = ctypes.c_uint64()
    rc = lib.nns_blosc_decompress(src, len(src), out.ctypes.data,
                                  nbytes.value, ctypes.byref(got), _zstd_fn,
                                  _INFLATE)
    if rc != 0:
        raise ValueError(f"blosc: {BLOSC_STATUS.get(rc, rc)}")
    return out[:got.value]


def zstd_decompress(src: bytes, size: Optional[int] = None,
                    limit: int = 1 << 34) -> np.ndarray:
    """The bytes the zstd frames of ``src`` hold, as a uint8 array.
    ``size``: the exact decoded size (required where the frames do not
    store it, as zarr's chunks do not); else the frame's content size,
    or a buffer grown up to ``limit``.  Raises ``ValueError`` on corrupt
    input."""
    lib = get_zstd()
    # a view of the caller's bytes (a slice of a shard stays uncopied);
    # ``src`` lives until the call returns
    src = np.frombuffer(src, np.uint8)
    ptr = src.ctypes.data
    if size is None:
        declared = ctypes.c_int64()
        rc = lib.nns_zstd_content_size(ptr, len(src), ctypes.byref(declared))
        if rc != 0:
            raise ValueError(f"zstd: {ZSTD_STATUS.get(rc, rc)}")
        if declared.value >= 0:
            size = declared.value
    cap = size if size is not None else min(max(4 * len(src), 1 << 16),
                                            limit)
    if cap > limit:
        raise ValueError(f"zstd: frame holds {cap} bytes, over the "
                         f"limit of {limit}")
    got = ctypes.c_uint64()
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        rc = lib.nns_zstd_decompress(ptr, len(src), out.ctypes.data, cap,
                                     ctypes.byref(got))
        if rc == -3 and size is None and cap < limit:
            cap = min(2 * cap, limit)
            continue
        if rc != 0:
            raise ValueError(f"zstd: {ZSTD_STATUS.get(rc, rc)}")
        break
    if size is not None and got.value != size:
        raise ValueError(f"zstd: decoded {got.value} bytes, expected {size}")
    return out[:got.value]


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    data = bytes(data)
    return int(get_zstd().nns_crc32c(data, len(data)))
