"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain ``extern "C"``
launcher, and loaded with :mod:`ctypes` — no PyTorch headers, so a build
takes seconds, not minutes.  By default libraries go to
``build/nnstreamer_tpu_torch/`` at the root of the checkout, named by a
hash of the source and the flags: an edited source builds anew, an
unchanged one is reused.

With ``NNS_TPU_TORCH_COMPILE_CACHE_DIR`` set to a writable directory
(``runtime/compilecache.py``) the libraries are stored and looked up
there instead, keyed also by the ``nvcc --version`` string and the arch;
every lookup is counted in ``compilecache.CACHE_STATS``.  An entry whose
bytes do not match the digest stored beside it (a truncated file), or
that fails to load, is removed, counted as an error and rebuilt.  The version
string is kept beside the entries (one small file per compiler binary),
so a process whose libraries are all cached runs no ``nvcc`` at all.

:func:`load` builds on first use (the kernel wrappers call it at their
first CUDA launch); :func:`build_all` starts one ``nvcc`` per source at
once and waits for them all, so a caller that wants every kernel ready
pays for the slowest build, not the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nnstreamer_tpu_torch"
ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "scale_bias_cast": "scale_bias_cast.cu",
    "flash_attention": "flash_attention.cu",
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: kernel name -> nvcc's output (ptxas register/spill report) of the
#: build this process ran; empty for a library reused from disk
build_logs: Dict[str, str] = {}
#: nvcc processes this process started (builds and ``--version``)
nvcc_runs = 0
#: the loader; a test swaps in a stub
_cdll = ctypes.CDLL
_nvcc_versions: Dict[str, str] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, else PyTorch's idea of the CUDA home,
    else ``PATH``; raises when there is none."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _nvcc_version(nvcc: str, cache: Optional[str]) -> str:
    """``nvcc --version``'s output, asked once per process and, with a
    cache directory, once per compiler binary (path, size, mtime): the
    answer is kept there beside the libraries."""
    global nvcc_runs
    if nvcc in _nvcc_versions:
        return _nvcc_versions[nvcc]
    memo = None
    if cache is not None:
        st = os.stat(nvcc)
        tag = hashlib.sha256(
            f"{os.path.realpath(nvcc)}\0{st.st_size}\0{st.st_mtime_ns}"
            .encode()).hexdigest()[:16]
        memo = Path(cache) / f"nvcc-{tag}.version"
        if memo.is_file():
            _nvcc_versions[nvcc] = memo.read_text()
            return _nvcc_versions[nvcc]
    nvcc_runs += 1
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout
    if memo is not None:
        tmp = memo.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(out)
        os.replace(tmp, memo)
    _nvcc_versions[nvcc] = out
    return out


def library_path(name: str, cache: Optional[str] = None) -> Path:
    """Where kernel ``name``'s library lives: under ``cache`` (the armed
    persistent cache) by the full key, else in BUILD_DIR by a hash of
    the source and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    if cache is not None:
        from ..runtime.compilecache import make_key

        key = make_key(h.hexdigest(), NVCC_FLAGS,
                       _nvcc_version(find_nvcc(), cache), ARCH)
        return Path(cache) / f"lib{name}-{key[:32]}.so"
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, lib: Path) -> Tuple[subprocess.Popen, Path]:
    global nvcc_runs
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    nvcc_runs += 1
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path, lib: Path,
            cached: bool = False) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n{out}")
    if cached:
        _store_digest(lib, tmp.read_bytes())
    os.replace(tmp, lib)  # atomic: a concurrent reader sees all or nothing
    build_logs[name] = out


def _digest_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".sha256")


def _store_digest(lib: Path, data: bytes) -> None:
    """The sidecar a cached library is checked against before it is
    loaded: a truncated file could map and fault instead of failing to
    load.  Written before the library itself, so a reader that sees the
    library sees its digest."""
    side = _digest_path(lib)
    tmp = side.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(hashlib.sha256(data).hexdigest())
    os.replace(tmp, side)


def _cached(name: str, lib: Path) -> bool:
    """A persistent-cache lookup: True (a hit, the library loaded) or
    False (a miss, or an entry whose bytes do not match its digest or
    that fails to load: dropped, to be rebuilt)."""
    from ..runtime.compilecache import CACHE_STATS, drop

    if not lib.is_file():
        CACHE_STATS._bump("misses")
        return False
    try:
        side = _digest_path(lib)
        want = side.read_text().strip() if side.is_file() else "(none)"
        got = hashlib.sha256(lib.read_bytes()).hexdigest()
        if got != want:
            raise OSError(f"content digest {got[:16]} is not the stored "
                          f"{want[:16]}")
        _loaded[name] = _cdll(str(lib))
    except OSError as e:
        drop(str(lib), e)
        _digest_path(lib).unlink(missing_ok=True)
        CACHE_STATS._bump("misses")
        return False
    CACHE_STATS._bump("hits")
    return True


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Build every missing library, all ``nvcc`` processes at once; with
    the persistent cache armed, look each one up there first."""
    from ..runtime.compilecache import CACHE_STATS, cache_dir

    names = list(SOURCES) if names is None else list(names)
    cache = cache_dir()
    with _lock:
        paths = {n: library_path(n, cache) for n in names}
        if cache is None:
            todo = [n for n in names if not paths[n].is_file()]
        else:
            todo = [n for n in names
                    if n not in _loaded and not _cached(n, paths[n])]
        started = [(n, *_start(n, paths[n])) for n in todo]
        try:
            for n, proc, tmp in started:
                _finish(n, proc, tmp, paths[n], cached=cache is not None)
                if cache is not None:
                    CACHE_STATS._bump("stores")
                    _loaded[n] = _cdll(str(paths[n]))
        finally:
            for _, proc, tmp in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _lock:
        if name not in _loaded:
            _loaded[name] = _cdll(str(path))
        return _loaded[name]
