"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain ``extern "C"``
launcher, and loaded with :mod:`ctypes` — no PyTorch headers, so a build
takes seconds, not minutes.  Libraries go to ``build/nnstreamer_tpu_torch/``
at the root of the checkout, named by a hash of the source and the flags:
an edited source builds anew, an unchanged one is reused.

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
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nnstreamer_tpu_torch"
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


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    lib = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, proc: subprocess.Popen, tmp: Path, lib: Path) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent reader sees all or nothing
    build_logs[name] = out


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Build every missing library, all ``nvcc`` processes at once."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        started = [(n, *_start(n)) for n in names
                   if not library_path(n).is_file()]
        try:
            for n, proc, tmp, lib in started:
                _finish(n, proc, tmp, lib)
        finally:
            for _, proc, tmp, _ in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
