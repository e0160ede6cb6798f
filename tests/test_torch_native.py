"""The port's native (C++) protobuf codec (``nativelib.py``,
``native/nns_wire.cc``): ``tests/test_native.py`` replayed whole on the
port, then the port's own cases — the four encoders (native and Python in
each package) give one byte string, every decoder reads every encoder's
frame, and the port's kill switch is its own key."""

import os
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
from torch_replay import replay

import nnstreamer_tpu.nativelib as jnativelib
from nnstreamer_tpu.converters import codecs as jcodecs
from nnstreamer_tpu.core import Buffer as JBuffer

replay("test_native.py", globals())

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(named: bool):
    arrays = [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              np.array([7, 8, 9], np.uint8),
              np.array([[1.5, -0.0, np.nan]], np.float64),
              np.arange(-6, 6, dtype=np.int16).reshape(3, 4)]
    out = []
    for pkg, cls in (("port", Buffer), ("jax", JBuffer)):
        b = cls.of(*arrays)
        if named:
            for i, t in enumerate(b.tensors):
                object.__setattr__(t.spec, "name", f"t{i}")
        out.append(b)
    return out


def _encode(codec, lib, b, rate):
    lib._lib, lib._tried = None, False
    native = codec.protobuf_encode(b, b.spec(rate=rate))
    assert lib.get_native() is not None
    lib._lib, lib._tried = None, True
    python = codec.protobuf_encode(b, b.spec(rate=rate))
    lib._lib, lib._tried = None, False
    return native, python


@pytest.mark.parametrize("named", [False, True])
def test_four_encoders_give_one_byte_string(named, native_lib):
    """Native and Python protobuf encodings, in both packages, are one
    byte string; each decoder (native and Python, both packages) reads it
    back to the same arrays, names and rate."""
    if jnativelib.get_native() is None:
        pytest.skip("the JAX package's native library did not build")
    pb, jb = _frames(named)
    rate = Fraction(30, 1)
    frames = set(_encode(codecs, nativelib, pb, rate)
                 + _encode(jcodecs, jnativelib, jb, rate))
    assert len(frames) == 1
    frame = frames.pop()
    for codec, lib in ((codecs, nativelib), (jcodecs, jnativelib)):
        for tried in (False, True):
            lib._lib, lib._tried = None, tried
            out, spec = codec.protobuf_decode(frame)
            assert spec.rate == rate
            for got, want in zip(out.tensors, pb.tensors):
                np.testing.assert_array_equal(got.np(), want.np())
                assert got.np().dtype == want.np().dtype
                assert got.spec.name == want.spec.name
        lib._lib, lib._tried = None, False


def test_kill_switch_is_the_ports_own_key():
    """``NNS_TPU_TORCH_NO_NATIVE`` keeps the port on its Python path; the
    JAX package's ``NNS_TPU_NO_NATIVE`` leaves the port's library on."""
    code = ("import sys; sys.modules['jax'] = None\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from nnstreamer_tpu_torch import nativelib\n"
            "print(nativelib.get_native() is not None)\n")
    env = {k: v for k, v in os.environ.items() if "NO_NATIVE" not in k}
    seen = []
    for key in ("NNS_TPU_TORCH_NO_NATIVE", "NNS_TPU_NO_NATIVE"):
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             env={**env, key: "1"})
        assert out.returncode == 0, out.stderr
        seen.append(out.stdout.strip())
    assert seen == ["False", "True"]


def test_library_builds_into_the_checkouts_build_directory(native_lib):
    """The library lives under ``build/nnstreamer_tpu_torch/native/``
    (listed in .gitignore), named by a hash of its source."""
    path = nativelib.library_path()
    assert path.is_file()
    assert path.parent == nativelib.BUILD_DIR
    assert str(path).startswith(os.path.join(REPO, "build",
                                             "nnstreamer_tpu_torch"))
