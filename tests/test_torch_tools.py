"""The developer tools of the port against the JAX package's tests:
``tests/test_tools.py``'s check CLI, dot dump and scaffold generator
classes and all of ``tests/test_tools_convert.py``, replayed on
``nnstreamer_tpu_torch`` (``python -m nnstreamer_tpu_torch.check``,
``Pipeline.to_dot``, ``python -m nnstreamer_tpu_torch.tools.*``); then the
port's own cases: ``to_dot`` text equal to the JAX package's for the same
descriptions, the committed element docs equal to the generator's, the
doc examples and ``check``'s inventory."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_replay import replay

_CPU_PARSE = (
    "from nnstreamer_tpu.runtime import Pipeline, parse_launch\n",
    "from nnstreamer_tpu.runtime import Pipeline\n"
    "from functools import partial as _partial\n"
    "from nnstreamer_tpu.runtime import parse_launch as _parse_launch\n"
    "parse_launch = _partial(_parse_launch, device='cpu')\n")

replay("test_tools.py", globals(), subs=(
    _CPU_PARSE,
    ('[sys.executable, "tools/gen_custom_filter.py", ',
     '[sys.executable, "-m", "nnstreamer_tpu.tools.gen_custom_filter", '),
), only=("TestCheckCli", "TestDotDump", "TestScaffoldGenerator"))

replay("test_tools_convert.py", globals(), subs=(
    ("    p = parse_launch(launch2)\n",
     '    p = parse_launch(launch2, device="cpu")\n'),
))


# -- the port's own cases ------------------------------------------------------

import nnstreamer_tpu.runtime as jruntime  # noqa: E402
import nnstreamer_tpu_torch.runtime as truntime  # noqa: E402
from nnstreamer_tpu.core import Buffer as JBuffer  # noqa: E402
from nnstreamer_tpu.core import TensorsSpec as JSpec  # noqa: E402
from nnstreamer_tpu_torch.core import Buffer as TBuffer  # noqa: E402
from nnstreamer_tpu_torch.core import TensorsSpec as TSpec  # noqa: E402
from nnstreamer_tpu_torch.tools import gen_element_docs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOT_CASES = [
    "appsrc name=src ! tensor_transform mode=typecast option=float32 ! "
    "appsink name=out",
    "appsrc name=src ! tee name=t t. ! queue ! appsink name=a "
    "t. ! queue prefetch-host=true ! appsink name=b",
    "appsrc name=a ! tensor_mux name=m sync-mode=nosync ! appsink name=out "
    "appsrc name=b ! m.sink_1",
]


@pytest.mark.parametrize("desc", DOT_CASES, ids=["linear", "tee", "mux"])
def test_to_dot_equals_the_jax_text_unstarted(desc):
    """The static dump ('?' on every edge) of the same description."""
    jp = jruntime.parse_launch(desc)
    tp = truntime.parse_launch(desc, device="cpu")
    assert tp.to_dot() == jp.to_dot()
    assert "?" in tp.to_dot()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_to_dot_equals_the_jax_text_negotiated(pkg):
    """After a run, both dumps carry the same negotiated caps."""
    desc = ("appsrc name=src ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:1 ! queue ! appsink name=out")
    dots = {}
    for name, parse, Spec, Buf in (
            ("jax", jruntime.parse_launch, JSpec, JBuffer),
            ("port", functools.partial(truntime.parse_launch,
                                       device="cpu"), TSpec, TBuffer)):
        p = parse(desc)
        p["src"].spec = Spec.parse("4:2", "uint8")
        with p:
            p["src"].push_buffer(Buf.of(np.zeros((2, 4), np.uint8)))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=30)
            dots[name] = p.to_dot()
    assert "?" not in dots[pkg] and "other/tensors" in dots[pkg]
    assert dots["port"] == dots["jax"]


def test_committed_element_docs_match_the_generator():
    # a fresh process: the pages list the registered frameworks and
    # decoder modes, which other tests in this process may add to
    r = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.tools."
         "gen_element_docs", "--check"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr[-500:]
    assert "up to date" in r.stdout
    pages = gen_element_docs.generate()
    from nnstreamer_tpu_torch.runtime.registry import list_elements

    assert set(pages) == {f"{n}.md" for n in list_elements()
                          if not n.startswith("_")} | {"README.md"}
    for text in pages.values():
        assert "jax-xla" not in text and "XLA" not in text


def test_doc_examples_use_only_port_elements():
    from nnstreamer_tpu_torch.analyze import Severity, analyze_description

    for name, desc in gen_element_docs.EXAMPLES.items():
        desc = desc[len("... !"):].strip() if desc.startswith("... !") \
            else desc
        diags, pipe = analyze_description(desc, fragment=True)
        assert pipe is not None, (name, [str(d) for d in diags])
        assert not [d for d in diags if d.severity != Severity.INFO], name


def test_check_text_names_the_pure_python_codec():
    r = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.check"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-500:]
    assert "nnstreamer-tpu-torch installation check" in r.stdout
    assert "native codec: no (the port keeps the pure-Python" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.check", "--json"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    info = json.loads(r.stdout)
    assert info["native_codec"] is False and info["native_codec_reason"]
    assert "torch-cuda" in info["filter_frameworks"]
    assert "jax-xla" not in info["filter_frameworks"]
    assert "cpu" in info["devices"]
