"""A run loads neither JAX nor the JAX package: a CPU run of the harness
on the tiny description in a fresh process, then its ``sys.modules``
compared by whole top-level names (the port's name begins with the JAX
package's, so a prefix test would be wrong)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys, time
t = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench import harness
data = harness.BENCH / "tests" / "data"
spec = harness.load_json(data / "tiny_benchmark.json")
for cell in ("vit.device",):
    c = harness.resolve(spec, cell, traffic_dir=data)
    harness.run_cell(c, 11, 1.0, False, t, device="cpu",
                     log=lambda *a: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    p = subprocess.run([sys.executable, "-c", RUN.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "nnstreamer_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "nnstreamer_tpu"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench import harness

    for name in ("jax.numpy", "nnstreamer_tpu.core", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "nnstreamer_tpu_torch_extra", object())
    found = harness.forbidden_modules()
    assert {"jax.numpy", "nnstreamer_tpu.core", "flax"} <= set(found)
    assert "nnstreamer_tpu_torch_extra" not in found
