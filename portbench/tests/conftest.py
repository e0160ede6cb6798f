"""Shared fixtures of the benchmark's own tests: a tiny benchmark
description (``data/tiny_benchmark.json``: the ViT at toy widths and
sizes, a device pool of two-frame windows) and a CPU run of the harness
on it."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny():
    """``run(cell, seed=…, seconds=…, trace=…)``: one CPU run of a cell of
    the tiny description; returns the result line's object."""
    from portbench import harness

    spec = harness.load_json(DATA / "tiny_benchmark.json")

    def run(cell, seed=20240601, seconds=1.5, trace=False):
        c = harness.resolve(spec, cell, traffic_dir=DATA)
        return harness.run_cell(c, seed, seconds, trace, time.perf_counter(),
                                device="cpu", log=lambda *a: None)

    run.spec = spec
    return run


@pytest.fixture
def card():
    """The first CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
