"""The plain reference and the cost counts, on the CPU at small sizes:
the reference against the program's modules in float32, and each
operation count against ``FlopCounterMode`` on the reference."""

import ast
import json
import math
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.cost import vit as vit_cost
from portbench.reference import common
from portbench.reference import vit as vit_ref

BENCH = Path(__file__).resolve().parents[1]
DATA = Path(__file__).resolve().parent / "data"


def _cfg(name):
    with open(DATA / name) as f:
        return json.load(f)


def _frames(n, size, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8,
                         generator=g)


@pytest.mark.parametrize("package", ["reference", "cost"])
def test_yardstick_imports_nothing_of_the_program(package):
    """The reference and the cost counts import neither the program nor
    JAX: only the standard library, numpy, torch and themselves."""
    allowed = {"__future__", "hashlib", "math", "typing", "numpy", "torch",
               "portbench"}
    for path in (BENCH / package).glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)


def test_normalize_matches_the_transform_kernel_plain_version():
    from nnstreamer_tpu_torch.ops.kernels import scale_bias_cast_reference

    x = _frames(2, 16)
    ref = common.normalize(x, 127.5, 127.5)
    prog = scale_bias_cast_reference(x, 1 / 127.5, -127.5)
    assert float((ref - prog).abs().max()) <= 2 ** -23


def test_vit_reference_matches_the_program_in_float32():
    from nnstreamer_tpu_torch.models.convert import vit_from_jax

    cfg = _cfg("vit_tiny.json")
    tree = vit_ref.make_tree(cfg, 9, "cpu")
    x = common.normalize(_frames(3, cfg["image_size"]), 127.5, 127.5)
    with torch.inference_mode():
        ref = vit_ref.logits(tree, x, cfg)
        prog = vit_from_jax(tree, cfg["num_heads"])(x, torch.float32)
    assert float((ref - prog).abs().max()) < 1e-4 * float(ref.abs().max())


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        with torch.inference_mode():
            fn()
    return counter.get_total_flops()


def test_vit_flops_match_the_counter():
    """Every product, attention's two included (the reference computes
    attention as two matrix products)."""
    cfg = _cfg("vit_tiny.json")
    tree = vit_ref.make_tree(cfg, 1, "cpu")
    x = torch.zeros(2, cfg["image_size"], cfg["image_size"], 3)
    got = _counted(lambda: vit_ref.logits(tree, x, cfg))
    assert got == 2 * vit_cost.flops_per_frame(cfg)


def test_vit_b16_counts():
    """ViT-B/16 at 224: 34.94 GFLOP a frame, 4·S²·D of attention a
    layer; one attention launch over a 128-frame window moves q, k, v and
    o once in bfloat16."""
    with open(BENCH / "configs" / "vit_b16_gap.json") as f:
        cfg = json.load(f)
    assert math.isclose(vit_cost.flops_per_frame(cfg), 34943299584)
    flops, nbytes = vit_cost.kernel_costs(cfg, 128)["attention"]
    assert flops == 128 * 4 * 196 ** 2 * 768
    assert nbytes == 4 * 128 * 196 * 768 * 2
    assert vit_cost.kernel_costs(cfg, 128)["prologue"] == \
        (0.0, 128 * 224 * 224 * 3 * 5)


def test_fp8_round_keeps_the_scale_and_loses_bits():
    x = torch.linspace(-3, 3, 1001)
    y = common.fp8_round(x)
    assert float(y.abs().max()) == pytest.approx(3.0)
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 2 ** -6 < float(rel.max()) <= 2 ** -4


def test_sub_seeds_take_any_whole_number():
    seeds = {common.sub_seed(s, "frames")
             for s in (0, 1, -1, 2 ** 31 + 7, 2 ** 70)}
    assert len(seeds) == 5 and all(0 <= s < 2 ** 63 for s in seeds)
    assert common.sub_seed(5, "frames") != common.sub_seed(5, "weights")
