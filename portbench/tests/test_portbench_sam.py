"""SAM's cell at a toy size on the CPU (``data/sam_tiny.json``: image 64,
patch 8, window 3 on an 8x8 grid, 3 blocks with block 1 global, width 128,
2 heads): the harness runs it and judges it correct, a broken bias or a
half-served window is not, the float8 control is not, and the cost
module's operations match ``FlopCounterMode`` on the reference and a hand
count."""

import copy
import json
import math
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import nnstreamer_tpu_torch.models as port_models
from nnstreamer_tpu_torch.models import sam as port_sam
from portbench import calibrate, harness
from portbench.cost import sam as sam_cost
from portbench.reference import sam as sam_ref

DATA = Path(__file__).resolve().parent / "data"
CELL = "sam.device"


def _cfg(name="sam_tiny.json"):
    with open(DATA / name) as f:
        return json.load(f)


@pytest.fixture
def sam_cell():
    """The tiny description with a SAM cell beside the ViT's (its
    two-frame device pool), resolved; ``run(seed)`` is one CPU run."""
    spec = copy.deepcopy(harness.load_json(DATA / "tiny_benchmark.json"))
    spec["configs"].append({"name": "sam_tiny",
                            "file": "portbench/tests/data/sam_tiny.json"})
    spec["workloads"].append({"name": CELL, "config": "sam_tiny",
                              "traffic": "tiny_device", "chips": 1})
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["name"] == "step_mfu"]
    spec["per_layer"][0]["workloads"].append(CELL)
    cell = harness.resolve(spec, CELL, traffic_dir=DATA)

    def run(seed=20240601):
        return harness.run_cell(cell, seed, 1.0, False, time.perf_counter(),
                                device="cpu", log=lambda *a: None)

    run.cell = cell
    return run


def test_the_tiny_cell_is_correct(sam_cell):
    out = sam_cell(2 ** 31 + 11)
    assert out["correct"] is True
    assert 0 < out["checks"]["embed_gap"]["value"] < \
        out["checks"]["embed_gap"]["limit"]


def _half_window(fn):
    def broken(model, x, *a, **kw):
        y = fn(model, x[: x.shape[0] // 2], *a, **kw)
        return torch.cat([y, torch.zeros_like(y)])
    return broken


def _rel_w_dropped(fn):
    def broken(q, k, v, rel_h, rel_w, key_grid):
        return fn(q, k, v, rel_h=rel_h, rel_w=torch.zeros_like(rel_w),
                  key_grid=key_grid)
    return broken


@pytest.mark.parametrize("module,target,fault", [
    (port_models, "sam_apply", _half_window),
    (port_sam, "flash_attention", _rel_w_dropped),
], ids=["half-window", "rel_w-dropped"])
def test_a_broken_path_is_not_correct(sam_cell, monkeypatch, module, target,
                                      fault):
    monkeypatch.setattr(module, target, fault(getattr(module, target)))
    out = sam_cell()
    assert out["correct"] is False
    assert out["checks"]["embed_gap"]["value"] > \
        out["checks"]["embed_gap"]["limit"]


def test_control_is_not_correct(sam_cell):
    """The reference with float8 operands in the program's place fails the
    limit on three seeds."""
    lim = sam_cell.cell.cfg["limits"]["embed_gap"]
    for seed in (1, 2, 3):
        numbers = calibrate.control_numbers(sam_cell.cell, seed,
                                            torch.device("cpu"))
        assert numbers["embed_gap"] > lim


def test_checked_frames_are_the_ends_and_thirty_drawn():
    tree = sam_ref.Tree()
    tree.seed = 12345
    frames = sam_ref.checked_frames(tree, 256)
    assert len(frames) == 32 and frames[0] == 0 and frames[-1] == 255
    assert frames == sam_ref.checked_frames(tree, 256)
    tree.seed = 12346
    assert frames != sam_ref.checked_frames(tree, 256)
    assert sam_ref.checked_frames(tree, 20) == list(range(20))


def test_flops_match_the_counter():
    """Every product of the reference, attention's two and the two
    relative-position einsums included, on the padded windows."""
    cfg = _cfg()
    tree = sam_ref.make_tree(cfg, 1, "cpu")
    x = torch.zeros(2, cfg["image_size"], cfg["image_size"], 3)
    with FlopCounterMode(display=False) as counter:
        with torch.inference_mode():
            sam_ref.embed(tree, x, cfg)
    assert counter.get_total_flops() == 2 * sam_cost.flops_per_frame(cfg)


def test_hand_count_at_the_tiny_size():
    """Grid 8, window 3 (padded to 9: 9 windows of 9 tokens, 81 tokens),
    width 128, MLP 256, neck 32; blocks 0 and 2 windowed, 1 global."""
    cfg = _cfg()
    embed = 2 * 64 * 128 * 8 * 8 * 3
    neck = 2 * 64 * 128 * 32 + 2 * 64 * 32 * 32 * 9
    mlp = 2 * 64 * 2 * 128 * 256
    window = (2 * 81 * 4 * 128 * 128 + mlp + 9 * 4 * 9 * 9 * 128
              + 2 * 2 * 81 * 128 * 3)
    glob = (2 * 64 * 4 * 128 * 128 + mlp + 4 * 64 * 64 * 128
            + 2 * 2 * 64 * 128 * 8)
    assert sam_cost.flops_per_frame(cfg) == embed + neck + 2 * window + glob
    costs = sam_cost.kernel_costs(cfg, 4)
    assert costs["attention_window"] == (4 * 9 * 4 * 81 * 128,
                                         4 * 4 * 81 * 128 * 2
                                         + 4 * 81 * 2 * 6 * 4)
    assert costs["attention_global"] == (4 * 4 * 64 * 64 * 128,
                                         4 * 4 * 64 * 128 * 2
                                         + 4 * 64 * 2 * 16 * 4)
    assert sam_cost.attention_launches(cfg) == {"window": 2, "global": 1}


def test_sam_vit_l_counts():
    """ViT-L at 1024: 2.986 TFLOP a frame, 4 global launches and 20
    windowed ones a forward; a window's global launches bound by their
    operations, its windowed ones by their bytes."""
    with open(harness.BENCH / "configs" / "sam_vit_l_1024.json") as f:
        cfg = json.load(f)
    assert math.isclose(sam_cost.flops_per_frame(cfg), 2985680306176)
    peaks = {"bf16_flops_per_s": 989.4e12, "hbm_bytes_per_s": 3.35e12}
    flops, nbytes = sam_cost.kernel_costs(cfg, 256)["attention_global"]
    assert flops == 256 * 16 * 4 * 4096 ** 2 * 64
    assert math.isclose(sam_cost.attention_bound_s(cfg, 256, peaks, "global"),
                        4 * flops / 989.4e12)
    flops, nbytes = sam_cost.kernel_costs(cfg, 256)["attention_window"]
    assert nbytes == 4 * 256 * 25 * 196 * 1024 * 2 + 256 * 25 * 196 * 16 * 28 * 4
    assert math.isclose(sam_cost.attention_bound_s(cfg, 256, peaks, "window"),
                        20 * nbytes / 3.35e12)
