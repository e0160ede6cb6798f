"""The comparison that decides ``correct`` fails what it must: a CPU run
of the harness on the tiny description with the timed path broken
underneath (half of each window's frames left out; one answer altered
where the model produces it), and the control (the reference in float8
operands in the program's place) at the tiny size."""

import pytest
import torch

import nnstreamer_tpu_torch.models as port_models


def _half_batch(fn, fill):
    """``fn``'s outputs for the first half of the window's frames; the
    second half's rows are ``fill``ed."""
    def broken(model, x, *a, **kw):
        outs = fn(model, x[: x.shape[0] // 2], *a, **kw)
        single = isinstance(outs, torch.Tensor)
        res = []
        for o in ((outs,) if single else outs):
            pad = torch.full((x.shape[0] - o.shape[0],) + o.shape[1:], fill,
                             dtype=o.dtype, device=o.device)
            res.append(torch.cat([o, pad]))
        return res[0] if single else tuple(res)
    return broken


def _vit_altered(fn):
    """One frame's best logit raised by half its frame's spread."""
    def broken(model, x, *a, **kw):
        y = fn(model, x, *a, **kw).clone()
        y[0, y[0].argmax()] += 0.5 * float(y[0].std())
        return y
    return broken


@pytest.mark.parametrize("cell,target,fault", [
    ("vit.device", "vit_apply", lambda fn: _half_batch(fn, 0.0)),
    ("vit.device", "vit_apply", _vit_altered),
], ids=["vit-half-batch", "vit-answer-altered"])
def test_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, target,
                                          fault):
    sound = tiny(cell)
    assert sound["correct"] is True
    monkeypatch.setattr(port_models, target,
                        fault(getattr(port_models, target)))
    broken = tiny(cell)
    assert broken["correct"] is False
    assert any(c["value"] > c["limit"] for c in broken["checks"].values())


@pytest.mark.parametrize("cell", ["vit.device"])
def test_control_is_not_correct(tiny, cell):
    """The reference with float8 operands in the program's place fails
    one of the cell's limits, on three seeds."""
    from portbench import calibrate, harness

    c = harness.resolve(tiny.spec, cell,
                        traffic_dir=harness.BENCH / "tests" / "data")
    for seed in (1, 2, 3):
        numbers = calibrate.control_numbers(c, seed, torch.device("cpu"))
        assert any(numbers[k] > lim for k, lim in c.cfg["limits"].items())
