"""The span readers (``spans.py``, ``metrics/{ln,epilogue,gemm}_ms_per_window``,
``metrics/unspanned_device_pct``): a fixture Chrome trace
(``data/spans_trace.json``: kernels, runtime launches with their
``correlation`` and thread, spans nested on two threads) reduced by
hand; no value without the program's spans; the six readers of the
first stretch unmoved by spans in the trace; the second stretch set up
and traced on the CPU; and, on a card, a small ViT's kernels all under
a leaf span."""

import copy
import dataclasses
import json
import time
from pathlib import Path

import pytest

from portbench import harness, spans, trace

DATA = Path(__file__).resolve().parent / "data"
NEW = ("ln_ms_per_window", "epilogue_ms_per_window", "gemm_ms_per_window",
       "unspanned_device_pct")
OLD = ("step_mfu", "device_ms_per_window", "attn_roofline_pct",
       "prologue_roofline_pct", "device_idle_pct", "kernels_per_window")

# the fixture by hand, in µs of kernel time inside the stretch (two
# windows): a kernel straddling either edge counts the part inside
BY_SPAN = {"nns:prologue:net": 10.0, "nns:vit:ln": 40.0 + 10.0,
           "nns:dense:gemm": 100.0 + 40.0, "nns:dense:bias": 20.0,
           "nns:vit:gelu": 20.0, "nns:vit:residual": 30.0,
           "nns:vit:head": 10.0}
# a launch in a container alone, a kernel with no launch record, and a
# launch before any span
UNSPANNED = 10.0 + 20.0 + 10.0
WANT = {"ln_ms_per_window": 50.0 / 1e3 / 2,
        "epilogue_ms_per_window": (20.0 + 20.0 + 30.0) / 1e3 / 2,
        "gemm_ms_per_window": 140.0 / 1e3 / 2,
        "unspanned_device_pct": 100.0 * UNSPANNED / 320.0}


def _fixture():
    with open(DATA / "spans_trace.json") as f:
        return json.load(f)


def _without(doc, drop):
    out = copy.deepcopy(doc)
    out["traceEvents"] = [e for e in out["traceEvents"] if not drop(e)]
    return out


def _is_span(e):
    return e.get("cat") == "user_annotation" \
        and e.get("name", "").startswith("nns:")


@dataclasses.dataclass
class _Run:
    spans: object


def _read(summary):
    run = _Run(summary)
    return {m: harness.reader(m)(run) for m in NEW}


def test_kernel_time_goes_to_the_innermost_leaf_span_of_its_launch():
    s = spans.reduce(_fixture(), 2)
    assert s.spanned and s.windows == 2
    assert s.by_span == BY_SPAN
    assert s.unspanned_us == UNSPANNED
    assert s.kernel_us == 320.0 == sum(s.by_span.values()) + s.unspanned_us


def test_each_reader_reads_the_hand_computed_value():
    got = _read(spans.reduce(_fixture(), 2))
    assert got == pytest.approx(WANT, rel=1e-12)


def test_a_kernel_without_its_launch_counts_as_unspanned():
    doc = _without(_fixture(), lambda e: e.get("cat") == "cuda_runtime"
                   and e.get("args", {}).get("correlation") == 3)
    s = spans.reduce(doc, 2)
    assert s.by_span["nns:dense:gemm"] == 40.0
    assert s.unspanned_us == UNSPANNED + 100.0
    none = spans.reduce(_without(_fixture(),
                                 lambda e: e.get("cat") == "cuda_runtime"), 2)
    assert none.by_span == {} and none.unspanned_us == 320.0
    assert _read(none)["unspanned_device_pct"] == 100.0


def test_readers_read_nothing_without_the_programs_spans():
    s = spans.reduce(_without(_fixture(), _is_span), 2)
    assert not s.spanned and s.kernel_us == 320.0
    assert _read(s) == {m: None for m in NEW}
    assert _read(None) == {m: None for m in NEW}
    assert spans.reduce(_without(
        _fixture(), lambda e: e.get("name") == spans.STRETCH), 2) is None


def test_a_program_without_spans_is_not_set_up_again(monkeypatch):
    monkeypatch.setattr(spans, "_program_spans", lambda: False)
    run = type("R", (), {})()
    logged = []
    assert spans.of(run, log=logged.append) is None
    assert run.spans is None and "no nns: spans" in logged[0]


def test_idle_gaps_are_named_by_the_innermost_span_and_runtime_call():
    s = spans.reduce(_fixture(), 2)
    # the gap at 720 µs: the sampler's wait, not the consumer thread's later one
    assert s.gaps == [
        (720.0, 270.0, "nns:stats_sync:net / cudaDeviceSynchronize"),
        (360.0, 240.0, "nns:invoke:net / no runtime call"),
        (10.0, 90.0, "nns:invoke:net / no runtime call"),
        (650.0, 50.0, "nns:vit:head / no runtime call"),
        (290.0, 10.0, "nns:invoke:net / no runtime call")]


def test_the_six_readers_of_the_first_stretch_read_the_same_values():
    """Spans in the trace move none of them: the same values with the
    program's spans and without, and the trace-based ones by hand."""
    def first(doc):
        doc = copy.deepcopy(doc)
        for e in doc["traceEvents"]:
            if e.get("name") == spans.STRETCH:
                e["name"] = trace.STRETCH
        return trace.summarize(doc, 2)

    spec = harness.load_json(DATA / "tiny_benchmark.json")
    cell = harness.resolve(spec, "vit.device", traffic_dir=DATA)
    window = harness.Window(seconds=2.0, windows=4, frames=8.0,
                            completions=[], latencies_s=[])
    peaks = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e12}

    def read(summary):
        run = harness.Run(cell, cell.cfg, cell.traffic, 2,
                          harness.arch(cell.cfg, "cost"), peaks, 1.0,
                          window, summary)
        return {m: harness.reader(m)(run) for m in OLD}

    with_spans = read(first(_fixture()))
    assert with_spans == read(first(_without(_fixture(), _is_span)))
    assert with_spans["device_ms_per_window"] == pytest.approx(320.0 / 1e3 / 2)
    # wholly inside: every kernel but the two that straddle an edge
    assert with_spans["kernels_per_window"] == 10 / 2
    busy = 10 + 190 + 60 + 50 + 20 + 10
    assert with_spans["device_idle_pct"] == pytest.approx(
        100.0 * (1 - busy / 1000.0))
    assert with_spans["prologue_roofline_pct"] is not None
    assert with_spans["attn_roofline_pct"] is None  # no attention kernel


def _tiny_run(hidden=64, mlp=128):
    spec = harness.load_json(DATA / "tiny_benchmark.json")
    cell = harness.resolve(spec, "vit.device", traffic_dir=DATA)
    cell.cfg = dict(cell.cfg, hidden_size=hidden, mlp_dim=mlp)
    cell.per_layer = cell.per_layer + [
        {"name": m, "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "-", "moves": "frames_per_s"} for m in NEW]
    return cell


def test_the_second_stretch_traces_the_programs_threads_on_the_cpu():
    """The cell set up again and traced through the program's own
    session: its element threads' spans are in the trace; the CPU runs
    no kernel, so no reader gives a value."""
    cell = _tiny_run()
    window = harness.Window(seconds=1.0, windows=2, frames=4.0,
                            completions=[], latencies_s=[])
    run = harness.Run(cell, cell.cfg, cell.traffic, 2,
                      harness.arch(cell.cfg, "cost"), None, 1.0, window)
    logged = []
    s = spans.of(run, device="cpu", log=logged.append)
    assert s is run.spans and s.spanned and s.windows == 2
    assert s.kernel_us == 0.0 and s.by_span == {}
    assert _read(s) == {m: None for m in NEW}
    assert any("second stretch set up" in line for line in logged), logged
    assert spans.of(run) is s  # measured once a run


def test_the_second_stretch_measures_the_card_or_nothing(monkeypatch):
    """Asked for no device, the stretch is the card's: with none present
    it is refused and the readers leave their metrics out, as the timed
    run is refused, rather than measuring the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = _tiny_run()
    window = harness.Window(seconds=1.0, windows=2, frames=4.0,
                            completions=[], latencies_s=[])
    run = harness.Run(cell, cell.cfg, cell.traffic, 2,
                      harness.arch(cell.cfg, "cost"), None, 1.0, window)
    logged = []
    assert spans.of(run, log=logged.append) is None and run.spans is None
    assert any("SetupError: no CUDA card" in line for line in logged), logged


@pytest.mark.cuda
def test_a_small_vit_on_the_card_runs_every_kernel_under_a_leaf_span(card):
    """A traced run of a small ViT (head dim 64, the attention kernel's)
    through the harness: the four readers report, and under 2% of the
    kernel time lies outside a leaf span."""
    cell = _tiny_run(hidden=128, mlp=256)
    harness.use_checkout_caches()
    out = harness.run_cell(cell, 20240601, 1.0, True, time.perf_counter(),
                           device="cuda", log=lambda *a: None)
    assert out["correct"] is True
    got = {m: out["metrics"].get(m, {}).get("value") for m in NEW}
    assert None not in got.values(), got
    assert got["unspanned_device_pct"] < 2.0
    assert got["gemm_ms_per_window"] > 0 and got["ln_ms_per_window"] > 0
