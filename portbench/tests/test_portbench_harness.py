"""The harness: every cell resolves its files by name, a metric file or
a source file dropped in is used with no other edit, a run without a
card fails and prints nothing, and the result line has the contract's
keys, ``checks`` last."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


def _spec():
    return harness.load_json(ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in _spec()["workloads"]])
def test_cell_resolves_every_file_by_name(cell):
    spec = _spec()
    c = harness.resolve(spec, cell)
    for kind in ("models", "reference", "cost"):
        assert harness.arch(c.cfg, kind) is not None
    source = harness.plugin("sources", c.traffic["source"])
    assert callable(source.head) and callable(source.attach)
    assert set(c.cfg["limits"]) and c.traffic["batch"] > 0
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "frames_per_s"}
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))


def test_benchmark_description_keeps_the_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and NAME.match(c["name"])
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    assert {m["source"] for m in spec["end_to_end"]} <= {"host_clock",
                                                         "device_trace"}
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def _copy_plugins(tmp_path):
    """A copy of the benchmark's metric and source modules to drop a new
    one beside."""
    bench = tmp_path / "portbench"
    for kind in ("metrics", "sources"):
        (bench / kind).mkdir(parents=True)
        for f in (harness.BENCH / kind).glob("*.py"):
            (bench / kind / f.name).write_text(f.read_text())
    return bench


def test_a_metric_file_dropped_in_is_read(tiny, tmp_path, monkeypatch):
    bench = _copy_plugins(tmp_path)
    (bench / "metrics" / "windows_seen.py").write_text(
        "def read(run):\n    return float(run.window.windows)\n")
    monkeypatch.setattr(harness, "BENCH", bench)
    tiny.spec["end_to_end"].append(
        {"name": "windows_seen", "unit": "windows", "better": "higher",
         "bound": 0.25, "source": "host_clock"})
    out = tiny("vit.device")
    assert out["metrics"]["windows_seen"]["value"] >= 1


def test_a_source_file_dropped_in_is_used(tiny, tmp_path, monkeypatch):
    """A traffic file naming a new source module runs through it."""
    bench = _copy_plugins(tmp_path)
    (bench / "sources" / "counted_pool.py").write_text(
        "from portbench.sources.device_pool import head\n"
        "def attach(p, frames, traffic):\n"
        "    p['src'].frames = frames\n"
        "    p['src'].pool_size = len(frames)\n"
        "    return lambda: open(traffic['mark'], 'w').write('stopped')\n")
    mark = tmp_path / "mark"
    data = tmp_path / "traffic"
    data.mkdir()
    traffic = harness.load_json(harness.BENCH / "tests" / "data"
                                / "tiny_device.json")
    traffic.update(source="counted_pool", mark=str(mark))
    (data / "tiny_device.json").write_text(json.dumps(traffic))
    monkeypatch.setattr(harness, "BENCH", bench)
    c = harness.resolve(tiny.spec, "vit.device", traffic_dir=data)
    out = harness.run_cell(c, 5, 1.0, False, 0.0, device="cpu",
                           log=lambda *a: None)
    assert out["correct"] is True and mark.read_text() == "stopped"


def test_unknown_source_is_refused(tiny, tmp_path):
    (tmp_path / "tiny_device.json").write_text(json.dumps(
        {"source": "no_such_source", "batch": 2}))
    with pytest.raises(harness.SetupError, match="no source"):
        harness.resolve(tiny.spec, "vit.device", traffic_dir=tmp_path)


@pytest.mark.parametrize("ends,want", [
    ([1.0, 2.0, 3.0, 4.0], 2 * (2 + 0.5)),     # t_b half-way to a window
    ([1.0, 2.0, 3.5, 9.5], 2 * (2 + 0.0)),     # t_b at a completion
    ([1.0, 2.0, 8.0], 2 * (1 + 0.25)),         # a stall over the close
])
def test_window_counts_the_work_under_way_at_its_close(ends, want):
    """The window (1, 3.5]: whole windows completed in it, and of the
    one under way at 3.5 the share of its time inside."""
    assert harness.frames_done(1.0, 3.5, ends, 2) == pytest.approx(want)


def test_result_line_has_the_contract_keys(tiny):
    out = tiny("vit.device")
    assert list(out) == RESULT_KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    for k, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}


def test_traced_run_reports_per_layer_metrics_only(tiny):
    out = tiny("vit.device", trace=True)
    assert out["correct"] is True
    assert set(out["metrics"]) <= {m["name"]
                                   for m in tiny.spec["per_layer"]}
    assert "frames_per_s" not in out["metrics"]


def test_launches_across_the_stretch_edge_count_only_as_busy_time():
    """A kernel that straddles the stretch's start or end adds its part
    inside to the busy time, but is no launch of the rooflines or of
    ``kernels_per_window``: its time is only partly there."""
    from portbench import trace

    events = [{"ph": "X", "name": trace.STRETCH, "ts": 100, "dur": 100,
               "cat": "user_annotation"}]
    events += [{"ph": "X", "name": f"k{i}", "ts": ts, "dur": 20,
                "cat": "kernel"} for i, ts in enumerate((90, 120, 190))]
    s = trace.summarize({"traceEvents": events}, 1)
    assert [e.dur_us for e in s.events] == [10.0, 20.0, 10.0]
    assert s.busy_s == pytest.approx(40e-6)
    assert [e.name for e in s.kernels()] == ["k1"]


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         _spec()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_run_outside_a_checkout_of_the_program_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files there is no program to measure."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         _spec()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_card_run_prints_the_contract_line(card):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         _spec()["workloads"][0]["name"], "--seed", "77", "--seconds", "5",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out) == RESULT_KEYS[:-1] + ["breakdown", "checks"]
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert "attn_roofline_pct" in out["metrics"]
