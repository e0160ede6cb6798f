from torch_replay import replay
replay("test_watch.py", globals())


# -- the port's default rule pack is the JAX package's -----------------------

import dataclasses as _dc  # noqa: E402

import nnstreamer_tpu.obs.watch as _jw  # noqa: E402
import nnstreamer_tpu_torch.obs.watch as _tw  # noqa: E402


def test_default_rules_equal_the_jax_pack_field_for_field():
    jr, tr = _jw.default_rules(), _tw.default_rules()
    assert [r.name for r in tr] == [r.name for r in jr]
    for a, b in zip(tr, jr):
        assert _dc.asdict(a) == _dc.asdict(b), a.name
    assert _tw.KNOWN_FAMILIES == _jw.KNOWN_FAMILIES


def test_rules_file_reads_the_same_in_both_packages(tmp_path):
    """A rules file written for the JAX package parses to the same
    rules in the port."""
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rule": [
        {"name": "p99", "kind": "threshold",
         "metric": "nns_admission_latency_seconds", "signal": "p99",
         "op": ">", "value": 0.05, "for": "500ms"},
        {"name": "surge", "kind": "forecast",
         "metric": "nns_pool_frames_total", "op": ">=", "value": 500.0,
         "horizon": "30s"},
        {"name": "burn", "kind": "slo_burn",
         "metric": "nns_admission_latency_seconds", "fast": "5s",
         "slow": "60s", "budget": 0.01, "burn": 4.0}]}))
    jr, tr = _jw.load_rules(str(path)), _tw.load_rules(str(path))
    assert [_dc.asdict(r) for r in tr] == [_dc.asdict(r) for r in jr]
