"""The port's ``nns:<kind>:<name>`` spans (``utils/profile.py``): they
open while any ``torch.profiler`` session records, on every thread of a
pipeline, and cost a shared null context with no session; the ViT's
layers and dense products each run under their own span, with the same
outputs bit for bit whether a session records or not."""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as _tap

from nnstreamer_tpu_torch.filters import register_model, unregister_model
from nnstreamer_tpu_torch.models import vit as tvit
from nnstreamer_tpu_torch.runtime import parse_launch
from nnstreamer_tpu_torch.utils import profile as uprofile

STREAM = ("device_src name=src spec=4:2 num-buffers=4 ! "
          "tensor_transform name=norm mode=arithmetic option=mul:2.0 ! "
          "appsink name=out max-buffers=8")

VIT_SPANS = {f"nns:vit:{k}" for k in ("embed", "ln", "attn", "gelu",
                                      "residual", "head")} | \
    {f"nns:dense:{k}" for k in ("weights", "gemm", "bias")}


def _spans(trace):
    """(name, tid) of every ``nns:`` span of a Chrome trace."""
    return [(e["name"], e["tid"]) for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("name", "").startswith("nns:")]


def _export(prof, tmp_path):
    path = os.path.join(str(tmp_path), "foreign.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


def _drain(p):
    """Run ``p`` to its end; the buffers its sink ``out`` holds."""
    got = []
    with p:
        assert p.wait_eos(timeout=60)
        while (buf := p["out"].pull(timeout=0)) is not None:
            got.append(buf)
    return got


def _run_stream(desc=STREAM):
    return _drain(parse_launch(desc, device="cpu"))


def _on_streaming_thread(spans):
    """The element spans, all on one thread other than this one."""
    main = threading.get_native_id()
    creates = {t for n, t in spans if n == "nns:create:src"}
    chains = {t for n, t in spans if n == "nns:chain:norm"}
    assert creates and chains, spans
    assert creates == chains and main not in creates
    return sum(1 for n, _ in spans if n == "nns:chain:norm")


def test_pipeline_trace_records_the_streaming_thread(tmp_path):
    with uprofile.pipeline_trace(str(tmp_path)):
        got = _run_stream()
    assert len(got) == 4
    with open(tmp_path / uprofile.TRACE_FILE) as f:
        spans = _spans(json.load(f))
    assert _on_streaming_thread(spans) == 4
    # the sink's chain is spanned on the same thread, no fence on the
    # CPU (no card event to wait for)
    assert any(n == "nns:chain:out" for n, _ in spans)


def test_foreign_all_thread_session_records_the_spans(tmp_path):
    """A session the port did not open sees the element threads' spans
    too: the spans follow the process-wide flag, not a private one."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        _run_stream()
    assert _on_streaming_thread(_spans(_export(prof, tmp_path))) == 4


def test_pipeline_trace_refuses_to_overlap_another_session(tmp_path):
    """Two sessions that overlap can crash the process: the port's own
    session does not start while another records, and the gate
    reopens."""
    from torch.profiler import ProfilerActivity, profile

    holds = uprofile.GATE.holds
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="already recording"):
            with uprofile.pipeline_trace(str(tmp_path)):
                pass
    assert uprofile.GATE.holds == holds + 1
    with uprofile.GATE.inside():
        pass
    assert not (tmp_path / uprofile.TRACE_FILE).exists()


def test_no_session_returns_the_shared_null_context():
    assert not _tap._is_profiler_enabled
    assert uprofile.span("chain", "x") is uprofile.NULL_SPAN
    assert uprofile.span("invoke", "x", []) is uprofile.NULL_SPAN
    assert uprofile.step_marker("train", 3) is uprofile.NULL_SPAN
    assert uprofile.frame_annotation(["a-1"]) is uprofile.NULL_SPAN
    with uprofile.span("chain", "x") as entered:
        assert entered is None
    assert not hasattr(uprofile, "trace_active")
    assert not hasattr(uprofile, "_active")


def test_span_names_and_the_frames_span_inside_the_dispatch(tmp_path):
    """While a session records: ``nns:<kind>:<name>``, and a dispatch
    whose buffers carry sampled trace ids gets ``nns:frames:<ids>``
    inside its ``nns:invoke`` span."""
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.obs.tracer import TRACE_META_KEY

    sampled = Buffer.of(np.zeros(2, np.float32))
    sampled.meta[TRACE_META_KEY] = {"id": "ab-7"}
    plain = Buffer.of(np.zeros(2, np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert uprofile.span("chain", "x") is not uprofile.NULL_SPAN
        with uprofile.span("invoke", "net", [plain, sampled]):
            torch.ones(2).add_(1)
        with uprofile.span("invoke", "one", plain):
            pass
    evs = {e["name"]: e for e in _export(prof, tmp_path)["traceEvents"]
           if e.get("name", "").startswith("nns:")}
    assert set(evs) == {"nns:invoke:net", "nns:frames:ab-7",
                        "nns:invoke:one"}
    outer, inner = evs["nns:invoke:net"], evs["nns:frames:ab-7"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _tiny_vit(dtype):
    torch.manual_seed(0)
    model = tvit.vit_init(3, image_size=32, patch=8, dim=64, depth=2,
                          heads=2, mlp_dim=128, num_classes=10)
    x = torch.rand(2, 32, 32, 3) * 255.0
    return model, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_vit_layers_each_run_under_their_span(tmp_path, dtype):
    """Every layer span and every dense span is recorded, the ``ln``
    span once a layer norm (two a block, and ``ln_f``), and the logits
    are bit-equal with a session recording and without."""
    from torch.profiler import ProfilerActivity, profile

    model, x = _tiny_vit(dtype)
    with torch.inference_mode():
        plain = tvit.vit_apply(model, x, dtype)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = tvit.vit_apply(model, x, dtype)
        again = tvit.vit_apply(model, x, dtype)
    names = [n for n, _ in _spans(_export(prof, tmp_path))]
    assert set(names) == VIT_SPANS
    assert names.count("nns:vit:ln") == 2 * 2 + 1
    assert names.count("nns:vit:residual") == 2 * 2
    assert names.count("nns:dense:gemm") == 4 * 2 + 1
    assert torch.equal(plain, traced) and torch.equal(plain, again)


def test_vit_pipeline_spans_every_dispatch_stage(tmp_path):
    """A transform → ViT filter → sink pipeline on the CPU: the fused
    prologue, the dispatch, the first dispatch's stats sample and the
    model's layers are spanned inside the filter's chain, and its
    results equal an unspanned run's."""
    model, _ = _tiny_vit(torch.bfloat16)
    register_model("spans_vit", lambda m, x: tvit.vit_apply(m, x),
                   params=model, in_shapes=[(2, 32, 32, 3)],
                   in_dtypes=np.float32)
    frames = [np.random.default_rng(i).integers(0, 256, (2, 32, 32, 3),
                                                dtype=np.uint8)
              for i in range(2)]
    desc = ("device_src name=src num-buffers=3 ! "
            "tensor_transform name=norm mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter name=net framework=torch-cuda model=spans_vit ! "
            "appsink name=out max-buffers=8")

    def run():
        p = parse_launch(desc, device="cpu")
        p["src"].frames = frames
        p["src"].pool_size = len(frames)
        return [b.tensors[0].torch().clone() for b in _drain(p)]

    try:
        plain = run()
        with uprofile.pipeline_trace(str(tmp_path)):
            traced = run()
    finally:
        unregister_model("spans_vit")
    assert len(plain) == len(traced) == 3
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    with open(tmp_path / uprofile.TRACE_FILE) as f:
        spans = _spans(json.load(f))
    names = {n for n, _ in spans}
    assert {"nns:create:src", "nns:chain:net", "nns:invoke:net",
            "nns:prologue:net", "nns:stats_sync:net"} <= names
    assert VIT_SPANS <= names
    # the dispatches run on the streaming thread (the program's schema
    # call on zeros runs where the pipeline starts)
    streaming = {t for n, t in spans if n.startswith(("nns:chain:",
                                                      "nns:invoke:",
                                                      "nns:create:"))}
    assert len(streaming) == 1 and threading.get_native_id() not in streaming
    assert sum(1 for n, t in spans
               if n == "nns:invoke:net" and t in streaming) == 3
