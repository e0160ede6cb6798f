"""The port's model lifecycle (``runtime/lifecycle.py`` on the serving
pool, ``TorchCudaFilter.prepare_swap``/``commit_swap``) and its persistent
kernel cache (``runtime/compilecache.py`` + ``ops/build.py``), on the CPU.

The lifecycle cases replay those of the JAX package's
``tests/test_lifecycle.py`` whose code is ported; each test names the JAX
test it mirrors.  Models are ``x + 1`` (v0) and ``x + 3`` (v2) on f32
zeros, so every value is exact: a frame served by the wrong version reads
1.0 where 3.0 was due.  Port-only cases: the shadow's fold verdicts taken
on distinct frames and carried across the flip, a swap under concurrent
streams (each stream switches once and never goes back), the full-swap
rollback, the per-frame pooled canary, ``custom=donate``, a canary
declaration conflict, the ViT weights-file swap, and ``chip_smoke.py``'s
lifecycle phase run at a small width on the CPU.

The kernel cache runs with a stub compiler (a script that answers
``--version`` and writes a marker library) and a stub loader (which
refuses any file without the marker), since there is no ``nvcc`` here:
the key, the counting, corrupt-entry removal and rebuild, and the
unwritable-directory warning.  The JAX package's compile-cache tests are
not an oracle here (two of them fail on this tree).
"""

import hashlib
import json
import logging
import os
import stat
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.core.buffer import DonatedTensorError
from nnstreamer_tpu_torch.elements.basic import AppSink, AppSrc, Queue
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.filters import (
    TorchCudaFilter,
    register_filter,
    register_model,
    unregister_model,
)
from nnstreamer_tpu_torch.filters.api import (
    FilterError,
    FilterProps,
    FilterSubplugin,
)
from nnstreamer_tpu_torch.models import params_io, vit
from nnstreamer_tpu_torch.ops import build
from nnstreamer_tpu_torch.runtime import Pipeline, compilecache
from nnstreamer_tpu_torch.runtime.events import Event, EventKind, MessageKind
from nnstreamer_tpu_torch.runtime.lifecycle import (
    MIN_CANARY_FRAMES,
    LifecycleError,
)
from nnstreamer_tpu_torch.runtime.serving import MODEL_POOL, PoolConflictError

SHAPE = (4,)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _models():
    register_model("_t_tlc", lambda x: x + 1.0, in_shapes=[SHAPE],
                   in_dtypes=np.float32)
    register_model("_t_tlc_v2", lambda x: x + 3.0, in_shapes=[SHAPE],
                   in_dtypes=np.float32)
    yield
    for n in ("_t_tlc", "_t_tlc_v2"):
        unregister_model(n)


@pytest.fixture(autouse=True)
def _clean_pool():
    yield
    MODEL_POOL.clear()


@register_filter
class _NoReloadFilter(TorchCudaFilter):
    """torch-cuda with the ABI's default (refusing) hot-reload pair."""
    NAME = "torch-cuda-noreload"
    prepare_swap = FilterSubplugin.prepare_swap
    commit_swap = FilterSubplugin.commit_swap


def _pool_pipe(name, batch=4, canary="", timeout_ms=2.0, model="_t_tlc",
               framework="torch-cuda", custom="", updatable=True):
    spec = TensorsSpec.from_shapes([SHAPE], np.float32)
    p = Pipeline(name=name, device="cpu")
    src = AppSrc(name="src", spec=spec, max_buffers=64)
    q = Queue(name="q", max_size_buffers=64)
    flt = TensorFilter(name="net", framework=framework, model=model,
                       batch=batch, batch_timeout_ms=timeout_ms,
                       batch_buckets=str(batch), share_model=True,
                       is_updatable=updatable, canary=canary, custom=custom,
                       stat_sample_interval_ms=10.0)
    sink = AppSink(name="sink", max_buffers=256)
    p.add(src, q, flt, sink).link(src, q, flt, sink)
    return p, {"src": src, "q": q, "flt": flt, "sink": sink}


def _push_n(src, n, start=0):
    for i in range(n):
        src.push_buffer(Buffer.of(np.zeros(SHAPE, np.float32),
                                  pts=start + i), timeout=2.0)


def _pull_all(sink, expect, timeout=10.0):
    out, deadline = [], time.monotonic() + timeout
    while len(out) < expect and time.monotonic() < deadline:
        b = sink.pull(timeout=0.2)
        if b is not None:
            out.append(b)
    return out


def _vals(bufs):
    return [float(np.asarray(b.tensors[0].np()).ravel()[0]) for b in bufs]


def _errors_of(p):
    errors = []
    p.bus.add_watch(lambda m: errors.append(m)
                    if m.kind == MessageKind.ERROR else None)
    return errors


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _sp(model="_t_tlc", **kw):
    sp = TorchCudaFilter()
    sp.configure(FilterProps(framework="torch-cuda", model=model,
                             device=CPU, **kw))
    return sp


# -- prepare/commit swap (framework level) ------------------------------------


def test_prepare_swap_builds_warm_shadow_and_commit_flips():
    """Mirrors test_prepare_swap_builds_warm_shadow_and_commit_flips: the
    old model serves until the flip; the shadow's verdicts (taken on two
    different seeded frames, not zeros) come across, so the first
    post-flip window at the hot bucket is a verdict hit."""
    sp = _sp()
    x = torch.ones(SHAPE)
    sp.invoke_batched([[x]] * 2, 2)
    assert sp.hot_buckets() == ()  # two equal frames leave it open
    sp.invoke_batched([[x], [x + 1]], 2)
    assert sp.hot_buckets() == (2,)
    shadow = sp.prepare_swap("_t_tlc_v2")
    assert shadow._batch_fold == {(shadow._program.in_spec, 2): True}
    assert float(sp.invoke([x])[0][0]) == 2.0  # old model still serves
    sp.commit_swap(shadow)
    assert float(sp.invoke([x])[0][0]) == 4.0
    misses = sp.batch_cache_misses
    outs = sp.invoke_batched([[x]] * 2, 2)
    assert float(outs[0][0][0]) == 4.0
    assert sp.batch_cache_misses == misses  # the verdict came across
    assert sp.model_name() == "_t_tlc_v2"
    sp.close()


def test_prepare_swap_rejects_output_schema_change():
    """Mirrors test_prepare_swap_rejects_output_schema_change."""
    register_model("_t_tlc_wide", lambda x: torch.cat([x, x]),
                   in_shapes=[SHAPE], in_dtypes=np.float32)
    try:
        sp = _sp()
        with pytest.raises(FilterError, match="output schema"):
            sp.prepare_swap("_t_tlc_wide")
        assert float(sp.invoke([torch.zeros(SHAPE)])[0][0]) == 1.0
        sp.close()
    finally:
        unregister_model("_t_tlc_wide")


def test_weights_only_swap_from_params_pytree():
    """Mirrors test_weights_only_swap_from_params_pytree; a weights-only
    shadow keeps the architecture's verdicts."""
    def apply(params, x):
        return x + params["b"]

    register_model("_t_tlc_params", apply, params={"b": np.float32(1.0)},
                   in_shapes=[SHAPE], in_dtypes=np.float32)
    try:
        sp = _sp("_t_tlc_params")
        x = torch.zeros(SHAPE)
        assert float(sp.invoke([x])[0][0]) == 1.0
        sp.invoke_batched([[x], [x + 1]], 2)
        shadow = sp.prepare_swap({"b": np.float32(9.0)}, warm=False)
        assert shadow._batch_fold == sp._batch_fold
        sp.commit_swap(shadow)
        assert float(sp.invoke([x])[0][0]) == 9.0
        assert sp.model_name() == "_t_tlc_params@weights"
        sp.close()
    finally:
        unregister_model("_t_tlc_params")


def test_reload_event_on_a_lone_instance():
    sp = _sp(is_updatable=True)
    sp.handle_event(Event.reload_model("_t_tlc_v2"))
    assert float(sp.invoke([torch.zeros(SHAPE)])[0][0]) == 3.0
    sp.close()
    sp = _sp()
    with pytest.raises(FilterError, match="not updatable"):
        sp.handle_event(Event.reload_model("_t_tlc_v2"))
    sp.close()


# -- live pool hot swap -------------------------------------------------------


def test_pool_reload_hot_swaps_with_no_frame_loss():
    """Mirrors test_pool_reload_hot_swaps_with_no_frame_loss."""
    p, e = _pool_pipe("tlc-swap")
    p.start()
    try:
        entry = e["flt"].pool
        _push_n(e["src"], 8)
        assert _vals(_pull_all(e["sink"], 8)) == [1.0] * 8
        assert not entry.lifecycle.engaged  # built, not yet used
        res = entry.reload_model("_t_tlc_v2", version="v2")
        assert entry.lifecycle.engaged
        assert res["version"] == "v2"
        lc = entry.lifecycle
        assert lc.swaps == 1 and lc.baseline.tag == "v2"
        assert lc.last_swap_stall_s < 1.0
        _push_n(e["src"], 8, start=100)
        swapped = _pull_all(e["sink"], 8)
        assert len(swapped) == 8 and _vals(swapped) == [3.0] * 8
        assert any(ev["event"] == "swap" and ev["version"] == "v2"
                   for ev in lc.history)
    finally:
        p.stop()
    assert len(MODEL_POOL) == 0


def test_swap_under_concurrent_streams_switches_each_stream_once():
    """Port only: RELOAD while four streams push; no frame lost, pts in
    order, every stream reads v0 then v2 and never goes back, and every
    window was all one version."""
    pipes = [_pool_pipe(f"tlc-live-{i}") for i in range(4)]
    for p, _ in pipes:
        p.start()
    try:
        n = 40
        threads = [threading.Thread(target=_push_n, args=(e["src"], n))
                   for _p, e in pipes]
        for t in threads:
            t.start()
        pipes[0][1]["flt"].handle_event(None, Event(
            EventKind.RELOAD_MODEL, data={"model": "_t_tlc_v2",
                                          "version": "v2"}))
        for t in threads:
            t.join()
        for _p, e in pipes:
            got = _pull_all(e["sink"], n)
            assert [b.pts for b in got] == list(range(n))
            vals = _vals(got)
            k = vals.index(3.0) if 3.0 in vals else n
            assert vals == [1.0] * k + [3.0] * (n - k)
        lc = pipes[0][1]["flt"].pool.lifecycle
        assert lc.swaps == 1
        # windows are version-homogeneous: each version's dispatches
        # account for whole windows of frames
        rows = {r["version"]: r for r in lc.snapshot_rows()}
        assert rows["v2"]["frames"] > 0
    finally:
        for p, _ in pipes:
            p.stop()


def test_reload_event_routes_through_pool_and_respects_updatable():
    """Mirrors test_reload_event_routes_through_pool_and_respects_updatable."""
    p, e = _pool_pipe("tlc-evt")
    p.start()
    try:
        e["flt"].handle_event(None, Event(
            EventKind.RELOAD_MODEL, data={"model": "_t_tlc_v2",
                                          "version": "ev2"}))
        lc = e["flt"].pool.lifecycle
        assert lc.baseline.tag == "ev2" and lc.swaps == 1
    finally:
        p.stop()


def test_reload_event_not_updatable_posts_error():
    """Mirrors test_reload_event_not_updatable_posts_error."""
    p, e = _pool_pipe("tlc-noupd", updatable=False)
    errors = _errors_of(p)
    p.start()
    try:
        e["flt"].handle_event(None, Event.reload_model("_t_tlc_v2"))
        assert _wait(lambda: errors), "no not-updatable error on the bus"
        assert "not updatable" in str(errors[0].error)
        lc = e["flt"].pool._lifecycle
        assert lc is None or lc.swaps == 0
    finally:
        p.stop()


def test_reload_errors_land_on_the_bus():
    """A missing model file and a framework without hot reload post to
    the bus; the pool keeps serving its version."""
    p, e = _pool_pipe("tlc-bad")
    errors = _errors_of(p)
    p.start()
    try:
        e["flt"].handle_event(None, Event.reload_model(
            "file:///nonexistent/vit.safetensors@v1"))
        assert _wait(lambda: errors)
        _push_n(e["src"], 4)
        assert _vals(_pull_all(e["sink"], 4)) == [1.0] * 4
    finally:
        p.stop()
    p, e = _pool_pipe("tlc-noreload", framework="torch-cuda-noreload")
    errors = _errors_of(p)
    p.start()
    try:
        e["flt"].handle_event(None, Event.reload_model("_t_tlc_v2"))
        assert _wait(lambda: errors)
        assert "no hot reload" in str(errors[0].error)
    finally:
        p.stop()


# -- canary routing -----------------------------------------------------------


def _canary_rig(n_pipes=4, canary="next:1/2", batch=4):
    pipes = []
    for i in range(n_pipes):
        p, e = _pool_pipe(f"tlc-can-{i}", batch=batch, canary=canary)
        p.start()
        pipes.append((p, e))
    return pipes


def test_canary_routes_1_in_n_streams_with_per_version_fifo():
    """Mirrors test_canary_routes_1_in_n_streams_with_per_version_fifo."""
    pipes = _canary_rig(n_pipes=4, canary="next:1/2")
    try:
        entry = pipes[0][1]["flt"].pool
        res = entry.reload_model("_t_tlc_v2", version="v2")
        assert res == {"version": "v2", "n": 2, "streams": 2}
        lc = entry.lifecycle
        assert lc.canary_active and lc.canary_n == 2
        n = 12
        threads = [threading.Thread(target=_push_n, args=(e["src"], n))
                   for _p, e in pipes]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        canary_streams = []
        for i, (_p, e) in enumerate(pipes):
            got = _pull_all(e["sink"], n)
            assert len(got) == n
            assert [b.pts for b in got] == sorted(b.pts for b in got)
            vals = set(_vals(got))
            assert vals in ({1.0}, {3.0})
            if vals == {3.0}:
                canary_streams.append(i)
        assert canary_streams == [1, 3]  # attach_seq % 2 == 1
        summary = lc.summary()
        assert summary["canary_streams"] == 2
        assert summary["canary_frames"] == 2 * n
        rows = {r["version"]: r for r in lc.snapshot_rows()}
        assert rows["v2"]["state"] == "canary"
        assert rows["v2"]["frames"] == 2 * n
        assert rows["v0"]["frames"] == 2 * n
        lc.promote(force=True)
        assert not lc.canary_active and lc.baseline.tag == "v2"
    finally:
        for p, _e in pipes:
            p.stop()


def test_canary_rollback_restores_baseline_only_serving():
    """Mirrors test_canary_rollback_restores_baseline_only_serving."""
    pipes = _canary_rig(n_pipes=2, canary="next:1/2")
    try:
        entry = pipes[0][1]["flt"].pool
        entry.reload_model("_t_tlc_v2", version="v2")
        lc = entry.lifecycle
        assert lc.canary_active
        res = lc.rollback()
        assert res["rolled_back"] and res["canary"]
        assert not lc.canary_active and lc.rollbacks == 1
        for _p, e in pipes:
            _push_n(e["src"], 4)
            assert set(_vals(_pull_all(e["sink"], 4))) == {1.0}
    finally:
        for p, _e in pipes:
            p.stop()


def test_full_swap_rollback_swaps_back():
    """Port only: with no canary, rollback flips the retired version
    back in (its program and verdicts kept at the swap)."""
    p, e = _pool_pipe("tlc-undo")
    p.start()
    try:
        lc = e["flt"].pool.lifecycle
        e["flt"].pool.reload_model("_t_tlc_v2", version="v2")
        res = lc.rollback()
        assert res["rolled_back"] and not res["canary"]
        assert lc.baseline.tag == "v0" and lc.swaps == 2
        _push_n(e["src"], 4)
        assert set(_vals(_pull_all(e["sink"], 4))) == {1.0}
        # the undone swap is kept in turn: a second rollback redoes it
        assert lc.rollback()["version"] == "v2"
        _push_n(e["src"], 4, start=10)
        assert set(_vals(_pull_all(e["sink"], 4))) == {3.0}
    finally:
        p.stop()
    p, e = _pool_pipe("tlc-undo-none")
    p.start()
    try:
        with pytest.raises(LifecycleError, match="nothing to roll back"):
            e["flt"].pool.lifecycle.rollback()
    finally:
        p.stop()


def test_declared_canary_tag_gates_the_split():
    """Mirrors test_declared_canary_tag_gates_the_split."""
    pipes = _canary_rig(n_pipes=2, canary="v7:1/2")
    try:
        entry = pipes[0][1]["flt"].pool
        res = entry.reload_model("_t_tlc_v2", version="v9")
        lc = entry.lifecycle
        assert not lc.canary_active  # v9 != v7: direct swap
        assert lc.swaps == 1 and res.get("version") == "v9"
        res = entry.reload_model("_t_tlc", version="v7")
        assert lc.canary_active and res["n"] == 2
    finally:
        for p, _e in pipes:
            p.stop()


def test_promote_refused_before_min_canary_frames():
    """Mirrors test_promote_refused_before_min_canary_frames; then the
    canary serves its frames and promote succeeds."""
    pipes = _canary_rig(n_pipes=2, canary="next:1/2")
    try:
        entry = pipes[0][1]["flt"].pool
        entry.reload_model("_t_tlc_v2")
        lc = entry.lifecycle
        with pytest.raises(LifecycleError, match="frames"):
            lc.promote()
        assert lc.canary_active
        for _p, e in pipes:
            _push_n(e["src"], MIN_CANARY_FRAMES)
            _pull_all(e["sink"], MIN_CANARY_FRAMES)
        res = lc.promote()
        assert res["promoted"] and res["frames"] == MIN_CANARY_FRAMES
        for _p, e in pipes:
            _push_n(e["src"], 4, start=100)
            assert set(_vals(_pull_all(e["sink"], 4))) == {3.0}
    finally:
        for p, _e in pipes:
            p.stop()


def test_canary_error_isolated_to_canary_streams():
    """Mirrors test_canary_error_isolated_to_canary_streams."""
    pipes = _canary_rig(n_pipes=2, canary="next:1/2")
    try:
        entry = pipes[0][1]["flt"].pool
        entry.reload_model("_t_tlc_v2", version="vboom")
        lc = entry.lifecycle

        def boom(*_a, **_k):
            raise RuntimeError("canary exploded")

        lc._canary.subplugin.invoke_batched = boom
        errors = {i: _errors_of(p) for i, (p, _e) in enumerate(pipes)}
        canary_idx = [i for i, (_p, e) in enumerate(pipes)
                      if lc.is_canary_stream(e["flt"])]
        assert canary_idx == [1]
        for _p, e in pipes:
            _push_n(e["src"], 4)
        got = _pull_all(pipes[0][1]["sink"], 4)
        assert len(got) == 4 and set(_vals(got)) == {1.0}
        assert _wait(lambda: errors[1]), "canary bus got no error"
        assert not errors[0], "baseline bus polluted"
        assert lc._canary.errors >= 1 and lc.baseline.errors == 0
        assert lc.summary()["canary_errors"] >= 1
    finally:
        for p, _e in pipes:
            p.stop()


def test_per_frame_pooled_canary_routes_by_stream():
    """Port only: ``batch=1`` pooled streams dispatch per frame; the
    canary still routes 1-in-N of them (``PoolEntry.subplugin_for``)."""
    pipes = _canary_rig(n_pipes=2, canary="1/2", batch=1)
    try:
        pipes[0][1]["flt"].pool.reload_model("_t_tlc_v2")
        for _p, e in pipes:
            _push_n(e["src"], 3)
        assert set(_vals(_pull_all(pipes[0][1]["sink"], 3))) == {1.0}
        assert set(_vals(_pull_all(pipes[1][1]["sink"], 3))) == {3.0}
    finally:
        for p, _e in pipes:
            p.stop()


def test_canary_declaration_conflict_and_grammar():
    p, e = _pool_pipe("tlc-c0", canary="next:1/2")
    p.start()
    try:
        p2, _ = _pool_pipe("tlc-c1", canary="next:1/4")
        with pytest.raises(Exception) as ei:
            p2.start()
        err = ei.value
        while err is not None and not isinstance(err, PoolConflictError):
            err = err.__cause__ or err.__context__
        assert isinstance(err, PoolConflictError), repr(ei.value)
        p2.stop()
    finally:
        p.stop()
    p3, _ = _pool_pipe("tlc-c2", canary="2/3")
    with pytest.raises(Exception):
        p3.start()
    p3.stop()


# -- donation -----------------------------------------------------------------


def test_donate_marks_exactly_the_dispatched_tensors():
    """``custom=donate``: after a pooled window dispatch the tensors the
    window was handed are donated — a retained reference raises."""
    p, e = _pool_pipe("tlc-donate", custom="donate")
    p.start()
    try:
        kept = [Buffer.of(torch.zeros(SHAPE), pts=i) for i in range(4)]
        for b in kept:
            e["src"].push_buffer(b, timeout=2.0)
        assert _vals(_pull_all(e["sink"], 4)) == [1.0] * 4
        for b in kept:
            assert b.tensors[0].is_donated
            with pytest.raises(DonatedTensorError):
                b.tensors[0].torch()
    finally:
        p.stop()


# -- a ViT weights file, swapped ----------------------------------------------

SMALL = dict(image_size=32, patch=8, dim=64, depth=2, mlp_dim=128,
             num_classes=5)


def test_vit_weights_file_swap_matches_new_weights_alone(tmp_path):
    """Two ViT weights files (seeds 0 and 1); a pool serving v0 swaps to
    ``file://…@v1`` and every frame after reads v1's logits alone
    (f32, within 1e-5)."""
    paths = {}
    for seed in (0, 1):
        paths[seed] = str(tmp_path / f"vit_v{seed}.safetensors")
        params_io.save_safetensors(paths[seed], vit.vit_tree(seed, **SMALL),
                                   metadata={
            "apply": "nnstreamer_tpu_torch.models.vit:vit_tree_apply",
            "apply_kwargs": json.dumps({"heads": 2, "dtype": "float32"}),
            "in_shapes": "[[1, 32, 32, 3]]", "in_dtypes": "float32"})
    x = np.random.default_rng(7).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    alone = {}
    for seed, path in paths.items():
        sp = _sp(path)
        alone[seed] = sp.invoke([torch.from_numpy(x)])[0]
        sp.close()
    assert float((alone[0] - alone[1]).abs().max()) > 1e-2
    spec = TensorsSpec.from_shapes([(1, 32, 32, 3)], np.float32)
    p = Pipeline(name="tlc-vit", device="cpu")
    src = AppSrc(name="src", spec=spec, max_buffers=16)
    flt = TensorFilter(name="net", framework="torch-cuda",
                       model=f"file://{paths[0]}@v0", batch=2,
                       batch_buckets="2", share_model=True, is_updatable=True)
    sink = AppSink(name="sink", max_buffers=16)
    p.add(src, flt, sink).link(src, flt, sink)
    with p:
        flt.handle_event(None, Event(EventKind.RELOAD_MODEL, data={
            "model": f"file://{paths[1]}@v1"}))
        lc = flt.pool.lifecycle
        assert lc.baseline.tag == "v1"
        assert lc.baseline.source == f"{paths[1]}@v1"
        for i in range(2):
            src.push_buffer(Buffer.of(x, pts=i))
        got = _pull_all(sink, 2)
    for b in got:
        torch.testing.assert_close(b.tensors[0].torch(), alone[1],
                                   rtol=1e-5, atol=1e-5)


def test_chip_smoke_lifecycle_phase_logic_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s lifecycle phase (hot swap under 8 streams, the
    canary's routing, rollback and promotion, the weights-only swap), its
    own checks included, at a small width on the CPU: the card runs the
    same code at full width."""
    import functools

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from nnstreamer_tpu_torch.filters.torch_cuda import ModelDef

    monkeypatch.setattr(cs, "LC_DEVICE", "cpu")
    monkeypatch.setattr(cs, "VIT_SIZE", 32)
    monkeypatch.setattr(cs, "VIT", dict(patch=8, dim=64, depth=2, heads=2,
                                        mlp_dim=128, num_classes=10))
    monkeypatch.setattr(cs, "SERVE_POOL", 4)
    monkeypatch.setattr(cs, "LC_BEFORE", 64)
    monkeypatch.setattr(cs, "LC_AFTER", 64)
    monkeypatch.setattr(cs, "LC_ROUND", 8)
    files = [cs.write_vit_file(str(tmp_path / f"v{v}.safetensors"), v)
             for v in (0, 1)]
    g = torch.Generator().manual_seed(6)
    pools = [[torch.randint(0, 256, (1, 32, 32, 3), generator=g,
                            dtype=torch.uint8) for _ in range(4)]
             for _ in range(cs.SERVE_STREAMS)]
    tree2 = vit.vit_tree(2, image_size=32, patch=8, dim=64, depth=2,
                         mlp_dim=128, num_classes=10)
    w2 = ModelDef(functools.partial(vit.vit_tree_apply, heads=2), tree2,
                  TensorsSpec.from_shapes([(1, 32, 32, 3)], np.float32))
    refs = {"v0": cs.alone_logits(files[0], pools),
            "v1": cs.alone_logits(files[1], pools),
            "w2": cs.alone_logits(w2, pools)}
    swap = cs.lc_hot_swap(pools, refs, files, "cpu", "-")
    assert swap["verdict_misses_after_flip"] == 0
    assert swap["max_abs_diff"] <= cs.SERVE_TOL
    canary = cs.lc_canary(pools, refs, files, tree2, "cpu", "-")
    assert (canary["swaps"], canary["promotes"], canary["rollbacks"]) == \
        (2, 1, 1)
    assert 16 in canary["buckets_reached"]


# -- the persistent kernel cache ----------------------------------------------


def _replace(path, data: bytes) -> None:
    """Put ``data`` at ``path`` as a new file, as a torn copy would land:
    a library this process mapped keeps its own (intact) file."""
    tmp = path.with_suffix(".new")
    tmp.write_bytes(data)
    os.replace(tmp, path)


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """``ops/build.py`` with a stub compiler and loader, a fresh process's
    state, and the default directory under ``tmp_path``."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import hashlib, sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "if sys.argv[1:] == ['--version']:\n"
        "    print('stub nvcc, release 0.1')\n"
        "    sys.exit(0)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "src = open(sys.argv[-1], 'rb').read()\n"
        "open(out, 'wb').write(b'LIB:' + hashlib.sha256(src).digest() * 64)\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)

    def loader(path):
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(b"LIB:") or len(data) != 4 + 32 * 64:
            raise OSError(f"{path}: invalid ELF header")
        return ("lib", path)

    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "_cdll", loader)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "default")

    def fresh_process():
        monkeypatch.setattr(build, "_loaded", {})
        monkeypatch.setattr(build, "_nvcc_versions", {})
        monkeypatch.setattr(build, "nvcc_runs", 0)
        monkeypatch.setattr(build, "build_logs", {})
        compilecache.CACHE_STATS.reset()

    fresh_process()
    yield fresh_process, log
    compilecache.CACHE_STATS.reset()


def test_cache_key_covers_source_flags_compiler_and_arch():
    base = compilecache.make_key("src", ("-O3",), "nvcc 12.4", "sm_90a")
    assert len(base) == 64 and base == compilecache.make_key(
        "src", ("-O3",), "nvcc 12.4", "sm_90a")
    for other in (("src2", ("-O3",), "nvcc 12.4", "sm_90a"),
                  ("src", ("-O2",), "nvcc 12.4", "sm_90a"),
                  ("src", ("-O3",), "nvcc 12.5", "sm_90a"),
                  ("src", ("-O3",), "nvcc 12.4", "sm_100a")):
        assert compilecache.make_key(*other) != base


def test_cache_unset_keeps_the_default_directory(stub_build, monkeypatch):
    fresh, log = stub_build
    monkeypatch.delenv(compilecache.CACHE_ENV, raising=False)
    paths = build.build_all()
    for name, path in paths.items():
        h = hashlib.sha256((build.CSRC / build.SOURCES[name]).read_bytes())
        h.update(" ".join(build.NVCC_FLAGS).encode())
        assert path == build.BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        assert path.is_file()
    assert build.nvcc_runs == len(build.SOURCES)  # no --version without
    # the cache
    assert compilecache.CACHE_STATS.snapshot() == {
        "hits": 0, "misses": 0, "stores": 0, "errors": 0}
    fresh()
    build.build_all()
    assert build.nvcc_runs == 0  # reused from the default directory


def test_cache_hits_and_counts_across_processes(stub_build, tmp_path,
                                                monkeypatch):
    fresh, log = stub_build
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv(compilecache.CACHE_ENV, str(cache))
    paths = build.build_all()
    n = len(build.SOURCES)
    assert compilecache.CACHE_STATS.snapshot() == {
        "hits": 0, "misses": n, "stores": n, "errors": 0}
    assert build.nvcc_runs == n + 1  # --version once, one build per source
    assert all(p.parent == cache for p in paths.values())
    assert not (tmp_path / "default").exists()
    for name in build.SOURCES:
        assert build.load(name) == ("lib", str(paths[name]))
    assert compilecache.CACHE_STATS.snapshot()["hits"] == 0  # no recount
    fresh()  # a second process on the warm cache: no nvcc at all
    runs_before = len(log.read_text().splitlines())
    assert build.build_all() == paths
    assert compilecache.CACHE_STATS.snapshot() == {
        "hits": n, "misses": 0, "stores": 0, "errors": 0}
    assert build.nvcc_runs == 0
    assert len(log.read_text().splitlines()) == runs_before
    assert build.load("flash_attention") == ("lib",
                                             str(paths["flash_attention"]))


def test_cache_truncated_or_foreign_entry_is_an_error_and_rebuilt(
        stub_build, tmp_path, monkeypatch):
    fresh, _log = stub_build
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv(compilecache.CACHE_ENV, str(cache))
    paths = build.build_all()
    lib = paths["flash_attention"]
    _replace(lib, lib.read_bytes()[:100])  # truncated
    fresh()
    build.build_all()
    assert compilecache.CACHE_STATS.snapshot() == {
        "hits": len(build.SOURCES) - 1, "misses": 1, "stores": 1,
        "errors": 1}
    assert build.nvcc_runs == 1  # the one rebuild
    assert build.load("flash_attention") == ("lib", str(lib))
    # bytes that match their digest but do not load (another arch)
    bad = b"ELF-for-another-card"
    _replace(lib, bad)
    build._store_digest(lib, bad)
    fresh()
    build.build_all(["flash_attention"])
    assert compilecache.CACHE_STATS.snapshot() == {
        "hits": 0, "misses": 1, "stores": 1, "errors": 1}
    assert lib.read_bytes().startswith(b"LIB:")


def test_cache_unwritable_dir_warns_once_and_builds_default(
        stub_build, tmp_path, monkeypatch, caplog):
    fresh, _log = stub_build
    missing = tmp_path / "missing"
    monkeypatch.setenv(compilecache.CACHE_ENV, str(missing))
    with caplog.at_level(logging.WARNING, logger="nnstreamer_tpu_torch"):
        assert compilecache.cache_dir() is None
        assert not compilecache.enabled()
        paths = build.build_all()
        build.build_all()
    warned = [r for r in caplog.records if str(missing) in r.getMessage()]
    assert len(warned) == 1
    assert all(p.parent == tmp_path / "default" and p.is_file()
               for p in paths.values())
    assert compilecache.CACHE_STATS.snapshot()["stores"] == 0
