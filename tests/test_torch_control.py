from torch_replay import replay
replay("test_control.py", globals())


# -- the port alone: packs equal to the JAX package's, the fold guard --------

import dataclasses as _dc  # noqa: E402

import nnstreamer_tpu.obs.control as _jc  # noqa: E402
import nnstreamer_tpu.runtime.actuators as _ja  # noqa: E402
import nnstreamer_tpu_torch.runtime.actuators as _ta  # noqa: E402


def test_default_playbooks_equal_the_jax_pack_field_for_field():
    jp, tp = _jc.default_playbooks(), default_playbooks()
    assert [p.name for p in tp] == [p.name for p in jp]
    for a, b in zip(tp, jp):
        assert _dc.asdict(a) == _dc.asdict(b), a.name
    assert _ta.KNOWN_ACTUATORS == _ja.KNOWN_ACTUATORS


def test_max_batch_actuation_checks_new_buckets_off_the_dispatch_path():
    """A max-batch actuation takes the fold verdict of every bucket the
    new window size can reach before it returns: no window then runs
    an unchecked fold, and no dispatch pays for a check."""
    spec = TensorsSpec.from_shapes([SHAPE], np.float32)
    p = Pipeline(device="cpu", name="ctl-buckets")
    src = AppSrc(name="src", spec=spec, max_buffers=64)
    flt = TensorFilter(name="net", framework="torch-cuda", model="_t_ctl",
                       batch=8, batch_timeout_ms=2.0,
                       batch_buckets="2,4,8", share_model=True)
    sink = AppSink(name="sink", max_buffers=64)
    p.add(src, flt, sink).link(src, flt, sink)
    p.start()
    try:
        entry = flt._pool_entry
        sp = entry.subplugin
        assert sp.hot_buckets() == ()
        (act,) = find_actuators("pool", entry.label(), "max-batch")
        act.actuate(3)
        assert entry.batcher.max_batch == 3
        assert sp.hot_buckets() == (2, 4)
        act.actuate(6, now=1e9)
        assert sp.hot_buckets() == (2, 4, 8)
        misses = sp.batch_cache_misses
        for i in range(24):
            src.push_buffer(Buffer.of(
                np.full(SHAPE, float(i), np.float32), pts=i))
        outs = [sink.pull(timeout=10) for _ in range(24)]
        assert [b.pts for b in outs] == list(range(24))
        for i, b in enumerate(outs):
            np.testing.assert_array_equal(b.tensors[0].np(),
                                          np.full(SHAPE, i + 1.0))
        assert sp.batch_cache_misses == misses
    finally:
        p.stop()
