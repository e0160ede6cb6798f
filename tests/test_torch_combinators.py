"""The scenarios of ``tests/test_combinators.py`` and ``tests/test_sensor.py``
through both packages, on the CPU.

Every test runs three ways (``pkg``): ``jax`` — the JAX package, as the
original tests run it; ``port`` — the port with the same numpy frames
(host tensors); ``port-dev`` — the port with each frame handed over as a
``torch.Tensor``, so the elements take their device paths (``torch.cat``
in ``tensor_merge`` and ``tensor_aggregator``, slicing in
``tensor_split``, the on-device reduction of ``tensor_if``, the fill on
the frame's device) on the CPU.  Values are exact: every assertion is the
original test's.

Covered: tensor_mux and the slowest/refresh/basepad sync policies,
tensor_merge, tensor_demux tensorpick, tensor_split, join,
tensor_aggregator (batching, sliding window, frames-in > frames-out,
concat=false caps), tensor_if (average threshold, FILL_ZERO, a custom
callback, a range operator with REPEAT_PREVIOUS_FRAME), tensor_rate
(down- and up-sampling, the previous frame in gap slots), a
tensor_reposrc/reposink feedback loop, tensor_sparse_enc/dec, tensor_crop,
caps with scalar dimensions; tensor_src_sensor against a mock IIO sysfs
tree (scale and offset, raw mode, channel enables and lists, one tensor
per channel, the device's sampling frequency, a missing directory) and a
registered callback sensor.
"""

from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nnstreamer_tpu.core as jcore
import nnstreamer_tpu.core.buffer as jbuffer
import nnstreamer_tpu.elements.basic as jbasic
import nnstreamer_tpu.elements.condition as jcondition
import nnstreamer_tpu.elements.repo as jrepo
import nnstreamer_tpu.elements.sensorsrc as jsensor
import nnstreamer_tpu.elements.sync as jsync
import nnstreamer_tpu.runtime as jruntime
import nnstreamer_tpu.runtime.parser as jparser
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.core.buffer as tbuffer
import nnstreamer_tpu_torch.elements.basic as tbasic
import nnstreamer_tpu_torch.elements.condition as tcondition
import nnstreamer_tpu_torch.elements.repo as trepo
import nnstreamer_tpu_torch.elements.sensorsrc as tsensor
import nnstreamer_tpu_torch.elements.sync as tsync
import nnstreamer_tpu_torch.runtime as truntime
import nnstreamer_tpu_torch.runtime.parser as tparser


def _port(dev: bool):
    return SimpleNamespace(
        core=tcore, buffer=tbuffer, basic=tbasic, cond=tcondition,
        repo=trepo, sensor=tsensor, sync=tsync,
        NegotiationError=truntime.NegotiationError,
        Pipeline=lambda: truntime.Pipeline(device="cpu"),
        make=truntime.make,
        parse_launch=lambda d: truntime.parse_launch(d, device="cpu"),
        parse_caps_string=tparser.parse_caps_string,
        arr=(lambda a: torch.from_numpy(np.array(a))) if dev else
        (lambda a: a))


PKGS = {
    "jax": SimpleNamespace(
        core=jcore, buffer=jbuffer, basic=jbasic, cond=jcondition,
        repo=jrepo, sensor=jsensor, sync=jsync,
        NegotiationError=jruntime.NegotiationError,
        Pipeline=jruntime.Pipeline, make=jruntime.make,
        parse_launch=jruntime.parse_launch,
        parse_caps_string=jparser.parse_caps_string, arr=lambda a: a),
    "port": _port(False),
    "port-dev": _port(True),
}

SEC = 1_000_000_000


@pytest.fixture(params=list(PKGS))
def P(request):
    return PKGS[request.param]


def spec(P, dims="4", types="float32", **kw):
    return P.core.TensorsSpec.parse(dims, types, **kw)


def frame(P, v, pts=None, n=4):
    return P.core.Buffer.of(P.arr(np.full((n,), v, dtype=np.float32)),
                            pts=pts)


def two_in_one_out(P, factory, **props):
    p = P.Pipeline()
    a = P.basic.AppSrc(name="a", spec=spec(P))
    b = P.basic.AppSrc(name="b", spec=spec(P))
    el = P.make(factory, el_name="x", **props)
    sink = P.basic.AppSink(name="out")
    p.add(a, b, el, sink)
    p.link_pads(a, "src", el, "sink_0")
    p.link_pads(b, "src", el, "sink_1")
    p.link(el, sink)
    return p, a, b, sink


def one_in_one_out(P, src_spec, factory, **props):
    p = P.Pipeline()
    src = P.basic.AppSrc(name="src", spec=src_spec)
    el = P.make(factory, el_name="el", **props)
    sink = P.basic.AppSink(name="out")
    p.add(src, el, sink).link(src, el, sink)
    return p, src, el, sink


def drain(sink):
    out = []
    while True:
        buf = sink.pull(timeout=0.2)
        if buf is None:
            return out
        out.append(buf)


def first(b, i=0):
    return float(np.asarray(b.tensors[i].np()).reshape(-1)[0])


class TestMux:
    def test_two_streams_become_two_tensor_frames(self, P):
        p, a, b, sink = two_in_one_out(P, "tensor_mux")
        with p:
            for i in range(3):
                a.push_buffer(frame(P, i, pts=i * 100))
                b.push_buffer(frame(P, 10 + i, pts=i * 100))
            a.end_of_stream()
            b.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        assert len(out) == 3
        assert out[0].num_tensors == 2
        assert out[2].tensors[1].np()[0] == 12.0

    def test_slowest_policy_drops_fast_pad_backlog(self, P):
        c = P.sync.Collector(P.sync.SyncPolicy.parse("slowest"),
                             ["sink_0", "sink_1"])
        for t in (0, 10, 20, 30):
            assert c.deposit("sink_0", frame(P, t, pts=t)) == []
        sets = c.deposit("sink_1", frame(P, 99, pts=30))
        assert len(sets) == 1
        assert sets[0]["sink_0"].pts == 30  # older fast buffers dropped
        assert sets[0]["sink_1"].pts == 30

    def test_refresh_policy_reuses_quiet_pad(self, P):
        c = P.sync.Collector(P.sync.SyncPolicy.parse("refresh"),
                             ["sink_0", "sink_1"])
        assert c.deposit("sink_0", frame(P, 1, pts=0)) == []
        s1 = c.deposit("sink_1", frame(P, 2, pts=0))
        assert len(s1) == 1
        s2 = c.deposit("sink_0", frame(P, 3, pts=10))
        assert len(s2) == 1
        assert s2[0]["sink_1"].tensors[0].np()[0] == 2.0

    def test_basepad_policy(self, P):
        c = P.sync.Collector(P.sync.SyncPolicy.parse("basepad", "1:0"),
                             ["sink_0", "sink_1"])
        c.deposit("sink_0", frame(P, 1, pts=0))
        c.deposit("sink_0", frame(P, 2, pts=50))
        sets = c.deposit("sink_1", frame(P, 9, pts=40))
        assert len(sets) == 1
        assert sets[0]["sink_0"].pts == 0


class TestMerge:
    def test_concat_innermost_dim(self, P):
        p, a, b, sink = two_in_one_out(P, "tensor_merge", mode="linear",
                                       option="0")
        with p:
            a.push_buffer(frame(P, 1))
            b.push_buffer(frame(P, 2))
            a.end_of_stream()
            b.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        assert len(out) == 1
        np.testing.assert_array_equal(
            out[0].tensors[0].np(),
            np.array([1, 1, 1, 1, 2, 2, 2, 2], np.float32))


class TestDemuxSplit:
    def test_demux_tensorpick_reorder(self, P):
        p = P.Pipeline()
        src = P.basic.AppSrc(name="src", spec=spec(
            P, "4,4,4", "float32,float32,float32"))
        dm = P.make("tensor_demux", el_name="d", tensorpick="2,0")
        s0, s1 = P.basic.AppSink(name="o0"), P.basic.AppSink(name="o1")
        p.add(src, dm, s0, s1)
        p.link(src, dm)
        p.link_pads(dm, "src_0", s0, "sink")
        p.link_pads(dm, "src_1", s1, "sink")
        with p:
            src.push_buffer(P.core.Buffer.of(
                *[P.arr(np.full((4,), i, np.float32)) for i in range(3)]))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            b0, b1 = drain(s0), drain(s1)
        assert first(b0[0]) == 2.0  # pick 2 first
        assert first(b1[0]) == 0.0

    def test_split_by_tensorseg(self, P):
        p = P.Pipeline()
        src = P.basic.AppSrc(name="src", spec=spec(P, "6"))
        sp = P.make("tensor_split", el_name="s", tensorseg="2:4",
                    dimension="0")
        s0, s1 = P.basic.AppSink(name="o0"), P.basic.AppSink(name="o1")
        p.add(src, sp, s0, s1)
        p.link(src, sp)
        p.link_pads(sp, "src_0", s0, "sink")
        p.link_pads(sp, "src_1", s1, "sink")
        with p:
            src.push_buffer(P.core.Buffer.of(
                P.arr(np.arange(6, dtype=np.float32))))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            b0, b1 = drain(s0), drain(s1)
        np.testing.assert_array_equal(b0[0].tensors[0].np(), [0, 1])
        np.testing.assert_array_equal(b1[0].tensors[0].np(), [2, 3, 4, 5])

    def test_join_first_come_forward(self, P):
        p, a, b, sink = two_in_one_out(P, "join")
        with p:
            a.push_buffer(frame(P, 1))
            b.push_buffer(frame(P, 2))
            a.push_buffer(frame(P, 3))
            a.end_of_stream()
            b.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        assert sorted(int(first(o)) for o in out) == [1, 2, 3]


class TestAggregator:
    def test_batch_4_frames(self, P):
        p, src, ag, sink = one_in_one_out(
            P, spec(P, "8:1", rate=Fraction(30)), "tensor_aggregator",
            frames_in=1, frames_out=4, frames_dim=0)
        with p:
            for i in range(8):
                src.push_buffer(P.core.Buffer.of(
                    P.arr(np.full((1, 8), i, np.float32)), pts=i))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        assert len(out) == 2
        assert out[0].tensors[0].shape == (1, 32)
        assert out[1].tensors[0].np()[0, 8] == 5.0

    def test_sliding_window_flush(self, P):
        p, src, ag, sink = one_in_one_out(
            P, spec(P, "2:1"), "tensor_aggregator", frames_in=1,
            frames_out=2, frames_flush=1, frames_dim=0)
        with p:
            for i in range(3):
                src.push_buffer(P.core.Buffer.of(
                    P.arr(np.full((1, 2), i, np.float32))))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        assert len(out) == 2
        np.testing.assert_array_equal(out[1].tensors[0].np(),
                                      [[1, 1, 2, 2]])


class TestIf:
    def _run_if(self, P, frames, **props):
        p = P.Pipeline()
        src = P.basic.AppSrc(name="src", spec=spec(P))
        tif = P.make("tensor_if", el_name="i", **props)
        then_s, else_s = P.basic.AppSink(name="t"), P.basic.AppSink(name="e")
        p.add(src, tif, then_s, else_s)
        p.link(src, tif)
        p.link_pads(tif, "src_then", then_s, "sink")
        p.link_pads(tif, "src_else", else_s, "sink")
        with p:
            for f in frames:
                src.push_buffer(f)
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            return drain(then_s), drain(else_s)

    def test_average_threshold_routes_branches(self, P):
        t, e = self._run_if(
            P, [frame(P, 1), frame(P, 5), frame(P, 2)],
            compared_value="TENSOR_AVERAGE_VALUE",
            compared_value_option="0", operator="ge", supplied_value="3",
            then="PASSTHROUGH", else_="PASSTHROUGH")
        assert [int(first(b)) for b in t] == [5]
        assert [int(first(b)) for b in e] == [1, 2]

    def test_else_fill_zero(self, P):
        t, e = self._run_if(
            P, [frame(P, 5), frame(P, 1)],
            compared_value="A_VALUE", compared_value_option="0:0",
            operator="gt", supplied_value="3",
            then="PASSTHROUGH", else_="FILL_ZERO")
        assert len(t) == 1 and len(e) == 1
        np.testing.assert_array_equal(e[0].tensors[0].np(), np.zeros(4))

    def test_custom_callback(self, P):
        P.cond.register_if_callback(
            "odd", lambda b: int(first(b)) % 2)
        try:
            t, e = self._run_if(
                P, [frame(P, 1), frame(P, 2), frame(P, 3)],
                compared_value="CUSTOM", compared_value_option="odd",
                then="PASSTHROUGH", else_="PASSTHROUGH")
            assert [int(first(b)) for b in t] == [1, 3]
            assert [int(first(b)) for b in e] == [2]
        finally:
            P.cond.unregister_if_callback("odd")

    def test_range_operator_and_repeat_prev(self, P):
        t, e = self._run_if(
            P, [frame(P, 5), frame(P, 50), frame(P, 7)],
            compared_value="A_VALUE", compared_value_option="0:0",
            operator="range_inclusive", supplied_value="0:10",
            then="PASSTHROUGH", else_="REPEAT_PREVIOUS_FRAME")
        assert [int(first(b)) for b in t] == [5, 7]
        assert e == []  # no prior else frame to repeat


class TestRate:
    def test_downsample_drops(self, P):
        p, src, rt, sink = one_in_one_out(
            P, spec(P, rate=Fraction(10)), "tensor_rate", framerate="5/1")
        with p:
            for i in range(10):
                src.push_buffer(frame(P, i, pts=i * SEC // 10))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        assert len(out) == 5
        assert rt.drop_count == 5

    def test_upsample_duplicates(self, P):
        p, src, rt, sink = one_in_one_out(
            P, spec(P, rate=Fraction(5)), "tensor_rate", framerate="10/1")
        with p:
            for i in range(5):
                src.push_buffer(frame(P, i, pts=i * SEC // 5))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        assert len(out) == 9  # last slot has no following frame
        assert rt.dup_count == 4


class TestRepoLoop:
    def test_accumulator_feedback(self, P):
        P.repo.REPO.reset()
        p = P.parse_launch(
            "tensor_reposrc name=loop slot=0 num_buffers=5 "
            "caps=other/tensors,format=static,num_tensors=1,"
            "dimensions=1,types=float32,framerate=0/1 ! "
            "tensor_transform mode=arithmetic option=add:1 ! "
            "tee name=t ! tensor_reposink slot=0 t. ! appsink name=out")
        sink = p["out"]
        with p:
            assert p.wait_eos(timeout=90)
            out = drain(sink)
        assert [first(b) for b in out] == [1.0, 2.0, 3.0, 4.0, 5.0]


class TestSparse:
    def test_roundtrip_through_pipeline(self, P):
        p = P.Pipeline()
        src = P.basic.AppSrc(name="src", spec=spec(P, "8"))
        enc = P.make("tensor_sparse_enc", el_name="enc")
        dec = P.make("tensor_sparse_dec", el_name="dec")
        sink = P.basic.AppSink(name="out")
        p.add(src, enc, dec, sink).link(src, enc, dec, sink)
        x = np.array([0, 0, 3, 0, 0, 0, 7, 0], np.float32)
        with p:
            src.push_buffer(P.core.Buffer.of(P.arr(x)))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        np.testing.assert_array_equal(out[0].tensors[0].np(), x)

    def test_sparse_payload_smaller_for_sparse_data(self, P):
        dense = np.zeros((1000,), np.float32)
        dense[3] = 1.0
        payload = P.buffer.sparse_from_dense(P.core.Tensor(P.arr(dense)))
        assert len(payload) < dense.nbytes // 4


class TestCrop:
    def test_crop_regions(self, P):
        p = P.Pipeline()
        raw = P.basic.AppSrc(name="raw", spec=spec(P, "3:8:8", "uint8"))
        info = P.basic.AppSrc(name="info", spec=spec(P, "4:2", "uint32"))
        crop = P.make("tensor_crop", el_name="c")
        sink = P.basic.AppSink(name="out")
        p.add(raw, info, crop, sink)
        p.link_pads(raw, "src", crop, "sink_raw")
        p.link_pads(info, "src", crop, "sink_info")
        p.link(crop, sink)
        img = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
        regions = np.array([[1, 2, 4, 3], [0, 0, 2, 2]], np.uint32)
        with p:
            raw.push_buffer(P.core.Buffer.of(P.arr(img)))
            info.push_buffer(P.core.Buffer.of(regions))
            raw.end_of_stream()
            info.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        assert len(out) == 1 and out[0].num_tensors == 2
        np.testing.assert_array_equal(out[0].tensors[0].np(),
                                      img[2:5, 1:5, :])
        np.testing.assert_array_equal(out[0].tensors[1].np(),
                                      img[0:2, 0:2, :])


class TestCapsScalarDims:
    def test_scalar_dimensions_caps_string_intersects(self, P):
        a = P.parse_caps_string(
            "other/tensors,format=static,num_tensors=1,dimensions=1,"
            "types=uint8,framerate=0/1")
        b = P.core.Caps.from_spec(spec(P, "1", "uint8"))
        assert a.can_intersect(b)
        assert a.fixate().to_spec().tensors[0].dims == (1,)


class TestAggregatorBacklog:
    def test_fin_gt_fout_emits_all_windows(self, P):
        p, src, ag, sink = one_in_one_out(
            P, spec(P, "4:1"), "tensor_aggregator", frames_in=4,
            frames_out=2, frames_dim=0)
        with p:
            for i in range(2):  # 8 frames total
                src.push_buffer(P.core.Buffer.of(P.arr(
                    np.arange(4 * i, 4 * i + 4, dtype=np.float32
                              ).reshape(1, 4))))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        assert len(out) == 4  # 8 frames / 2 per window
        np.testing.assert_array_equal(out[3].tensors[0].np(), [[6, 7]])

    def test_concat_false_caps_match_payload(self, P):
        p, src, ag, sink = one_in_one_out(
            P, spec(P, "4:1"), "tensor_aggregator", frames_in=1,
            frames_out=2, frames_dim=0, concat=False)
        with p:
            for i in range(2):
                src.push_buffer(P.core.Buffer.of(
                    P.arr(np.full((1, 4), i, np.float32))))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
            out_spec = ag.srcpad.spec  # read before stop clears pad caps
        assert out_spec.num_tensors == 2
        assert out[0].num_tensors == 2
        assert out[0].tensors[0].shape == (1, 4)


class TestRatePrevFrameSemantics:
    def test_gap_slots_carry_previous_frame(self, P):
        p, src, rt, sink = one_in_one_out(
            P, spec(P, rate=Fraction(5)), "tensor_rate", framerate="10/1")
        with p:
            src.push_buffer(frame(P, 0, pts=0))
            src.push_buffer(frame(P, 1, pts=SEC // 5))
            src.end_of_stream()
            assert p.wait_eos(timeout=5)
            out = drain(sink)
        vals = [(b.pts, int(first(b))) for b in out]
        assert vals == [(0, 0), (SEC // 10, 0), (SEC // 5, 1)]


# -- tensor_src_sensor (tests/test_sensor.py) ----------------------------------

def make_iio_dir(tmp_path, values, scales=None, enables=None, freq=None):
    d = tmp_path / "iio:device0"
    d.mkdir()
    (d / "scan_elements").mkdir()
    for name, v in values.items():
        (d / f"in_{name}_raw").write_text(str(v))
        if scales and name in scales:
            s, o = scales[name]
            (d / f"in_{name}_scale").write_text(str(s))
            (d / f"in_{name}_offset").write_text(str(o))
        if enables is not None:
            (d / "scan_elements" / f"in_{name}_en").write_text(
                "1" if enables.get(name, True) else "0")
    if freq is not None:
        (d / "sampling_frequency").write_text(str(freq))
    return str(d)


def run_src(P, src, n):
    p = P.Pipeline()
    sink = P.basic.AppSink(name="out")
    p.add(src, sink).link(src, sink)
    got = []
    with p:
        while len(got) < n:
            b = sink.pull(timeout=10)
            assert b is not None
            got.append(b)
    return got


@pytest.fixture(params=["jax", "port"])
def S(request):
    return PKGS[request.param]


class TestIIOBackend:
    def test_merged_channels_with_scale_offset(self, S, tmp_path):
        d = make_iio_dir(tmp_path, {"accel_x": 100, "accel_y": -50},
                         scales={"accel_x": (0.5, 10.0),
                                 "accel_y": (2.0, 0.0)})
        src = S.make("tensor_src_sensor", el_name="s", device_dir=d,
                     num_buffers=2)
        arr = run_src(S, src, 2)[0].tensors[0].np()
        assert arr.shape == (1, 2)
        np.testing.assert_allclose(arr[0], [(100 + 10) * 0.5, -50 * 2.0])

    def test_raw_mode_no_processing(self, S, tmp_path):
        d = make_iio_dir(tmp_path, {"volt0": 42},
                         scales={"volt0": (0.25, 1.0)})
        src = S.make("tensor_src_sensor", el_name="s", device_dir=d,
                     process=False, num_buffers=1)
        assert run_src(S, src, 1)[0].tensors[0].np()[0, 0] == 42.0

    def test_channel_enable_auto(self, S, tmp_path):
        d = make_iio_dir(tmp_path, {"a": 1, "b": 2, "c": 3},
                         enables={"a": True, "b": False, "c": True})
        src = S.make("tensor_src_sensor", el_name="s", device_dir=d,
                     num_buffers=1)
        np.testing.assert_allclose(
            run_src(S, src, 1)[0].tensors[0].np()[0], [1.0, 3.0])

    def test_channel_list_selection(self, S, tmp_path):
        d = make_iio_dir(tmp_path, {"a": 1, "b": 2, "c": 3})
        src = S.make("tensor_src_sensor", el_name="s", device_dir=d,
                     channels="b", num_buffers=1)
        assert run_src(S, src, 1)[0].tensors[0].np().tolist() == [[2.0]]

    def test_unmerged_one_tensor_per_channel(self, S, tmp_path):
        d = make_iio_dir(tmp_path, {"x": 5, "y": 6})
        src = S.make("tensor_src_sensor", el_name="s", device_dir=d,
                     merge_channels_data=False, buffer_capacity=3,
                     num_buffers=1)
        got = run_src(S, src, 1)
        assert got[0].num_tensors == 2
        np.testing.assert_allclose(got[0].tensors[0].np(), [5.0] * 3)
        np.testing.assert_allclose(got[0].tensors[1].np(), [6.0] * 3)

    def test_device_frequency_and_rate_caps(self, S, tmp_path):
        d = make_iio_dir(tmp_path, {"a": 1}, freq=100)
        src = S.make("tensor_src_sensor", el_name="s", device_dir=d,
                     buffer_capacity=10, num_buffers=2)
        assert src.output_spec().rate == Fraction(10)  # 100 Hz / 10
        got = run_src(S, src, 2)
        assert got[1].pts > got[0].pts

    def test_missing_dir_fails_negotiation(self, S):
        src = S.make("tensor_src_sensor", el_name="s",
                     device_dir="/nonexistent/iio")
        with pytest.raises(S.NegotiationError):
            src.output_spec()


def test_registered_sensor_feeds_pipeline(S):
    state = {"n": 0}

    def read():
        state["n"] += 1
        return np.array([state["n"], -state["n"]], np.float32)

    S.sensor.register_sensor("test_imu", read)
    try:
        p = S.parse_launch(
            "tensor_src_sensor sensor=test_imu num-buffers=3 name=s ! "
            "tensor_transform mode=arithmetic option=mul:2.0 ! "
            "appsink name=out")
        got = []
        with p:
            while len(got) < 3:
                b = p["out"].pull(timeout=10)
                assert b is not None
                got.append(b)
        first_ = got[0].tensors[0].np()
        assert first_.shape == (1, 2)
        assert first_[0, 0] == -first_[0, 1]
    finally:
        S.sensor.unregister_sensor("test_imu")


def test_sensor_registries_are_separate():
    """The port's sensor registry is its own: a sensor registered with one
    package is unknown to the other."""
    tsensor.register_sensor("only_port", lambda: np.zeros(2, np.float32))
    try:
        src = jruntime.make("tensor_src_sensor", el_name="s",
                            sensor="only_port")
        with pytest.raises(jruntime.NegotiationError):
            src.output_spec()
    finally:
        tsensor.unregister_sensor("only_port")
