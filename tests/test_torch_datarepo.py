"""``datareposink``/``datareposrc`` of the port against the JAX package's,
on the CPU.

The datarepo scenarios of ``tests/test_training.py`` run through both
packages (``pkg``): the descriptor a sink writes, reading back in order,
a sample window over two epochs, shuffling within an epoch,
``tensors-sequence``, image-pattern mode torn down without EOS, the
descriptor kept when nothing was written or the open failed, an empty
descriptor for a fresh location, no rewrite after EOS, a flexible
stream.  Then the files cross: a dataset written by one package reads
back through the other, static and flexible, sample for sample, and the
two packages' files are byte-equal.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nnstreamer_tpu.core as jcore
import nnstreamer_tpu.elements.basic as jbasic
import nnstreamer_tpu.runtime as jruntime
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.elements.basic as tbasic
import nnstreamer_tpu_torch.runtime as truntime

PKGS = {
    "jax": SimpleNamespace(core=jcore, basic=jbasic, make=jruntime.make,
                           Pipeline=jruntime.Pipeline),
    "port": SimpleNamespace(core=tcore, basic=tbasic, make=truntime.make,
                            Pipeline=lambda: truntime.Pipeline(
                                device="cpu")),
}


@pytest.fixture(params=list(PKGS))
def P(request):
    return PKGS[request.param]


def drain(sink, timeout=0.3):
    out = []
    while True:
        b = sink.pull(timeout=timeout)
        if b is None:
            return out
        out.append(b)


def write(P, tmp_path, n=6, name="d", frames=None):
    data, js = str(tmp_path / f"{name}.dat"), str(tmp_path / f"{name}.json")
    p = P.Pipeline()
    src = P.basic.AppSrc(name="src", spec=P.core.TensorsSpec.parse(
        "4:1,1:1", "float32,int32"))
    snk = P.make("datareposink", el_name="dsink", location=data, json=js)
    p.add(src, snk).link(src, snk)
    with p:
        for i in range(n):
            a = np.full((1, 4), float(i), np.float32)
            b = np.full((1, 1), i, np.int32)
            if frames == "torch":
                a, b = torch.from_numpy(a), torch.from_numpy(b)
            src.push_buffer(P.core.Buffer.of(a, b))
        src.end_of_stream()
        assert p.wait_eos(timeout=10)
    return data, js


def read(P, data, js, **props):
    p = P.Pipeline()
    src = P.make("datareposrc", el_name="dsrc", location=data, json=js,
                 **props)
    snk = P.basic.AppSink(name="out")
    p.add(src, snk).link(src, snk)
    with p:
        assert p.wait_eos(timeout=10)
        return drain(snk)


def read_all(src):
    """Pull samples straight from a source's ``create`` (no pipeline)."""
    bufs = []
    while True:
        src._running.set()
        b = src.create()
        if b is None:
            return bufs
        bufs.append(b)


class TestDataRepoRoundTrip:
    def test_sink_writes_descriptor(self, P, tmp_path):
        data, js = write(P, tmp_path)
        desc = json.load(open(js))
        assert desc["total_samples"] == 6
        assert desc["sample_size"] == 4 * 4 + 4
        assert "other/tensors" in desc["gst_caps"]
        assert os.path.getsize(data) == 6 * desc["sample_size"]

    def test_src_reads_back_in_order(self, P, tmp_path):
        out = read(P, *write(P, tmp_path), is_shuffle=False, epochs=1)
        assert len(out) == 6
        for i, b in enumerate(out):
            assert float(b.tensors[0].np()[0, 0]) == float(i)
            assert int(b.tensors[1].np()[0, 0]) == i

    def test_sample_window_and_epochs(self, P, tmp_path):
        out = read(P, *write(P, tmp_path), is_shuffle=False,
                   start_sample_index=1, stop_sample_index=3, epochs=2)
        assert [float(b.tensors[0].np()[0, 0]) for b in out] == \
            [1.0, 2.0, 3.0, 1.0, 2.0, 3.0]

    def test_shuffle_permutes_within_epoch(self, P, tmp_path):
        out = read(P, *write(P, tmp_path), is_shuffle=True, epochs=1,
                   seed=3)
        assert sorted(float(b.tensors[0].np()[0, 0]) for b in out) == \
            [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]

    def test_tensors_sequence_selects_and_reorders(self, P, tmp_path):
        out = read(P, *write(P, tmp_path), is_shuffle=False, epochs=1,
                   tensors_sequence="1,0")
        b = out[2]
        assert b.tensors[0].spec.dtype.name.lower() == "int32"
        assert float(b.tensors[1].np()[0, 0]) == 2.0

    def test_pattern_mode_teardown_without_eos_writes_descriptor(
            self, P, tmp_path):
        pat = str(tmp_path / "img_%04d.raw")
        js = str(tmp_path / "imgs.json")
        snk = P.make("datareposink", el_name="ds", location=pat, json=js)
        snk.start()
        for i in range(3):
            snk.render(P.core.Buffer.of(
                np.arange(4 + i, dtype=np.uint8),
                format=P.core.TensorFormat.FLEXIBLE))
        snk.stop()  # torn down early — no on_eos()
        desc = json.load(open(js))
        assert desc["total_samples"] == 3
        assert desc["location_pattern"] == pat
        src = P.make("datareposrc", el_name="dr", location=pat, json=js,
                     is_shuffle=False, epochs=1)
        assert [b.tensors[0].shape for b in read_all(src)] == \
            [(4,), (5,), (6,)]

    def test_zero_sample_stop_does_not_clobber_descriptor(self, P,
                                                          tmp_path):
        data, js = str(tmp_path / "c.dat"), str(tmp_path / "c.json")
        with open(js, "w") as f:
            f.write('{"total_samples": 5, "sample_size": 20}')
        snk = P.make("datareposink", el_name="ds", location=data, json=js)
        snk.start()
        snk.stop()
        assert json.load(open(js))["total_samples"] == 5

    def test_failed_open_does_not_clobber_descriptor(self, P, tmp_path):
        pat = str(tmp_path / "nodir" / "img_%04d.raw")
        js = str(tmp_path / "d.json")
        with open(js, "w") as f:
            f.write('{"total_samples": 100, "location_pattern": "x"}')
        snk = P.make("datareposink", el_name="ds", location=pat, json=js)
        snk.start()
        with pytest.raises(OSError):
            snk.render(P.core.Buffer.of(
                np.zeros(4, np.uint8), format=P.core.TensorFormat.FLEXIBLE))
        snk.stop()
        assert json.load(open(js))["total_samples"] == 100

    def test_zero_sample_stop_fresh_location_writes_empty(self, P,
                                                          tmp_path):
        data, js = str(tmp_path / "e.dat"), str(tmp_path / "e.json")
        snk = P.make("datareposink", el_name="ds", location=data, json=js)
        snk.start()
        snk.stop()
        assert json.load(open(js))["total_samples"] == 0

    def test_stop_after_eos_does_not_rewrite_descriptor(self, P, tmp_path):
        data, js = str(tmp_path / "s.dat"), str(tmp_path / "s.json")
        snk = P.make("datareposink", el_name="ds", location=data, json=js)
        snk.start()
        snk.render(P.core.Buffer.of(np.zeros((1, 4), np.float32)))
        snk.on_eos()
        os.remove(js)
        snk.stop()
        assert not os.path.exists(js)

    def test_flexible_roundtrip(self, P, tmp_path):
        data, js = str(tmp_path / "f.dat"), str(tmp_path / "f.json")
        snk = P.make("datareposink", el_name="ds", location=data, json=js)
        for i in range(3):
            snk.render(P.core.Buffer.of(
                np.arange(2 + i, dtype=np.float32),
                format=P.core.TensorFormat.FLEXIBLE))
        snk.on_eos()
        src = P.make("datareposrc", el_name="dr", location=data, json=js,
                     is_shuffle=False, epochs=1)
        assert [b.tensors[0].shape for b in read_all(src)] == \
            [(2,), (3,), (4,)]


# -- files across the packages ---------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_static_dataset_crosses_packages(writer, reader, tmp_path):
    data, js = write(PKGS[writer], tmp_path,
                     frames="torch" if writer == "port" else None)
    out = read(PKGS[reader], data, js, is_shuffle=False, epochs=1)
    assert [(float(b.tensors[0].np()[0, 0]), int(b.tensors[1].np()[0, 0]))
            for b in out] == [(float(i), i) for i in range(6)]


def test_static_files_byte_equal(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jd, jj = write(PKGS["jax"], tmp_path / "j")
    td, tj = write(PKGS["port"], tmp_path / "t", frames="torch")
    assert open(jd, "rb").read() == open(td, "rb").read()
    assert json.load(open(jj)) == json.load(open(tj))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_flexible_dataset_crosses_packages(writer, reader, tmp_path):
    W, R = PKGS[writer], PKGS[reader]
    data, js = str(tmp_path / "f.dat"), str(tmp_path / "f.json")
    snk = W.make("datareposink", el_name="ds", location=data, json=js)
    want = [np.arange(2 + i, dtype=np.float32) * (i + 1) for i in range(3)]
    for i, a in enumerate(want):
        snk.render(W.core.Buffer.of(a, np.full((i + 1,), i, np.int16),
                                    format=W.core.TensorFormat.FLEXIBLE))
    snk.on_eos()
    src = R.make("datareposrc", el_name="dr", location=data, json=js,
                 is_shuffle=False, epochs=1)
    got = read_all(src)
    assert len(got) == 3
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b.tensors[0].np(), want[i])
        np.testing.assert_array_equal(b.tensors[1].np(),
                                      np.full((i + 1,), i, np.int16))
