"""The edge layer of the port (``nnstreamer_tpu_torch.edge``) against the JAX
package's.

``tests/test_edge.py`` replayed on the port (wire codec, query offload over
``inproc`` and ``tcp``, client_id routing, caps exchange, pub/sub,
failover), then the port's own cases: the wire codec byte-equal to the JAX
``EdgeMessage`` for every dtype (bf16 too) with and without pts, trace and
device-channel extensions; one host read of a card tensor crossing once in
both packages; the device channel in one process (no crossing, eviction at
``MAX_SLOTS``, a foreign fingerprint refused); a JAX client against a port
server over TCP and the reverse, on plain framing; the ``query_offload``
golden byte-exact.  ``connect-type=hybrid`` is held by
``tests/test_torch_hybrid.py``.  The
port's ledger seams run on the CPU by widening ``obs.transfer.CARD_TYPES``
to ``("cuda", "cpu")`` (a fake card tag).
"""

from torch_replay import replay

replay("test_edge.py", globals(), subs=(
    ("from nnstreamer_tpu.filters.jax_xla import register_model",
     "from nnstreamer_tpu.filters import register_model"),
))


# -- the port's own cases ------------------------------------------------------

import os  # noqa: E402
from fractions import Fraction  # noqa: E402

import ml_dtypes  # noqa: E402
import numpy as _np  # noqa: E402
import pytest as _pytest  # noqa: E402
import torch  # noqa: E402

import golden_cases  # noqa: E402
import nnstreamer_tpu.core as jcore  # noqa: E402
import nnstreamer_tpu.edge as jedge  # noqa: E402
import nnstreamer_tpu.obs.transfer as jxfer  # noqa: E402
from nnstreamer_tpu.filters.custom import \
    register_custom_easy as j_register_easy  # noqa: E402
from nnstreamer_tpu.runtime import Pipeline as JPipeline  # noqa: E402
from nnstreamer_tpu.runtime.registry import make as jmake  # noqa: E402
from nnstreamer_tpu.elements.basic import AppSink as JAppSink  # noqa: E402
from nnstreamer_tpu.elements.basic import AppSrc as JAppSrc  # noqa: E402
from nnstreamer_tpu_torch.core import Buffer as TBuffer  # noqa: E402
from nnstreamer_tpu_torch.core import DType, Tensor  # noqa: E402
from nnstreamer_tpu_torch.core import TensorsSpec as TSpec  # noqa: E402
from nnstreamer_tpu_torch.edge import devicechannel as devch  # noqa: E402
from nnstreamer_tpu_torch.edge import transport as ttransport  # noqa: E402
from nnstreamer_tpu_torch.edge import wire as twire  # noqa: E402
from nnstreamer_tpu_torch.filters.custom import \
    register_custom_easy as t_register_easy  # noqa: E402
from nnstreamer_tpu_torch.obs import transfer as txfer  # noqa: E402
from nnstreamer_tpu_torch.runtime import parse_launch as t_parse  # noqa: E402

_ALL_DTYPES = [d.name.lower() for d in DType]


def _host_array(dtype: str, shape=(2, 3), seed=0):
    """Seeded values of ``dtype`` (bf16 by bit pattern)."""
    rng = _np.random.default_rng(seed)
    if dtype == "bfloat16":
        return rng.standard_normal(shape).astype(_np.float32).astype(
            ml_dtypes.bfloat16)
    dt = _np.dtype(dtype)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    info = _np.iinfo(dt)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), shape,
                        endpoint=True).astype(dt)


def _port_tensor(a):
    """The same values as a CPU torch tensor (bf16 by bit pattern)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(_np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


_EXTS = {
    "plain": {},
    "pts": {"pts": 123456789},
    "trace": {"pts": 7, "trace": {"v": 1, "id": "ab", "t1": 0.25}},
    "devch": {"devch": {"fp": "x/none", "slot": "x-1", "nbytes": 24}},
    "both": {"trace": {"v": 1, "id": "cd"},
             "devch": {"fp": "y/none", "slot": "y-9", "nbytes": 0}},
}


@_pytest.mark.parametrize("ext", sorted(_EXTS))
@_pytest.mark.parametrize("dtype", _ALL_DTYPES)
def test_wire_pack_byte_equal_to_jax(dtype, ext):
    """``EdgeMessage.pack()`` of the same buffer is the JAX package's
    bytes, for a card tensor (torch) as for a host one, and each
    package's ``unpack`` reads the other's frame."""
    a = _host_array(dtype)
    kw = dict(_EXTS[ext])
    pts = kw.pop("pts", None)
    jmsg = jedge.EdgeMessage.from_buffer(
        jedge.MSG_QUERY, jcore.Buffer.of(a, pts=pts), client_id=5, seq=9,
        info="cam")
    tmsg = twire.EdgeMessage.from_buffer(
        twire.MSG_QUERY, TBuffer.of(_port_tensor(a), pts=pts), client_id=5,
        seq=9, info="cam")
    hmsg = twire.EdgeMessage.from_buffer(
        twire.MSG_QUERY, TBuffer.of(a, pts=pts), client_id=5, seq=9,
        info="cam")
    for m in (jmsg, tmsg, hmsg):
        m.trace = kw.get("trace")
        m.devch = kw.get("devch")
    want = jmsg.pack()
    assert tmsg.pack() == want
    assert hmsg.pack() == want
    back = twire.EdgeMessage.unpack(want)
    assert (back.mtype, back.client_id, back.seq, back.pts, back.info,
            back.trace, back.devch) == (
        jmsg.mtype, 5, 9, pts, "cam", kw.get("trace"), kw.get("devch"))
    got = back.to_buffer().tensors[0]
    assert got.tobytes() == a.tobytes() and got.shape == a.shape
    jback = jedge.EdgeMessage.unpack(tmsg.pack())
    assert jback.payloads == jmsg.payloads
    assert (jback.trace, jback.devch) == (kw.get("trace"), kw.get("devch"))


def test_wire_rejects_as_jax():
    """Bad magic, a short frame and a truncated payload raise in both
    packages; a truncated extension area is tolerated in both."""
    frame = twire.EdgeMessage.from_buffer(
        twire.MSG_QUERY, TBuffer.of(_np.arange(4, dtype=_np.float32))).pack()
    for bad, match in ((b"\x00" * 64, "magic"), (frame[:10], "truncated"),
                       (frame[:-3], "truncated")):
        for codec in (twire.EdgeMessage, jedge.EdgeMessage):
            with _pytest.raises(ValueError, match=match):
                codec.unpack(bad)
    msg = twire.EdgeMessage(mtype=twire.MSG_PUBLISH, info="t",
                            trace={"id": "z"})
    cut = msg.pack()[:-2]
    assert twire.EdgeMessage.unpack(cut).trace is None
    assert jedge.EdgeMessage.unpack(cut).trace is None


# -- one host read of a card tensor crosses once -----------------------------


@_pytest.fixture
def fake_card(monkeypatch):
    """The CPU counts as a card: the port's seams record on CPU tensors."""
    monkeypatch.setattr(txfer, "CARD_TYPES", ("cuda", "cpu"))
    txfer.LEDGER.clear()
    jxfer.LEDGER.clear()
    devch.reset()
    yield
    txfer.LEDGER.clear()
    jxfer.LEDGER.clear()
    devch.reset()


@_pytest.mark.parametrize("order", ["tobytes-np", "np-tobytes"])
def test_one_d2h_per_tensor_in_both_packages(fake_card, order):
    import jax.numpy as jnp

    a = _np.arange(12, dtype=_np.float32).reshape(3, 4)
    jt = jcore.Tensor(jnp.asarray(a))
    tt = Tensor(torch.from_numpy(a.copy()))
    for t in (jt, tt):
        if order == "tobytes-np":
            assert t.tobytes() == a.tobytes()
            _np.testing.assert_array_equal(t.np(), a)
        else:
            _np.testing.assert_array_equal(t.np(), a)
            assert t.tobytes() == a.tobytes()
    assert jxfer.LEDGER.totals(direction="d2h") == (1, a.nbytes)
    assert txfer.LEDGER.totals(direction="d2h") == (1, a.nbytes)


def test_packed_frame_then_host_read_drains_once(fake_card):
    """The TCP sender packs a frame (``tobytes`` per tensor); a host
    consumer of the same buffer then reads it without a second crossing."""
    buf = TBuffer.of(torch.ones(2, 3), torch.arange(5))
    ttransport._to_wire(ttransport.Envelope(twire.MSG_QUERY, buffer=buf))
    for t in buf.tensors:
        t.np()
    assert txfer.LEDGER.totals(direction="d2h") == (2, 24 + 40)


# -- the device channel in one process ----------------------------------------

SPEC4 = "4:1"
CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4:1,"
         "types=float32")


def _port_server(sid, connect_type="tcp", host="127.0.0.1", port=0):
    t_register_easy("edge_t_x3", lambda xs: [xs[0] * 3.0],
                    in_spec=TSpec.parse(SPEC4, "float32"),
                    out_spec=TSpec.parse(SPEC4, "float32"))
    p = t_parse(
        f"tensor_query_serversrc name=qsrc connect-type={connect_type} "
        f"host={host} port={port} id={sid} caps={CAPS4} ! "
        "tensor_filter framework=custom-easy model=edge_t_x3 ! "
        f"tensor_query_serversink id={sid}", device="cpu")
    p.start()
    return p, p["qsrc"].port


def _port_client(port, devch_on, name):
    p = t_parse(
        "appsrc name=src ! tensor_query_client name=cli host=127.0.0.1 "
        f"port={port} connect-type=tcp timeout=30000 caps={CAPS4} "
        f"device-channel={'true' if devch_on else 'false'} ! "
        "appsink name=out", device="cpu")
    p.name = name
    p["src"].spec = TSpec.parse(SPEC4, "float32", rate=Fraction(10))
    return p


def _offload(p, frames):
    outs = []
    with p:
        for i, f in enumerate(frames):
            p["src"].push_buffer(TBuffer.of(f, pts=i))
        for _ in frames:
            b = p["out"].pull(timeout=30)
            assert b is not None, f"stalled after {len(outs)}"
            outs.append(b)
        p["src"].end_of_stream()
        assert p.wait_eos(timeout=30)
    return outs


@_pytest.mark.parametrize("devch_on", [True, False])
def test_device_channel_in_one_process(fake_card, devch_on):
    """Over TCP in one process: with the channel the card frames reach
    the server without a crossing (deposits = takes, none evicted, no
    d2h at the client); without it, one d2h a frame at the client.  The
    host filter's replies are host frames: they ride as bytes."""
    srv, port = _port_server(91)
    frames = [torch.full((1, 4), float(i + 1)) for i in range(6)]
    try:
        outs = _offload(_port_client(port, devch_on, f"devch-{devch_on}"),
                        frames)
    finally:
        srv.stop()
    assert [o.pts for o in outs] == list(range(6))
    for i, o in enumerate(outs):
        _np.testing.assert_array_equal(
            o.tensors[0].np(), _np.full((1, 4), 3.0 * (i + 1), _np.float32))
    st = devch.stats()
    if devch_on:
        # the request rides the channel; the host filter's reply is a
        # host frame, which rides the wire as bytes (not eligible)
        assert st["deposits"] == st["takes"] == 6
        assert st["evicted"] == st["misses"] == st["parked"] == 0
        assert txfer.LEDGER.totals(pipeline="devch-True",
                                   direction="d2h") == (0, 0)
    else:
        assert st["deposits"] == st["takes"] == 0
        assert txfer.LEDGER.totals(pipeline="devch-False",
                                   direction="d2h") == (6, 6 * 16)


def test_device_channel_both_directions_no_crossing(fake_card):
    """A card-resident reply (the server stage keeps torch tensors) stays
    on the card too: every hop of every frame is a deposit and a take."""
    sid = 92
    srv = t_parse(
        f"tensor_query_serversrc name=qsrc connect-type=tcp "
        f"host=127.0.0.1 port=0 id={sid} caps={CAPS4} ! "
        "tensor_transform mode=arithmetic option=mul:3 ! "
        f"tensor_query_serversink id={sid}", device="cpu")
    srv.start()
    frames = [torch.full((1, 4), float(i + 1)) for i in range(5)]
    try:
        outs = _offload(_port_client(srv["qsrc"].port, True, "devch-both"),
                        frames)
    finally:
        srv.stop()
    st = devch.stats()
    assert st["deposits"] == st["takes"] == 10 and st["evicted"] == 0
    assert txfer.LEDGER.totals(direction="d2h") == (0, 0)
    assert txfer.LEDGER.totals(direction="h2d") == (0, 0)
    for i, o in enumerate(outs):
        assert o.tensors[0].is_device
        assert o.tensors[0].torch().eq(3.0 * (i + 1)).all()


def test_device_channel_eviction_and_foreign_fingerprint(fake_card):
    buf = TBuffer.of(torch.zeros(2))
    descs = [devch.deposit_buffer(buf, chan="c") for _ in
             range(devch.MAX_SLOTS + 1)]
    assert devch.stats()["evicted"] == 1
    assert devch.take_buffer(descs[0]) is None  # the oldest was evicted
    assert devch.take_buffer(descs[-1]) is not None
    foreign = dict(descs[1], fp="elsewhere/cudax1")
    assert devch.take_buffer(foreign) is None
    assert not devch.handshake_ok("elsewhere/cudax1")
    assert devch.handshake_ok(devch.fingerprint())
    st = devch.stats()
    assert (st["takes"], st["misses"], st["parked"]) == \
        (1, 2, devch.MAX_SLOTS - 1)
    devch.release_chan("c")
    assert devch.stats()["parked"] == 0
    # a host frame is never eligible; a card frame is
    assert devch.eligible(buf)
    assert not devch.eligible(TBuffer.of(_np.zeros(2, _np.float32)))


def test_fingerprint_opens_no_cuda_context():
    """Read at the handshake, never cached before CUDA is initialised."""
    fp = devch.fingerprint()
    assert not torch.cuda.is_initialized()
    assert fp.endswith("/none") and devch._fp_cache is None


# -- a JAX endpoint against a port endpoint over TCP ---------------------------

def _jax_server(sid):
    j_register_easy("edge_j_x3", lambda xs: [xs[0] * 3.0],
                    in_spec=jcore.TensorsSpec.parse(SPEC4, "float32"),
                    out_spec=jcore.TensorsSpec.parse(SPEC4, "float32"))
    p = JPipeline(name=f"jsrv-{sid}")
    src = jmake("tensor_query_serversrc", el_name="qsrc",
                connect_type="tcp", host="127.0.0.1", port=0, id=sid)
    flt = jmake("tensor_filter", el_name="f", framework="custom-easy",
                model="edge_j_x3")
    snk = jmake("tensor_query_serversink", el_name="qsink", id=sid)
    p.add(src, flt, snk).link(src, flt, snk)
    p.start()
    return p, src.port


def _jax_client(port):
    p = JPipeline(name="jcli")
    src = JAppSrc(name="src", spec=jcore.TensorsSpec.parse(
        SPEC4, "float32", rate=Fraction(10)))
    cli = jmake("tensor_query_client", el_name="cli", host="127.0.0.1",
                port=port, connect_type="tcp", timeout=30000, caps=CAPS4)
    out = JAppSink(name="out")
    p.add(src, cli, out).link(src, cli, out)
    return p, src, cli, out


def test_jax_client_against_port_server():
    srv, port = _port_server(93)
    p, src, cli, out = _jax_client(port)
    try:
        got = []
        with p:
            for i in range(4):
                src.push_buffer(jcore.Buffer.of(
                    _np.full((1, 4), float(i + 1), _np.float32), pts=i))
            src.end_of_stream()
            assert p.wait_eos(timeout=60)
            assert cli._conn is not None and not cli._conn.devch_ok
            while True:
                b = out.pull(timeout=0.5)
                if b is None:
                    break
                got.append(b)
        # the two packages' fingerprints differ: plain framing
        assert not srv["qsrc"]._server._devch_clients
    finally:
        srv.stop()
    assert [b.pts for b in got] == [0, 1, 2, 3]
    for i, b in enumerate(got):
        _np.testing.assert_array_equal(
            b.tensors[0].np(), _np.full((1, 4), 3.0 * (i + 1), _np.float32))


def test_port_client_against_jax_server(fake_card):
    srv, port = _jax_server(94)
    p = _port_client(port, True, "tcli-j")
    frames = [torch.full((1, 4), float(i + 1)) for i in range(4)]
    try:
        outs = _offload(p, frames)
    finally:
        srv.stop()
    # refused handshake: the frames crossed as bytes, one d2h each
    assert devch.stats()["deposits"] == 0
    assert txfer.LEDGER.totals(pipeline="tcli-j", direction="d2h") == \
        (4, 4 * 16)
    for i, o in enumerate(outs):
        _np.testing.assert_array_equal(
            o.tensors[0].np(), _np.full((1, 4), 3.0 * (i + 1), _np.float32))


# -- the query_offload golden ---------------------------------------------------

def test_golden_query_offload(tmp_path, monkeypatch):
    monkeypatch.setattr(golden_cases, "parse_launch",
                        lambda desc: t_parse(desc, device="cpu"))
    monkeypatch.setattr(golden_cases, "TensorsSpec", TSpec)
    monkeypatch.setattr(golden_cases, "Buffer", TBuffer)
    monkeypatch.setattr(golden_cases, "register_custom_easy",
                        t_register_easy)
    out = str(tmp_path / "query_offload.out")
    golden_cases.run_case("query_offload", out)
    with open(os.path.join(golden_cases.GOLDEN_DIR,
                           "query_offload.golden"), "rb") as f:
        assert open(out, "rb").read() == f.read()
