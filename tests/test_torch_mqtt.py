"""The MQTT elements of the port (``nnstreamer_tpu_torch.edge.mqtt``)
against the JAX package's.

``tests/test_mqtt.py`` replayed on the port (the header round trip, the
client against the in-process broker, wildcard matching, a sink → source
pipeline), then the port's own cases: the message header and the trace
trailer byte-equal to the JAX ``pack_mqtt_buffer`` for every dtype (bf16
too), each package reading the other's message; a JAX ``mqttsink``
publishing to a port ``mqttsrc`` through a port ``MiniBroker`` and the
reverse; the flexible stream negotiated by a transform after ``mqttsrc``
in both packages; one host read per card tensor at the publisher (a fake
card tag: ``obs.transfer.CARD_TYPES`` widened to ``("cuda", "cpu")``);
the broker's payload counters; a stalled subscriber that holds the
publisher back and loses nothing; the ``mqtt_loopback`` golden
byte-exact.
"""

from torch_replay import replay

replay("test_mqtt.py", globals())


# -- the port's own cases ------------------------------------------------------

import os  # noqa: E402
import time as _time  # noqa: E402
from fractions import Fraction  # noqa: E402

import ml_dtypes  # noqa: E402
import numpy as _np  # noqa: E402
import pytest as _pytest  # noqa: E402
import torch  # noqa: E402

import golden_cases  # noqa: E402
import nnstreamer_tpu.core as jcore  # noqa: E402
import nnstreamer_tpu.edge.mqtt as jmqtt  # noqa: E402
import nnstreamer_tpu.obs.tracectx as jtracectx  # noqa: E402
from nnstreamer_tpu.elements.basic import AppSrc as JAppSrc  # noqa: E402
from nnstreamer_tpu.runtime import Pipeline as JPipeline  # noqa: E402
from nnstreamer_tpu.runtime import parse_launch as j_parse  # noqa: E402
from nnstreamer_tpu.runtime.registry import make as jmake  # noqa: E402
from nnstreamer_tpu_torch.core import Buffer as TBuffer  # noqa: E402
from nnstreamer_tpu_torch.core import Caps as TCaps  # noqa: E402
from nnstreamer_tpu_torch.core import DType  # noqa: E402
from nnstreamer_tpu_torch.core import TensorsSpec as TSpec  # noqa: E402
from nnstreamer_tpu_torch.edge import mqtt as tmqtt  # noqa: E402
from nnstreamer_tpu_torch.obs import tracectx as ttracectx  # noqa: E402
from nnstreamer_tpu_torch.obs import transfer as txfer  # noqa: E402
from nnstreamer_tpu_torch.runtime import parse_launch as t_parse  # noqa: E402
from torch_replay import port_function  # noqa: E402

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


#: a fixed one-way context (``oneway_ctx`` stamps the clock and the host)
_CTX = {"v": 1, "id": "ab12", "frame": 3, "host": "h1", "t_send": 0.25,
        "epoch_us": 200, "marks": [["src", 0.125], ["out", 0.5]]}


@_pytest.mark.parametrize("trace", [False, True], ids=["plain", "trace"])
@_pytest.mark.parametrize("dtype", _ALL_DTYPES)
def test_message_byte_equal_to_jax(dtype, trace):
    """The header (16 memories, epochs, duration, dts, pts, the 512-byte
    caps string) and the payloads are the JAX package's bytes, for a
    torch tensor as for a numpy one, and each package reads the other's
    message back to the same bytes, pts and dtype."""
    a = _host_array(dtype)
    b = _host_array("int32", (5,), seed=1)
    jbuf = jcore.Buffer.of(a, b, pts=777)
    jbuf.duration = 33
    want = jmqtt.pack_mqtt_buffer(
        jbuf, jcore.Caps.from_spec(jbuf.spec(rate=Fraction(30))), 100, 200)
    for first in (_port_tensor(a), a):
        tbuf = TBuffer.of(first, _port_tensor(b), pts=777)
        tbuf.duration = 33
        got = tmqtt.pack_mqtt_buffer(
            tbuf, TCaps.from_spec(tbuf.spec(rate=Fraction(30))), 100, 200)
        assert got == want
    if trace:
        want = jtracectx.append_trailer(want, _CTX)
        assert ttracectx.append_trailer(got, _CTX) == want
    for split, unpack in ((ttracectx.split_trailer,
                           tmqtt.unpack_mqtt_buffer),
                          (jtracectx.split_trailer,
                           jmqtt.unpack_mqtt_buffer)):
        data, ctx = split(want)
        assert ctx == (_CTX if trace else None)
        out, spec, sent = unpack(data)
        assert (sent, out.pts, out.duration) == (200, 777, 33)
        assert spec is not None and spec.num_tensors == 2
        assert [t.tobytes() for t in out.tensors] == [a.tobytes(),
                                                      b.tobytes()]
        assert str(out.tensors[0].spec.dtype.name).lower() == dtype


def test_unpack_rejects_as_jax():
    """A short message, too many memories and a short payload raise in
    both packages; a message without caps yields uint8 bytes in both."""
    buf = TBuffer.of(_np.arange(6, dtype=_np.float32))
    caps = TCaps.from_spec(buf.spec())
    good = tmqtt.pack_mqtt_buffer(buf, caps, 0, 0)
    many = bytearray(good)
    many[0:4] = (17).to_bytes(4, "little")
    for bad, match in ((good[:100], "short message"),
                       (bytes(many), "memories"),
                       (good[:-1], "shorter than declared")):
        for mod in (tmqtt, jmqtt):
            with _pytest.raises(Exception, match=match):
                mod.unpack_mqtt_buffer(bad)
    bare = tmqtt.pack_mqtt_buffer(buf, None, 0, 0)
    assert bare == jmqtt.pack_mqtt_buffer(
        jcore.Buffer.of(_np.arange(6, dtype=_np.float32)), None, 0, 0)
    for mod in (tmqtt, jmqtt):
        out, spec, _ = mod.unpack_mqtt_buffer(bare)
        assert spec is None and out.tensors[0].np().dtype == _np.uint8
        assert out.tensors[0].tobytes() == buf.tensors[0].tobytes()


# -- one package publishing, the other subscribing -------------------------------

SPEC = "4:2"
FRAMES = [_np.arange(8, dtype=_np.float32).reshape(2, 4) * (i + 1)
          for i in range(3)]


def _jax_publisher(port):
    p = JPipeline(name="jpub")
    src = JAppSrc(name="src", spec=jcore.TensorsSpec.parse(
        SPEC, "float32", rate=Fraction(30)))
    snk = jmake("mqttsink", el_name="mk", host="127.0.0.1", port=port,
                pub_topic="x/cam")
    p.add(src, snk).link(src, snk)
    return p, src


def _port_publisher(port):
    p = t_parse("appsrc name=src ! mqttsink name=mk host=127.0.0.1 "
                f"port={port} pub-topic=x/cam", device="cpu")
    p["src"].spec = TSpec.parse(SPEC, "float32", rate=Fraction(30))
    return p, p["src"]


def _jax_subscriber(port):
    return j_parse(f"mqttsrc name=ms host=127.0.0.1 port={port} "
                   "sub-topic=x/+ num-buffers=3 ! appsink name=out")


def _port_subscriber(port):
    return t_parse(f"mqttsrc name=ms host=127.0.0.1 port={port} "
                   "sub-topic=x/+ num-buffers=3 ! appsink name=out",
                   device="cpu")


@_pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_one_package_publishes_the_other_subscribes(direction):
    """The JAX ``mqttsink`` to a port ``mqttsrc`` through a port broker,
    and the port's sink to a JAX source through a JAX broker: every
    frame arrives in order with its pts, dtype and bytes."""
    if direction == "jax-to-port":
        broker = tmqtt.MiniBroker()
        make_pub, make_sub, buf_of = _jax_publisher, _port_subscriber, \
            jcore.Buffer.of
    else:
        broker = jmqtt.MiniBroker()
        make_pub, make_sub, buf_of = _port_publisher, _jax_subscriber, \
            TBuffer.of
    try:
        sub = make_sub(broker.port)
        sub.start()
        pub, src = make_pub(broker.port)
        pub.start()
        try:
            _time.sleep(0.2)  # let the subscription settle
            for i, f in enumerate(FRAMES):
                src.push_buffer(buf_of(f, pts=i * 10))
            assert sub.wait_eos(timeout=30)
            got = []
            while True:
                b = sub["out"].pull(timeout=0.3)
                if b is None:
                    break
                got.append(b)
            assert sub["ms"].last_latency_us is not None
        finally:
            pub.stop()
            sub.stop()
    finally:
        broker.stop()
    assert [b.pts for b in got] == [0, 10, 20]
    for b, f in zip(got, FRAMES):
        assert b.tensors[0].np().dtype == _np.float32
        assert b.tensors[0].tobytes() == f.tobytes()


@_pytest.mark.parametrize("pkg", ["jax", "port"])
def test_flexible_stream_into_a_transform(pkg):
    """``mqttsrc`` announces a FLEXIBLE stream; the transform after it
    takes each message's spec from its caps string, as on the camera
    path: the frames come out byte-equal to the same transform on a
    static stream from ``appsrc``, in both packages."""
    frames = [_np.random.default_rng(i).integers(0, 256, (1, 8, 8, 3),
                                                 dtype=_np.uint8)
              for i in range(3)]
    desc = ("mqttsrc name=ms host=127.0.0.1 port={port} sub-topic=cam "
            "num-buffers=3 ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "appsink name=out")
    mod, parse, buf_of = (jmqtt, j_parse, jcore.Buffer.of) if pkg == "jax" \
        else (tmqtt, lambda d: t_parse(d, device="cpu"), TBuffer.of)
    broker = mod.MiniBroker()
    try:
        sub = parse(desc.format(port=broker.port))
        sub.start()
        pub = parse(f"appsrc name=src ! mqttsink host=127.0.0.1 "
                    f"port={broker.port} pub-topic=cam")
        spec_cls = jcore.TensorsSpec if pkg == "jax" else TSpec
        pub["src"].spec = spec_cls.parse("3:8:8:1", "uint8")
        pub.start()
        try:
            _time.sleep(0.2)
            for i, f in enumerate(frames):
                pub["src"].push_buffer(buf_of(f, pts=i))
            assert sub.wait_eos(timeout=30)
            got = [sub["out"].pull(timeout=5) for _ in frames]
        finally:
            pub.stop()
            sub.stop()
    finally:
        broker.stop()
    local = parse("appsrc name=src ! tensor_transform mode=arithmetic "
                  "option=typecast:float32,add:-127.5,div:127.5 ! "
                  "appsink name=out")
    local["src"].spec = spec_cls.parse("3:8:8:1", "uint8")
    with local:
        for i, f in enumerate(frames):
            local["src"].push_buffer(buf_of(f, pts=i))
        want = [local["out"].pull(timeout=5) for _ in frames]
    assert [b.pts for b in got] == [0, 1, 2]
    for b, w in zip(got, want):
        assert b.tensors[0].np().dtype == _np.float32
        assert b.tensors[0].tobytes() == w.tensors[0].tobytes()


@_pytest.fixture
def fake_card(monkeypatch):
    """The CPU counts as a card: the port's seams record on CPU tensors."""
    monkeypatch.setattr(txfer, "CARD_TYPES", ("cuda", "cpu"))
    txfer.LEDGER.clear()
    yield
    txfer.LEDGER.clear()


def test_card_frames_drain_once_per_tensor_and_broker_counts(fake_card):
    """``mqttsink`` drains each card tensor once (one ``d2h`` a tensor,
    the ledger's bytes the payloads'); the broker's payload counters
    equal the packed messages, in and out to each subscriber."""
    broker = tmqtt.MiniBroker()
    frames = [(torch.full((2, 4), float(i)), torch.arange(3) + i)
              for i in range(4)]
    try:
        subs = [_port_subscriber(broker.port) for _ in range(2)]
        for s in subs:
            s["ms"].num_buffers = len(frames)
            s.start()
        pub = t_parse("appsrc name=src ! mqttsink name=mk host=127.0.0.1 "
                      f"port={broker.port} pub-topic=x/cam", device="cpu")
        pub.name = "mq-card"
        pub["src"].spec = TSpec.parse("4:2,3", "float32,int64")
        pub.start()
        try:
            _time.sleep(0.2)
            for i, (a, b) in enumerate(frames):
                pub["src"].push_buffer(TBuffer.of(a, b, pts=i))
            for s in subs:
                assert s.wait_eos(timeout=30)
            got = [[s["out"].pull(timeout=5) for _ in frames] for s in subs]
            caps = pub["mk"].sinkpad.caps
            d2h = txfer.LEDGER.totals(pipeline="mq-card", direction="d2h")
        finally:
            pub.stop()
            for s in subs:
                s.stop()
    finally:
        broker.stop()
    assert d2h == (2 * len(frames), len(frames) * (32 + 24))
    sizes = [len(tmqtt.pack_mqtt_buffer(TBuffer.of(a, b, pts=i), caps, 0, 0))
             for i, (a, b) in enumerate(frames)]
    assert broker.bytes_in == sum(sizes)
    assert broker.bytes_out == 2 * sum(sizes)
    for per_sub in got:
        assert [b.pts for b in per_sub] == list(range(len(frames)))
        for b, (x, y) in zip(per_sub, frames):
            assert b.tensors[0].tobytes() == x.numpy().tobytes()
            assert b.tensors[1].tobytes() == y.numpy().tobytes()


def test_broker_holds_a_stalled_subscriber_without_loss():
    """A subscriber that stops reading while more bytes are published
    than its queue and socket buffers hold: the broker's forward to it
    waits (here past a second, twice the broker's read poll) instead of
    cutting the packet, and every frame then arrives, byte-equal and in
    order, at the stalled ``mqttsrc`` and at a subscriber that kept
    draining."""
    import threading

    # 75 MiB: more than mqttsrc's 256-deep queue (16 MiB of these frames)
    # plus the largest socket buffers Linux grows on each side
    n, size, stall_s = 1200, 64 * 1024, 1.0

    def frame(i):
        return _np.random.default_rng(i).integers(0, 256, size,
                                                  dtype=_np.uint8)

    caps = TCaps.from_spec(TSpec.parse(str(size), "uint8"))
    broker = tmqtt.MiniBroker()
    sending = {}  # forwards in progress → their start
    send_pkt = broker._send_pkt

    def timed_send(conn, pkt):
        key = object()
        sending[key] = _time.monotonic()
        try:
            send_pkt(conn, pkt)
        finally:
            del sending[key]

    broker._send_pkt = timed_send
    drained, bad = [0], []
    try:
        stalled = t_parse(f"mqttsrc name=ms host=127.0.0.1 "
                          f"port={broker.port} sub-topic=cam "
                          f"num-buffers={n} ! appsink name=out "
                          "max-buffers=1", device="cpu")
        stalled.start()
        drainer = tmqtt.MqttClient("127.0.0.1", broker.port, "drain")
        drainer.subscribe("cam")

        def drain():
            while drained[0] < n:
                msg = drainer.recv_publish()
                if msg is None:
                    continue
                buf = tmqtt.unpack_mqtt_buffer(msg[1])[0]
                if buf.pts != drained[0] or \
                        buf.tensors[0].tobytes() != frame(buf.pts).tobytes():
                    bad.append(drained[0])
                drained[0] += 1

        pub = tmqtt.MqttClient("127.0.0.1", broker.port, "pub")
        published = []

        def publish():
            for i in range(n):
                pub.publish("cam", tmqtt.pack_mqtt_buffer(
                    TBuffer.of(torch.from_numpy(frame(i)), pts=i), caps,
                    0, 0))
            published.append(True)

        threads = [threading.Thread(target=t, daemon=True)
                   for t in (drain, publish)]
        try:
            _time.sleep(0.2)  # let the subscriptions settle
            for t in threads:
                t.start()
            # nothing pulls the stalled pipeline until a forward has
            # waited stall_s, or the publisher got everything through
            deadline = _time.monotonic() + 60
            held = False
            while not held and not published and \
                    _time.monotonic() < deadline:
                now = _time.monotonic()
                held = any(now - t >= stall_s
                           for t in list(sending.values()))
                _time.sleep(0.01)
            got = []
            for i in range(n):
                b = stalled["out"].pull(timeout=10)
                if b is None:
                    break
                got.append((b.pts, b.tensors[0].tobytes() ==
                            frame(i).tobytes()))
            for t in threads:
                t.join(timeout=30)
        finally:
            pub.close()
            drainer.close()
            stalled.stop()
    finally:
        broker.stop()
    assert held, "no forward waited: the stall never reached the broker"
    assert got == [(i, True) for i in range(n)]
    assert drained[0] == n and not bad
    assert broker.bytes_out == 2 * broker.bytes_in


# -- the mqtt_loopback golden -------------------------------------------------------

def test_golden_mqtt_loopback(tmp_path):
    """``case_mqtt_loopback`` (``tests/golden_cases.py``) with the port's
    broker, elements and ``parse_launch(device="cpu")``."""
    case = port_function(golden_cases.case_mqtt_loopback, {
        "parse_launch": lambda desc: t_parse(desc, device="cpu"),
        "TensorsSpec": TSpec, "Buffer": TBuffer})
    out = str(tmp_path / "mqtt_loopback.out")
    case(out)
    with open(os.path.join(golden_cases.GOLDEN_DIR,
                           "mqtt_loopback.golden"), "rb") as f:
        assert open(out, "rb").read() == f.read()
