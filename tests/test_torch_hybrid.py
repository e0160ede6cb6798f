"""The MQTT-hybrid connect type of the port (``edge/transport.py``
``HybridServer``, ``connect_hybrid``) against the JAX package's.

``tests/test_hybrid.py`` replayed on the port (retained discovery, a
query round trip, a server that moves and the client re-discovering it,
the cross-host bind and advertise, a broker restart re-advertised, a
rolling restart keeping the successor, broker failures as ``OSError``,
pub/sub over hybrid), then the port's own cases: a JAX client that finds
a port server through a JAX broker and the reverse, and the retained
advertisement written as the JAX package writes it.
"""

from torch_replay import replay

replay("test_hybrid.py", globals(), subs=(
    ("from nnstreamer_tpu.filters.jax_xla import register_model",
     "from nnstreamer_tpu.filters import register_model"),
))


# -- the port's own cases ------------------------------------------------------

from fractions import Fraction  # noqa: E402

import numpy as _np  # noqa: E402
import pytest as _pytest  # noqa: E402

import nnstreamer_tpu.core as jcore  # noqa: E402
import nnstreamer_tpu.edge.mqtt as jmqtt  # noqa: E402
import nnstreamer_tpu.edge.transport as jtransport  # noqa: E402
from nnstreamer_tpu.filters.custom import \
    register_custom_easy as j_register_easy  # noqa: E402
from nnstreamer_tpu.runtime import parse_launch as j_parse  # noqa: E402
from nnstreamer_tpu_torch.core import Buffer as TBuffer  # noqa: E402
from nnstreamer_tpu_torch.core import TensorsSpec as TSpec  # noqa: E402
from nnstreamer_tpu_torch.edge import mqtt as tmqtt  # noqa: E402
from nnstreamer_tpu_torch.edge import transport as ttransport  # noqa: E402
from nnstreamer_tpu_torch.filters.custom import \
    register_custom_easy as t_register_easy  # noqa: E402
from nnstreamer_tpu_torch.runtime import parse_launch as t_parse  # noqa: E402

SPEC4 = "4:1"
CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4:1,"
         "types=float32")
SERVER = ("tensor_query_serversrc name=qsrc connect-type=hybrid "
          "host=127.0.0.1 port={port} topic=hy-x id={sid} caps={caps} ! "
          "tensor_filter framework=custom-easy model={model} ! "
          "tensor_query_serversink id={sid}")
CLIENT = ("appsrc name=src ! tensor_query_client name=cli host=127.0.0.1 "
          "port={port} connect-type=hybrid topic=hy-x timeout=30000 "
          "caps={caps} ! appsink name=out")


def _jax_side():
    j_register_easy("hy_j_x5", lambda xs: [xs[0] * 5.0],
                    in_spec=jcore.TensorsSpec.parse(SPEC4, "float32"),
                    out_spec=jcore.TensorsSpec.parse(SPEC4, "float32"))
    return dict(parse=j_parse, buf=jcore.Buffer.of, spec=jcore.TensorsSpec,
                broker=jmqtt.MiniBroker, model="hy_j_x5")


def _port_side():
    t_register_easy("hy_t_x5", lambda xs: [xs[0] * 5.0],
                    in_spec=TSpec.parse(SPEC4, "float32"),
                    out_spec=TSpec.parse(SPEC4, "float32"))
    return dict(parse=lambda d: t_parse(d, device="cpu"), buf=TBuffer.of,
                spec=TSpec, broker=tmqtt.MiniBroker, model="hy_t_x5")


@_pytest.mark.parametrize("direction", ["jax-client-port-server",
                                        "port-client-jax-server"])
def test_one_package_discovers_the_others_server(direction):
    """The client finds the server's TCP address through the client
    package's broker and offloads frames to it: every frame answered in
    order by the other package's server."""
    cli, srv = (_jax_side(), _port_side()) if direction.startswith("jax") \
        else (_port_side(), _jax_side())
    broker = cli["broker"]()
    try:
        server = srv["parse"](SERVER.format(port=broker.port, sid=71,
                                            caps=CAPS4, model=srv["model"]))
        with server:
            p = cli["parse"](CLIENT.format(port=broker.port, caps=CAPS4))
            p["src"].spec = cli["spec"].parse(SPEC4, "float32",
                                              rate=Fraction(10))
            with p:
                for i in range(4):
                    p["src"].push_buffer(cli["buf"](
                        _np.full((1, 4), float(i + 1), _np.float32), pts=i))
                p["src"].end_of_stream()
                assert p.wait_eos(timeout=60)
                got = []
                while True:
                    b = p["out"].pull(timeout=0.3)
                    if b is None:
                        break
                    got.append(b)
            assert server["qsrc"].port == broker.port  # host:port: broker
    finally:
        broker.stop()
    assert [b.pts for b in got] == [0, 1, 2, 3]
    for i, b in enumerate(got):
        _np.testing.assert_array_equal(
            b.tensors[0].np(), _np.full((1, 4), 5.0 * (i + 1), _np.float32))


def test_advertisement_as_jax_writes_it():
    """Both packages advertise ``host:port`` of the data plane under
    ``nns-edge/<topic>/address`` as a retained message, and each
    package's discovery reads the other's advertisement."""
    assert ttransport._HYBRID_TOPIC_FMT == jtransport._HYBRID_TOPIC_FMT
    broker = tmqtt.MiniBroker()
    try:
        tsrv = ttransport.HybridServer("127.0.0.1", broker.port, topic="ta")
        jsrv = jtransport.HybridServer("127.0.0.1", broker.port, topic="tb")
        tsrv.start()
        jsrv.start()
        try:
            for mod, topic, srv in ((jtransport, "ta", tsrv),
                                    (ttransport, "tb", jsrv)):
                host, port = mod._hybrid_discover("127.0.0.1", broker.port,
                                                  topic, 3.0)
                assert (host, port) == ("127.0.0.1", srv.port)
                assert srv._advertised_addr() == f"127.0.0.1:{srv.port}"
        finally:
            tsrv.stop()
            jsrv.stop()
        for mod, topic in ((ttransport, "ta"), (jtransport, "tb")):
            with _pytest.raises(OSError):  # cleared by the server's stop
                mod._hybrid_discover("127.0.0.1", broker.port, topic, 0.5)
    finally:
        broker.stop()


def test_factories_dispatch_hybrid():
    """``make_server``/``connect`` take ``hybrid`` as the JAX factories do;
    an unknown type still raises."""
    broker = tmqtt.MiniBroker()
    try:
        srv = ttransport.make_server("127.0.0.1", broker.port, "hybrid",
                                     topic="fx")
        assert isinstance(srv, ttransport.HybridServer)
        srv.start()
        try:
            conn = ttransport.connect("127.0.0.1", broker.port, "hybrid",
                                      timeout=3.0, topic="fx")
            assert isinstance(conn, ttransport.TcpClientConn)
            assert conn.is_alive()
            conn.close()
        finally:
            srv.stop()
    finally:
        broker.stop()
    for fn in (ttransport.make_server, ttransport.connect):
        with _pytest.raises(ValueError, match="unknown connect-type"):
            fn("127.0.0.1", 0, "aitt")
