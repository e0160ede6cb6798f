"""L5 inter-device layer: query offload, edge pub/sub, wire codec.

Counterpart of the JAX package's ``edge/``: pipelines span processes and
hosts via tensor_query client/server elements, edgesrc/edgesink pub/sub,
the MQTT elements (:mod:`.mqtt`: ``mqttsrc``/``mqttsink`` and an
in-process broker) and the gRPC bridge (:mod:`.grpc_bridge`, where
``grpcio`` is installed).  The same element graph runs over three
transports — an in-process hub (card tensors by reference), TCP with
MetaInfo-headed wire frames (:mod:`.wire`), and MQTT-hybrid (the server's
TCP address found through a broker).
"""

from .query import (
    EdgeSink,
    EdgeSrc,
    TensorQueryClient,
    TensorQueryServerSink,
    TensorQueryServerSrc,
    query_server_entry,
)
from .transport import (
    ClientConn,
    Envelope,
    InprocClientConn,
    InprocServer,
    ServerTransport,
    TcpClientConn,
    TcpServer,
    connect,
    make_server,
)
from .wire import (
    MSG_CAPS_REQ,
    MSG_CAPS_RES,
    MSG_PUBLISH,
    MSG_QUERY,
    MSG_REPLY,
    MSG_SUBSCRIBE,
    EdgeMessage,
)

try:  # gRPC bridge (parity: ext tensor_src/sink_grpc); gated on grpcio
    from .grpc_bridge import GrpcSink, GrpcSrc  # noqa: F401
except ImportError:  # grpcio absent
    GrpcSink = GrpcSrc = None

from .mqtt import MiniBroker, MqttSink, MqttSrc  # noqa: E402,F401

__all__ = [
    "GrpcSink", "GrpcSrc",
    "MiniBroker", "MqttSink", "MqttSrc",
    "EdgeMessage", "Envelope", "ClientConn", "ServerTransport",
    "InprocServer", "InprocClientConn", "TcpServer", "TcpClientConn",
    "connect", "make_server",
    "TensorQueryClient", "TensorQueryServerSrc", "TensorQueryServerSink",
    "EdgeSink", "EdgeSrc", "query_server_entry",
    "MSG_QUERY", "MSG_REPLY", "MSG_SUBSCRIBE", "MSG_PUBLISH",
    "MSG_CAPS_REQ", "MSG_CAPS_RES",
]
