"""L5 inter-device layer: query offload, edge pub/sub, wire codec.

Counterpart of the JAX package's ``edge/`` for the query offload and the
pub/sub core: pipelines span processes and hosts via tensor_query
client/server elements and edgesrc/edgesink pub/sub.  The same element
graph runs over two transports — an in-process hub (card tensors by
reference) and TCP with MetaInfo-headed wire frames (:mod:`.wire`).
The MQTT elements, the MQTT-hybrid connect type and the gRPC bridge come
with ROADMAP item 5b.
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

__all__ = [
    "EdgeMessage", "Envelope", "ClientConn", "ServerTransport",
    "InprocServer", "InprocClientConn", "TcpServer", "TcpClientConn",
    "connect", "make_server",
    "TensorQueryClient", "TensorQueryServerSrc", "TensorQueryServerSink",
    "EdgeSink", "EdgeSrc", "query_server_entry",
    "MSG_QUERY", "MSG_REPLY", "MSG_SUBSCRIBE", "MSG_PUBLISH",
    "MSG_CAPS_REQ", "MSG_CAPS_RES",
]
