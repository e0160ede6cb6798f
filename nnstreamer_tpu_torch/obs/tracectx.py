"""Cross-device trace-context propagation — the wire side of the tracer.

Counterpart of the JAX package's ``obs/tracectx.py``.  The NTP estimate
(``offset_and_delay``) is the port's one copy in ``edge/ntputil.py``; the
edge elements (``edge/query.py``) send and absorb these blobs.

A sampled buffer's trace dict (:mod:`.tracer`, ``Buffer.meta``) dies at
a process boundary: the edge wire serializes tensors, not meta.  This
module defines the small context blobs that carry a trace across a hop
and the clock math that places the remote spans back on the local
timeline (Documentation/observability.md, "Distributed tracing"):

- **request ctx** (query client → server): trace id + the client's send
  timestamp ``t1``.  The server continues the trace in its own process
  (:func:`plant_server_trace`) so its hook marks accumulate there.
- **reply ctx** (server → client): echoes ``t1``, adds the server's
  receive/send timestamps ``t2``/``t3`` and every mark the trace
  collected server-side.  :func:`absorb_reply` runs the NTP
  4-timestamp estimate (``edge/ntputil.py`` ``offset_and_delay``) over
  ``(t1, t2, t3, t4)`` — every traced query round-trip IS a clock
  sample — and attaches the offset-mapped remote marks to the local
  trace as a ``remote`` entry.  The estimate
  guarantees the mapped server window lands inside ``[t1, t4]``, so
  the client's network span always nests the server's spans.
- **one-way ctx** (edgesink/mqttsink/grpc sink → their sources): no
  return path, so alignment leans on wall clocks — the sender stamps an
  epoch (NTP-disciplined when the element has ``ntp-servers=``
  configured) and the
  receiver derives the transit lag from its own epoch.

All timestamps inside marks and ``t1..t4`` are ``time.monotonic()``
seconds of their host — opaque to the other side, only ever differenced
or offset-mapped.  Contexts serialize as compact JSON: a few hundred
bytes, only on sampled buffers.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Any, Dict, Optional, Tuple

from .tracer import PH_SOURCE, TRACE_META_KEY

CTX_VERSION = 1

#: trailer framing for transports without native extension room
#: (mqttsink payloads, the gRPC bridge frames): ``payload || json ||
#: len u32 || magic``.  Parsed from the END so the reader needs no
#: knowledge of the payload length.
TRAILER_MAGIC = b"NNSTRC01"
_TRAILER_FIXED = len(TRAILER_MAGIC) + 4


def host_tag() -> str:
    """Short stable identity of this process for remote span labels."""
    return f"{socket.gethostname()}:{os.getpid()}"


def encode_ctx(ctx: Dict[str, Any]) -> bytes:
    return json.dumps(ctx, separators=(",", ":")).encode("utf-8")


def decode_ctx(data: bytes) -> Optional[Dict[str, Any]]:
    """None (never an exception) on anything malformed — a trace ctx is
    advisory and must not break the data path."""
    try:
        ctx = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    return ctx if isinstance(ctx, dict) else None


# -- query (round-trip) context ----------------------------------------------


def request_ctx(tr: Dict[str, Any], t1: float) -> Dict[str, Any]:
    """Client-side context sent WITH a traced query."""
    return {"v": CTX_VERSION, "id": tr.get("id"), "frame": tr.get("frame"),
            "t1": t1}


def plant_server_trace(meta: Dict[str, Any], ctx: Dict[str, Any],
                       source_name: str) -> None:
    """Continue a propagated trace in the server process: the planted
    dict rides ``Buffer.meta`` through the server pipeline, collecting
    hook marks exactly like a locally-sampled trace, and keeps the
    request timestamps the reply context echoes back."""
    meta[TRACE_META_KEY] = {
        "frame": ctx.get("frame"),
        "id": ctx.get("id"),
        "origin": "remote",
        "marks": [(time.monotonic(), source_name, PH_SOURCE)],
        "net": {"t1": ctx.get("t1"), "t2": ctx.get("t2")},
    }


def reply_ctx(tr: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Server-side context for the reply of a remote-origin trace (None
    when the buffer's trace did not arrive over the wire)."""
    if not isinstance(tr, dict):
        return None
    net = tr.get("net")
    if not isinstance(net, dict):
        return None
    return {"v": CTX_VERSION, "id": tr.get("id"), "frame": tr.get("frame"),
            "t1": net.get("t1"), "t2": net.get("t2"),
            "host": host_tag(),
            "marks": [list(m) for m in tr.get("marks", ())],
            # the server's wall clock at t3: lets an ntp-disciplined
            # client CROSS-CHECK the in-band span placement (the
            # symmetric-delay assumption) against wall-clock lag
            "epoch3_us": int(time.time() * 1e6),
            "t3": time.monotonic()}


def absorb_reply(tr: Dict[str, Any], ctx: Dict[str, Any], t4: float,
                 link: str) -> Optional[Tuple[float, float]]:
    """Fold a reply context into the local trace dict as a ``remote``
    entry, mapping the server marks onto the local monotonic timeline
    with the per-exchange offset.  Returns ``(offset_s, delay_s)`` for
    the caller's clock filter, or None when the context lacks usable
    timestamps."""
    from ..edge.ntputil import offset_and_delay

    t1, t2, t3 = ctx.get("t1"), ctx.get("t2"), ctx.get("t3")
    if not all(isinstance(t, (int, float)) for t in (t1, t2, t3)):
        return None
    offset, delay = offset_and_delay(t1, t2, t3, t4)
    marks = []
    for m in ctx.get("marks", ()):
        if isinstance(m, (list, tuple)) and len(m) == 3 \
                and isinstance(m[0], (int, float)):
            marks.append((m[0] - offset, str(m[1]), str(m[2])))
    tr.setdefault("remote", []).append({
        "link": link,
        "host": str(ctx.get("host", "?")),
        "t_out": t1, "t_in": t4,
        "t2": t2 - offset, "t3": t3 - offset,
        "rtt_s": delay, "offset_s": offset,
        "marks": marks,
    })
    return offset, delay


# -- one-way (pub/sub) context ------------------------------------------------


def oneway_ctx(tr: Dict[str, Any], epoch_us: int) -> Dict[str, Any]:
    """Sender-side context for a one-way hop (edgesink / mqttsink /
    the gRPC bridge): marks so far + a monotonic send stamp + a wall
    epoch the receiver differences against its own."""
    return {"v": CTX_VERSION, "id": tr.get("id"), "frame": tr.get("frame"),
            "host": host_tag(), "t_send": time.monotonic(),
            "epoch_us": int(epoch_us),
            "marks": [list(m) for m in tr.get("marks", ())]}


def plant_oneway(meta: Dict[str, Any], ctx: Dict[str, Any],
                 recv_epoch_us: int, link: str,
                 source_name: str) -> None:
    """Receiver side of a one-way hop: start a NEW local trace whose
    ``remote`` entry holds the sender's offset-mapped marks.  The lag
    estimate is ``local_epoch - sender_epoch`` — one-way delay plus
    inter-host wall-clock error, which is why unaligned clocks (no NTP
    on either end) skew these spans."""
    now = time.monotonic()
    t_send = ctx.get("t_send")
    epoch_us = ctx.get("epoch_us")
    if not isinstance(t_send, (int, float)) \
            or not isinstance(epoch_us, (int, float)):
        return
    lag_s = max((recv_epoch_us - float(epoch_us)) / 1e6, 0.0)
    send_local = now - lag_s
    marks = []
    for m in ctx.get("marks", ()):
        if isinstance(m, (list, tuple)) and len(m) == 3 \
                and isinstance(m[0], (int, float)):
            marks.append((min(send_local + (m[0] - t_send), now),
                          str(m[1]), str(m[2])))
    meta[TRACE_META_KEY] = {
        "frame": ctx.get("frame"),
        "id": ctx.get("id"),
        "marks": [(now, source_name, PH_SOURCE)],
        "remote": [{
            "link": link, "host": str(ctx.get("host", "?")),
            "t_out": send_local, "t_in": now,
            "t2": send_local, "t3": send_local,
            "rtt_s": None, "offset_s": lag_s,
            "marks": marks,
        }],
    }


# -- trailer framing (mqtt payloads, grpc frames) ---------------------------


def append_trailer(payload: bytes, ctx: Dict[str, Any]) -> bytes:
    """``payload || json || len u32 || magic`` — receivers that predate
    trace contexts and parse ``payload`` by its own declared sizes
    ignore the suffix."""
    blob = encode_ctx(ctx)
    return payload + blob + struct.pack("<I", len(blob)) + TRAILER_MAGIC


def split_trailer(data: bytes
                  ) -> Tuple[bytes, Optional[Dict[str, Any]]]:
    """Inverse of :func:`append_trailer`; ``(data, None)`` when no (or a
    malformed) trailer is present."""
    if len(data) < _TRAILER_FIXED \
            or data[-len(TRAILER_MAGIC):] != TRAILER_MAGIC:
        return data, None
    (blen,) = struct.unpack_from("<I", data, len(data) - _TRAILER_FIXED)
    end = len(data) - _TRAILER_FIXED
    if blen > end:
        return data, None
    ctx = decode_ctx(data[end - blen:end])
    if ctx is None:
        return data, None
    return data[:end - blen], ctx
