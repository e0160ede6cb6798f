"""Edge wire codec: framed messages for cross-host tensor streams.

Counterpart of the JAX package's ``edge/wire.py``: the same frame, byte
for byte, so a port endpoint and a JAX endpoint read each other's
frames.  Parity target: the nnstreamer-edge data wire the reference's
L5 layer sends over TCP (``nns_edge_data_create/add/set_info/send``).
One message carries N tensor payloads, each self-described by the
:class:`~nnstreamer_tpu_torch.core.meta.MetaInfo` header (the same header
flexible streams use on-pipe), plus routing info (client id, sequence,
topic) and the buffer timestamp.

Frame layout (little-endian):

    magic u32 | version u8 | mtype u8 | flags u16 |
    client_id u64 | seq u64 | pts u64 (NONE = 2^64-1) |
    info_len u32 | npayloads u32 | info bytes |
    npayloads × (len u32 | payload) |
    [extension area]

``info`` is a small UTF-8 string whose meaning depends on ``mtype``:
topic for SUBSCRIBE/PUBLISH, a caps string for CAPS_RES, empty otherwise.

The **extension area** sits AFTER the payload table, where decoders that
predate it never look, so frames carrying extensions interoperate with
old binaries in both directions.  ``flags`` bit 0 (:data:`FLAG_EXT`)
announces the area; it holds zero or more self-describing blocks
``tag u16 | len u32 | bytes``.  Known tags: :data:`EXT_TRACE` (1) — a
JSON trace context (:mod:`nnstreamer_tpu_torch.obs.tracectx`) — and
:data:`EXT_DEVCH` (2) — a device-channel descriptor.  Decoders skip
unknown tags and tolerate a truncated area (forward compatibility);
unknown ``flags`` bits pass through untouched rather than raising.

A card tensor leaves the card once on its way into a frame:
``Buffer.pack_flexible`` reads each tensor's bytes through
``Tensor.tobytes``, and a later ``np()`` of the same tensor reads those
bytes instead of draining again.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import List, Optional

from ..core import Buffer, MediaType

WIRE_MAGIC = 0x5451E55A
WIRE_VERSION = 1
PTS_NONE = (1 << 64) - 1

#: flags bit 0: an extension area follows the payload table
FLAG_EXT = 0x0001

#: extension-block tag: JSON trace context (obs.tracectx)
EXT_TRACE = 1
#: extension-block tag: device-channel descriptor (edge.devicechannel)
#: — a JSON dict {fp, slot, nbytes} standing in for the payload table
#: when the frame's tensors stayed on the card; old decoders skip it
EXT_DEVCH = 2

_EXT_HDR = struct.Struct("<HI")

# message types
MSG_QUERY = 1      # client → server: run this buffer through the pipeline
MSG_REPLY = 2      # server → client: the pipeline's answer
MSG_SUBSCRIBE = 3  # edge client → edge sink server: topic subscription
MSG_PUBLISH = 4    # edge sink server → subscribers: one stream buffer
MSG_CAPS_REQ = 5   # client → server: what caps does your output have?
MSG_CAPS_RES = 6   # server → client: info = caps string
MSG_DEVCH_REQ = 7  # either side: info = sender's device fingerprint
MSG_DEVCH_RES = 8  # reply: info = "ok" iff fingerprints match

_HDR_FMT = "<IBBHQQQII"
_HDR_SIZE = struct.calcsize(_HDR_FMT)


@dataclasses.dataclass
class EdgeMessage:
    """One framed edge message."""

    mtype: int
    client_id: int = 0
    seq: int = 0
    pts: Optional[int] = None
    info: str = ""
    payloads: List[bytes] = dataclasses.field(default_factory=list)
    #: header flag bits MINUS the representational FLAG_EXT (derived
    #: from ``trace`` at pack time); unknown bits round-trip untouched
    flags: int = 0
    #: optional trace context (obs.tracectx dict) carried as an
    #: EXT_TRACE extension block
    trace: Optional[dict] = None
    #: optional device-channel descriptor (edge.devicechannel dict)
    #: carried as an EXT_DEVCH block — present on control-only frames
    #: whose tensors stayed on the card (payload table empty)
    devch: Optional[dict] = None

    # -- tensor-buffer bridging ---------------------------------------------

    @classmethod
    def from_buffer(cls, mtype: int, buf: Buffer, client_id: int = 0,
                    seq: int = 0, info: str = "") -> "EdgeMessage":
        return cls(mtype=mtype, client_id=client_id, seq=seq, pts=buf.pts,
                   info=info, payloads=buf.pack_flexible(MediaType.TENSOR))

    def to_buffer(self) -> Buffer:
        buf = Buffer.unpack_flexible(self.payloads, pts=self.pts)
        buf.meta["client_id"] = self.client_id
        buf.meta["query_seq"] = self.seq
        return buf

    # -- framing -------------------------------------------------------------

    def pack(self) -> bytes:
        info_b = self.info.encode("utf-8")
        flags = self.flags & 0xFFFF & ~FLAG_EXT
        ext = b""
        if self.trace is not None:
            blob = json.dumps(self.trace,
                              separators=(",", ":")).encode("utf-8")
            ext = _EXT_HDR.pack(EXT_TRACE, len(blob)) + blob
            flags |= FLAG_EXT
        if self.devch is not None:
            blob = json.dumps(self.devch,
                              separators=(",", ":")).encode("utf-8")
            ext += _EXT_HDR.pack(EXT_DEVCH, len(blob)) + blob
            flags |= FLAG_EXT
        parts = [struct.pack(
            _HDR_FMT, WIRE_MAGIC, WIRE_VERSION, self.mtype, flags,
            self.client_id, self.seq,
            PTS_NONE if self.pts is None else self.pts,
            len(info_b), len(self.payloads)), info_b]
        for p in self.payloads:
            parts.append(struct.pack("<I", len(p)))
            parts.append(p)
        parts.append(ext)
        return b"".join(parts)

    @classmethod
    def unpack(cls, data: bytes) -> "EdgeMessage":
        if len(data) < _HDR_SIZE:
            raise ValueError(f"edge frame truncated: {len(data)}")
        (magic, version, mtype, flags, client_id, seq, pts, info_len,
         npay) = struct.unpack_from(_HDR_FMT, data)
        if magic != WIRE_MAGIC:
            raise ValueError(f"bad edge magic 0x{magic:08x}")
        if version != WIRE_VERSION:
            raise ValueError(f"unsupported edge version {version}")
        off = _HDR_SIZE
        info = data[off:off + info_len].decode("utf-8")
        off += info_len
        payloads = []
        for _ in range(npay):
            if off + 4 > len(data):
                raise ValueError("edge frame payload table truncated")
            (n,) = struct.unpack_from("<I", data, off)
            off += 4
            if off + n > len(data):
                raise ValueError("edge frame payload truncated")
            payloads.append(data[off:off + n])
            off += n
        trace = devch = None
        if flags & FLAG_EXT:
            trace, devch = cls._parse_ext(data, off)
        return cls(mtype=mtype, client_id=client_id, seq=seq,
                   pts=None if pts == PTS_NONE else pts, info=info,
                   payloads=payloads, flags=flags & ~FLAG_EXT,
                   trace=trace, devch=devch)

    @staticmethod
    def _parse_ext(data: bytes, off: int):
        """Walk the extension area: pick out EXT_TRACE / EXT_DEVCH,
        SKIP unknown tags, and stop (never raise) on truncation — a
        newer peer's extensions must not break this decoder."""
        trace = devch = None
        while off + _EXT_HDR.size <= len(data):
            tag, blen = _EXT_HDR.unpack_from(data, off)
            off += _EXT_HDR.size
            if off + blen > len(data):
                break  # truncated block: ignore the rest
            if tag in (EXT_TRACE, EXT_DEVCH):
                try:
                    doc = json.loads(data[off:off + blen].decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    doc = None
                if isinstance(doc, dict):
                    if tag == EXT_TRACE and trace is None:
                        trace = doc
                    elif tag == EXT_DEVCH and devch is None:
                        devch = doc
            off += blen
        return trace, devch
