"""Device channel: the same-process fast path for edge transports.

Counterpart of the JAX package's ``edge/devicechannel.py``, with its
semantics: one process only.  The TCP edge layer pays the full host
round trip per frame: the sender drains every card tensor to the host
(``Tensor.tobytes``), the bytes ride a socket, and the receiver uploads
them again — a d2h+h2d pair *per hop* even when both pipeline endpoints
run in one process against one card.  This module removes that pair:
when two endpoints prove (by handshake) that they share this process's
device world, frames stay **on the card** and only control metadata
crosses the socket.

How it composes with the rest of the edge stack:

- :func:`fingerprint` names this process's device world: a per-process
  tag plus the CUDA device type and count.  Equal fingerprints mean the
  two endpoints hold tensors of one process, so a ``torch.Tensor``
  deposited by one is directly usable by the other.  There are no CUDA
  IPC handles: a peer in another process never matches, and its frames
  ride the wire as bytes.
- The fingerprint is read at the handshake, never at import: importing
  the edge layer or running the analyzer opens no CUDA context.  A
  value read before this process initialised CUDA is not cached, so a
  later handshake sees the card.
- The handshake rides the wire as ``MSG_DEVCH_REQ``/``MSG_DEVCH_RES``
  (:mod:`.wire`): the initiator sends its fingerprint, the peer replies
  ``ok`` only on an exact match and marks the connection
  device-channel-capable.  Anything else — another process, an old
  binary that drops the unknown message — leaves the connection in plain
  TCP mode: the fallback is the absence of the fast path.
- On a capable connection the sender deposits the frame here
  (:func:`deposit_buffer`) and sends a control-only wire frame carrying
  an ``EXT_DEVCH`` descriptor (slot id + fingerprint + byte count)
  instead of payloads; the receiver redeems the slot
  (:func:`take_buffer`).  The transfer ledger (``obs/transfer.py``)
  records no crossing because none happens.

Slots are bounded: a dropped control frame (chaos, disconnect) leaks its
slot until FIFO eviction reclaims it, counted in :func:`stats`.

One pipeline split over device subsets uses the same slot semantics:
:func:`stage_handoff` deposits a frame and redeems it at once re-homed
onto the next stage's device (:func:`take_buffer` with ``device=``): a
device-to-device copy — a copy on the same card when both stages' device
records lie over one card — and one ``d2d``/``handoff`` ledger row.
Residency never flips to the host.
"""

from __future__ import annotations

import itertools
import threading
import uuid
from collections import OrderedDict
from typing import Any, Dict, Optional

from ..core import Buffer, Tensor
from ..utils.log import logw

#: handshake reply payload on a fingerprint match
DEVCH_OK = "ok"

#: per-CHANNEL bound on parked frames awaiting redemption; beyond it
#: that channel's OLDEST slot evicts (its control frame was lost or its
#: receiver is stalled — the receiver surfaces a timeout/drop, like a
#: lost payload frame on plain TCP).  The bound is per sending
#: connection (the ``chan`` tag), so one stalled subscriber's backlog
#: can never evict a healthy link's in-flight frames.
MAX_SLOTS = 512

_PROC_TAG = uuid.uuid4().hex[:12]
_lock = threading.Lock()
#: chan tag → (slot id → parked Buffer); slots are globally unique
#: strings, the chan grouping only scopes the bound/eviction
_slots: "Dict[Any, OrderedDict[str, Buffer]]" = {}
_slot_ids = itertools.count(1)
_fp_cache: Optional[str] = None

#: counters for tests/bench/nns-top (guarded by _lock):
#: deposits/takes/misses/evicted are frame counts, bytes_resident is the
#: payload volume that stayed on the card instead of crossing twice
_stats = {"deposits": 0, "takes": 0, "misses": 0, "evicted": 0,
          "bytes_resident": 0}


def fingerprint() -> str:
    """This process's device-world identity: process tag + CUDA device
    type + device count.  Equal fingerprints ⇔ the two endpoints live in
    this process — the only condition under which a deposited tensor is
    usable on the other side without serialization.  Reads only an
    already initialised CUDA runtime (``torch.cuda.is_initialized()``),
    and caches only such a reading."""
    global _fp_cache
    if _fp_cache is not None:
        return _fp_cache
    import torch

    if not torch.cuda.is_initialized():
        return f"{_PROC_TAG}/none"
    _fp_cache = f"{_PROC_TAG}/cudax{torch.cuda.device_count()}"
    return _fp_cache


def handshake_ok(peer_fp: str) -> bool:
    """Peer's fingerprint names the same device world as ours."""
    return bool(peer_fp) and peer_fp == fingerprint()


def eligible(buf: Buffer) -> bool:
    """A frame rides the device channel only when it is FULLY on the
    card: a host/mixed frame would need its host tensors serialized
    anyway, at which point plain TCP is the simpler path."""
    return bool(buf.tensors) and buf.residency == "device"


def deposit_buffer(buf: Buffer, chan: Any = "") -> Dict[str, Any]:
    """Park a card-resident frame and return the wire descriptor
    (``EXT_DEVCH``): fingerprint + slot id + byte count.  The tensors
    never leave the card — the descriptor is the only thing that crosses
    the socket.  ``chan`` scopes the slot bound to the sending
    connection so links evict independently."""
    slot = f"{_PROC_TAG}-{next(_slot_ids)}"
    nbytes = buf.nbytes
    with _lock:
        ch = _slots.get(chan)
        if ch is None:
            ch = _slots[chan] = OrderedDict()
        ch[slot] = buf
        _stats["deposits"] += 1
        _stats["bytes_resident"] += nbytes
        while len(ch) > MAX_SLOTS:
            ch.popitem(last=False)
            _stats["evicted"] += 1
    return {"fp": fingerprint(), "slot": slot, "nbytes": nbytes}


def take_buffer(desc: Dict[str, Any], device: Any = None
                ) -> Optional[Buffer]:
    """Redeem a descriptor: pop the parked frame (tensors by reference,
    meta shallow-copied so the consumer can stamp routing keys without
    mutating the producer's view).  ``device`` (a device record of
    ``parallel.mesh``, or a ``torch.device``) re-homes every tensor onto
    it: a fresh device-to-device copy, tagged with the record's id.
    Returns None — logged — when the fingerprint is foreign (a sender
    skipped the handshake) or the slot was evicted."""
    fp = str(desc.get("fp", ""))
    if fp != fingerprint():
        with _lock:
            _stats["misses"] += 1
        logw("devicechannel: frame from foreign device world %s "
             "(ours %s) — sender bypassed the handshake; frame dropped",
             fp, fingerprint())
        return None
    slot = str(desc.get("slot", ""))
    with _lock:
        buf = None
        for tag, ch in list(_slots.items()):
            buf = ch.pop(slot, None)
            if not ch:
                del _slots[tag]  # no empty-channel creep
            if buf is not None:
                break
        if buf is None:
            _stats["misses"] += 1
        else:
            _stats["takes"] += 1
    if buf is None:
        logw("devicechannel: slot %s already redeemed or evicted",
             desc.get("slot"))
        return None
    tensors = list(buf.tensors)
    if device is not None:
        tensors = [_rehome(t, device) for t in tensors]
    return Buffer(tensors=tensors, pts=buf.pts,
                  duration=buf.duration, offset=buf.offset,
                  format=buf.format, meta=dict(buf.meta))


def _rehome(t: Tensor, device: Any) -> Tensor:
    """A copy of card tensor ``t`` on ``device`` (a device record or a
    ``torch.device``), never through the host."""
    from ..parallel.mesh import set_home

    src = t.torch()
    target = getattr(device, "torch_device", device)
    moved = src.to(target, copy=True)
    if hasattr(device, "torch_device"):
        set_home(moved, device.id)
    return Tensor(moved, t.spec)


def stage_handoff(buf: Buffer, device: Any,
                  chan: Any = "stage") -> Buffer:
    """Cross-subset handoff within one process: a pipeline's two stages
    on disjoint device subsets.  The frame goes through the channel's
    slot semantics — deposit, immediate redeem re-homed onto ``device``
    (a device-to-device copy, never a host bounce) — and leaves one
    byte-exact ``d2d``/``handoff`` row on the transfer ledger.  Residency
    never flips to host, so ``crossings_per_frame == 0.0`` extends
    across the stage boundary.  Returns the original frame when it is not
    fully on the card (host tensors upload through the normal ``h2d``
    path) or the slot was evicted."""
    if not eligible(buf):
        return buf
    import time as _time

    from ..obs import transfer as _xfer

    desc = deposit_buffer(buf, chan=chan)
    t0 = _time.perf_counter()
    out = take_buffer(desc, device=device)
    if out is None:  # evicted under pressure: keep the original frame
        return buf
    _xfer.record("d2d", "handoff", desc["nbytes"],
                 _time.perf_counter() - t0)
    return out


def release_chan(chan: Any) -> None:
    """Drop a sending connection's parked slots (called at connection
    close): frames still awaiting redemption on a dead link can never be
    taken — holding them would pin their card memory for the channel
    bound's lifetime."""
    with _lock:
        ch = _slots.pop(chan, None)
        if ch:
            _stats["evicted"] += len(ch)


def stats() -> Dict[str, int]:
    with _lock:
        return dict(_stats,
                    parked=sum(len(ch) for ch in _slots.values()))


def reset() -> None:
    """Tests only: drop parked slots and zero the counters."""
    with _lock:
        _slots.clear()
        for k in _stats:
            _stats[k] = 0
