"""SNTP client + clock-offset estimation for cross-host timestamp sync.

Counterpart of the JAX package's ``edge/ntputil.py``, and the port's one
copy of :func:`offset_and_delay` (``obs/tracectx.py`` imports it from
here).  Parity target: the reference's ``ntputil_get_epoch``: query a
list of (host, port) NTP servers in order, return the first answer as
unix epoch microseconds, falling back to the local clock.

Beyond the reference's epoch-only read, this module implements the full
NTP 4-timestamp exchange (RFC 5905 §8): from ``(t1, t2, t3, t4)`` —
client send, server receive, server send, client receive, the first and
last on the client clock, the middle two on the server clock —
:func:`offset_and_delay` estimates the clock offset and the pure
network round-trip.  The same math runs against any request/response
link that stamps those four times, which is how the distributed latency
tracer places a query server's spans on the client's timeline without
touching NTP at all: every traced query round-trip IS a clock sample.
:class:`PeerClock` keeps the best (minimum-delay) recent sample per
peer, the standard NTP filter — the lower the delay, the less room for
asymmetry error in the offset.

Wire format: 48-byte SNTPv4 packet; the server's transmit timestamp
(seconds since 1900 + 32-bit fraction) converts to the unix epoch.
The edge elements' ``ntp-servers=`` use :func:`async_ntp_epoch_fn`.
"""

from __future__ import annotations

import collections
import socket
import struct
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

NTP_PORT = 123
#: seconds between the NTP era (1900) and the unix epoch (1970)
NTP_UNIX_DELTA = 2_208_988_800


def _parse_transmit_ts(packet: bytes) -> int:
    """Server transmit timestamp (bytes 40..47) → unix epoch µs."""
    if len(packet) < 48:
        raise ValueError(f"ntp: short packet ({len(packet)}B)")
    sec, frac = struct.unpack(">II", packet[40:48])
    if sec == 0:
        raise ValueError("ntp: empty transmit timestamp")
    usec = (sec - NTP_UNIX_DELTA) * 1_000_000 + (frac * 1_000_000 >> 32)
    return usec


def _parse_ts(packet: bytes, off: int) -> int:
    """One 64-bit NTP timestamp at ``off`` → unix epoch µs (0 if unset)."""
    sec, frac = struct.unpack_from(">II", packet, off)
    if sec == 0:
        return 0
    return (sec - NTP_UNIX_DELTA) * 1_000_000 + (frac * 1_000_000 >> 32)


def query_server(host: str, port: int = NTP_PORT,
                 timeout: float = 2.0) -> int:
    """One SNTP round-trip → unix epoch µs from the server clock."""
    req = bytearray(48)
    req[0] = (0 << 6) | (4 << 3) | 3  # LI=0, VN=4, mode=3 (client)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(bytes(req), (host, int(port)))
        data, _ = s.recvfrom(512)
    return _parse_transmit_ts(data)


# -- 4-timestamp offset + delay estimation ------------------------------------


def offset_and_delay(t1: float, t2: float, t3: float,
                     t4: float) -> Tuple[float, float]:
    """RFC 5905 §8 estimate from one request/response exchange.

    ``t1``/``t4`` are on the LOCAL clock (request send, response
    receive), ``t2``/``t3`` on the REMOTE clock (request receive,
    response send).  Returns ``(offset, delay)`` in the callers' time
    unit: ``offset`` estimates ``remote_clock - local_clock`` (assuming
    symmetric path delay), ``delay`` is the pure network round-trip with
    the remote's processing time removed.  The estimate has the handy
    containment property ``t2 - offset = t1 + delay/2`` and ``t3 -
    offset = t4 - delay/2``: remote events mapped with this offset
    always land inside the local ``[t1, t4]`` window."""
    return ((t2 - t1) + (t3 - t4)) / 2.0, (t4 - t1) - (t3 - t2)


def query_server_sample(host: str, port: int = NTP_PORT,
                        timeout: float = 2.0) -> dict:
    """Full SNTP exchange → ``{"epoch_us", "offset_us", "delay_us"}``.

    Unlike :func:`query_server` (transmit timestamp only), this stamps
    the request's transmit field, reads back originate/receive/transmit
    and applies :func:`offset_and_delay` — the real NTP discipline."""
    req = bytearray(48)
    req[0] = (0 << 6) | (4 << 3) | 3
    t1 = int(time.time() * 1e6)
    sec = t1 // 1_000_000 + NTP_UNIX_DELTA
    frac = ((t1 % 1_000_000) << 32) // 1_000_000
    req[40:48] = struct.pack(">II", sec, frac)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(bytes(req), (host, int(port)))
        data, _ = s.recvfrom(512)
    t4 = int(time.time() * 1e6)
    if len(data) < 48:
        raise ValueError(f"ntp: short packet ({len(data)}B)")
    t2 = _parse_ts(data, 32)  # receive timestamp
    t3 = _parse_ts(data, 40)  # transmit timestamp
    if not t3:
        raise ValueError("ntp: empty transmit timestamp")
    if not t2:
        t2 = t3  # degenerate server: fall back to transmit for both
    offset, delay = offset_and_delay(float(t1), float(t2), float(t3),
                                     float(t4))
    return {"epoch_us": t3, "offset_us": offset, "delay_us": delay}


class PeerClock:
    """Rolling clock-offset estimate for ONE remote peer.

    Feed it ``(t1, t2, t3, t4)`` exchanges (NTP packets, or any traced
    request/response round-trip); :attr:`offset` returns the offset of
    the minimum-delay sample in the window — the NTP clock filter: the
    fastest observed round-trip bounds the asymmetry error tightest.
    Thread-safe; samples age out by count (``window``) so a drifting
    clock re-converges."""

    def __init__(self, window: int = 16):
        self._lock = threading.Lock()
        self._samples: "collections.deque[Tuple[float, float]]" = \
            collections.deque(maxlen=int(window))

    def add(self, offset: float, delay: float) -> None:
        with self._lock:
            self._samples.append((max(delay, 0.0), offset))

    def add_exchange(self, t1: float, t2: float, t3: float,
                     t4: float) -> Tuple[float, float]:
        offset, delay = offset_and_delay(t1, t2, t3, t4)
        self.add(offset, delay)
        return offset, delay

    def _best(self) -> Optional[Tuple[float, float]]:
        with self._lock:
            if not self._samples:
                return None
            return min(self._samples)

    @property
    def offset(self) -> float:
        """Best-estimate ``remote - local`` clock offset (0.0 before
        the first sample)."""
        best = self._best()
        return best[1] if best is not None else 0.0

    @property
    def delay(self) -> Optional[float]:
        """Minimum observed network round-trip, or None when empty."""
        best = self._best()
        return best[0] if best is not None else None

    def to_local(self, t_remote: float) -> float:
        """Place a remote-clock timestamp on the local timeline."""
        return t_remote - self.offset

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)


def get_epoch(servers: Optional[Sequence[Tuple[str, int]]] = None,
              timeout: float = 2.0) -> int:
    """Epoch µs from the first answering server; local clock fallback
    (parity: ntputil_get_epoch's host-list walk + default server)."""
    for host, port in servers or ():
        try:
            return query_server(host, port, timeout)
        except (OSError, ValueError):
            continue
    return int(time.time() * 1e6)


def ntp_epoch_fn(servers: Sequence[Tuple[str, int]],
                 refresh_s: float = 60.0) -> Callable[[], int]:
    """Clock callable (an element's epoch stamps): queries NTP at
    most every ``refresh_s`` and advances with the local monotonic
    clock in between (the reference's cacheing TODO, done)."""
    state = {"base_us": None, "base_mono": 0.0}

    def epoch() -> int:
        now = time.monotonic()
        if state["base_us"] is None or \
                now - state["base_mono"] >= refresh_s:
            state["base_us"] = get_epoch(servers)
            state["base_mono"] = now
            return state["base_us"]
        return state["base_us"] + int((now - state["base_mono"]) * 1e6)

    return epoch


def async_ntp_epoch_fn(servers: Sequence[Tuple[str, int]],
                       refresh_s: float = 60.0) -> Callable[[], int]:
    """Hot-path-safe variant of :func:`ntp_epoch_fn`: the SNTP queries
    (blocking, up to 2 s per unreachable server) run on a daemon
    refresh thread started lazily on first call; the returned callable
    itself only ever does arithmetic, so elements may invoke it inside
    ``render()``/``create()`` or under locks.  Until the first query
    answers it returns the local clock.  The attached ``.stop()``
    retires the refresh thread (element ``stop()`` paths call it)."""
    stop_evt = threading.Event()
    lock = threading.Lock()
    state = {"base_us": None, "base_mono": 0.0, "started": False}

    def refresh_loop() -> None:
        while not stop_evt.is_set():
            us = get_epoch(servers)
            now = time.monotonic()
            with lock:
                state["base_us"], state["base_mono"] = us, now
            stop_evt.wait(refresh_s)

    def epoch() -> int:
        with lock:
            if not state["started"]:
                state["started"] = True
                from ..obs import prof as _prof

                _prof.named_thread("edge-ntp", "epoch-refresh",
                                   refresh_loop).start()
            base_us, base_mono = state["base_us"], state["base_mono"]
        if base_us is None:
            return int(time.time() * 1e6)
        return base_us + int((time.monotonic() - base_mono) * 1e6)

    epoch.stop = stop_evt.set
    return epoch
