"""Per-tenant attribution of the shared serving path.

Counterpart of the JAX package's ``obs/tenantstat.py``.  The pool
(``runtime/serving.py``) coalesces many pipelines' frames into one
cross-stream window, and a window mixes *tenants* (the ``tenant=`` stream
property on ``tensor_filter``).  This module is the process-wide store
behind ``nns_tenant_*``: every pool dispatch splits its device time
across the tenants that parked useful frames in the window, in
proportion to their frame counts.

The split is EXACT: it partitions the same ``t1``/``t2`` clock reads the
pool's ``nns_invoke_device_seconds`` histogram observes (the sampled
dispatch's blocking fence, ``utils/stats.py`` ``DispatchSampler``),
converted once to integer nanoseconds with the residual assigned to the
window's largest tenant — so the sum over tenants equals the pool's total
with zero drift (``exactness()`` exposes both accumulators).  An
unsampled dispatch has no device time: its frames count, its time does
not, as in the histogram.  Dollars are derived at scrape time —
device-seconds × :func:`~nnstreamer_tpu_torch.obs.hwspec.chip_hour_price`
(``NNS_TPU_TORCH_CHIP_HOUR_USD``; 0 when unset) — never stored.

SLO attainment rides the demux loop the admission controller's latency
signal comes from: each demuxed frame's ingress→demux latency is graded
against the pool SLO per tenant.  Sheds are counted per tenant and
reason at the seam ``nns_admission_shed_total`` counts them.

Pulled by the metrics registry at scrape time: the snapshot's
``tenants`` table and the ``nns_tenant_{device_seconds,frames,dollars,
shed}_total`` / ``nns_tenant_slo_attainment`` families.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import hooks as _hooks

#: fast-path flag (same contract as obs/transfer.py / obs/stagestat.py)
ACTIVE = not _hooks.DISABLED

#: the tenant every stream belongs to unless its filter says otherwise
DEFAULT_TENANT = "default"


class _TenantRow:
    __slots__ = ("frames", "device_ns", "lat_total", "lat_within",
                 "shed")

    def __init__(self):
        self.frames = 0
        self.device_ns = 0
        self.lat_total = 0       # demuxed frames graded against the SLO
        self.lat_within = 0      # ... of which landed within it
        self.shed: Dict[str, int] = {}


class TenantStats:
    """Process-wide, thread-safe per-(pool, tenant) attribution store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[Tuple[str, str], _TenantRow] = {}
        # per-pool total device time, the OTHER side of the exactness
        # invariant: accumulated from the very same integer-ns values
        # the per-tenant shares partition
        self._pool_ns: Dict[str, int] = {}

    def _row(self, pool: str, tenant: str) -> _TenantRow:
        key = (str(pool), str(tenant) or DEFAULT_TENANT)
        row = self._rows.get(key)
        if row is None:
            row = self._rows[key] = _TenantRow()
        return row

    def record_window(self, pool: str, tenant_frames: Dict[str, int],
                      device_ns: Optional[int] = None) -> None:
        """Attribute one pool dispatch: ``tenant_frames`` maps tenant →
        useful frames it parked in the window.  ``device_ns`` (the
        sampled dispatch's device phase, integer nanoseconds from the
        same two clock reads ``nns_invoke_device_seconds`` observes) is
        split proportionally by frame count with the integer residual
        going to the largest tenant — so the per-tenant shares sum to
        ``device_ns`` EXACTLY.  None on unsampled dispatches (no
        blocking device fence → no honest device time): frames
        still count, device time doesn't — mirroring the histogram,
        which also only sees sampled windows."""
        items = [(str(t) or DEFAULT_TENANT, int(n))
                 for t, n in tenant_frames.items() if int(n) > 0]
        if not items:
            return
        total = sum(n for _t, n in items)
        with self._lock:
            for tenant, n in items:
                self._row(pool, tenant).frames += n
            if device_ns is None:
                return
            device_ns = int(device_ns)
            self._pool_ns[str(pool)] = \
                self._pool_ns.get(str(pool), 0) + device_ns
            shares = [(tenant, n, device_ns * n // total)
                      for tenant, n in items]
            residual = device_ns - sum(s for _t, _n, s in shares)
            # deterministic residual home: the largest tenant (first
            # such in dict order on ties) — it moves the relative
            # attribution least
            big = max(range(len(shares)), key=lambda i: shares[i][1])
            for i, (tenant, _n, share) in enumerate(shares):
                self._row(pool, tenant).device_ns += \
                    share + (residual if i == big else 0)

    def record_latency(self, pool: str, tenant: str, lat_s: float,
                       slo_s: float) -> None:
        """Grade one demuxed frame's ingress→demux latency against the
        pool SLO — the same per-frame signal the admission controller
        observes, attributed to the frame's tenant."""
        with self._lock:
            row = self._row(pool, tenant)
            row.lat_total += 1
            if lat_s <= slo_s:
                row.lat_within += 1

    def record_shed(self, pool: str, tenant: str, reason: str,
                    frames: int = 1) -> None:
        """Count frames shed at admission, per tenant and reason
        (``slo`` / ``queue-full`` — the same reasons
        ``nns_admission_shed_total`` partitions by)."""
        with self._lock:
            shed = self._row(pool, tenant).shed
            shed[str(reason)] = shed.get(str(reason), 0) + int(frames)

    # -- pull side -----------------------------------------------------------

    def exactness(self, pool: str) -> Tuple[int, int]:
        """``(sum over tenants of attributed device-ns, pool total
        device-ns)`` — equal by construction."""
        with self._lock:
            tenant_ns = sum(r.device_ns for (p, _t), r
                            in self._rows.items() if p == str(pool))
            return tenant_ns, self._pool_ns.get(str(pool), 0)

    def snapshot(self) -> List[dict]:
        """Rows for the registry's ``tenants`` table (v9), sorted by
        (pool, tenant).  Dollars derive from the CURRENT chip-hour
        price (``obs/hwspec.py``, from the environment) — attribution stores
        time, never money."""
        from .hwspec import chip_hour_price

        usd_per_s = chip_hour_price() / 3600.0
        with self._lock:
            rows = [(pool, tenant, r.frames, r.device_ns, r.lat_total,
                     r.lat_within, dict(r.shed))
                    for (pool, tenant), r in sorted(self._rows.items())]
        out: List[dict] = []
        for pool, tenant, frames, ns, lt, lw, shed in rows:
            dev_s = ns / 1e9
            out.append({
                "pool": pool, "tenant": tenant,
                "frames": frames,
                "device_seconds": dev_s,
                "dollars": dev_s * usd_per_s,
                "slo_attainment": (lw / lt) if lt else None,
                "slo_frames": lt,
                "shed": shed,
            })
        return out

    def reset(self) -> None:
        """Tests only: drop every row."""
        with self._lock:
            self._rows.clear()
            self._pool_ns.clear()


#: the process-wide store the pool dispatch / admission seams feed
TENANT_STATS = TenantStats()


def record_window(pool: str, tenant_frames: Dict[str, int],
                  device_ns: Optional[int] = None) -> None:
    """Module-level shim (inert under the global obs kill switch;
    never raises into the hot path)."""
    if not ACTIVE:
        return
    try:
        TENANT_STATS.record_window(pool, tenant_frames, device_ns)
    except Exception:  # noqa: BLE001 - telemetry must not kill a dispatch
        pass


def record_latency(pool: str, tenant: str, lat_s: float,
                   slo_s: float) -> None:
    if not ACTIVE:
        return
    try:
        TENANT_STATS.record_latency(pool, tenant, lat_s, slo_s)
    except Exception:  # noqa: BLE001 - telemetry must not kill a dispatch
        pass


def record_shed(pool: str, tenant: str, reason: str,
                frames: int = 1) -> None:
    if not ACTIVE:
        return
    try:
        TENANT_STATS.record_shed(pool, tenant, reason, frames)
    except Exception:  # noqa: BLE001 - telemetry must not kill a dispatch
        pass
