"""Device-memory accounting: card memory gauges + model weight footprints.

Counterpart of the JAX package's ``obs/devicemem.py``.  Read at *scrape*
time — no background thread, nothing on the hot path — from PyTorch's
caching allocator into the registry's ``device_memory`` table and the
``nns_device_memory_bytes{device,kind}`` gauges, one row per CUDA device
this process has initialized:

- ``in_use`` — ``memory_stats(dev)["allocated_bytes.all.current"]``, the
  bytes held by live tensors;
- ``peak`` — ``allocated_bytes.all.peak`` (since the last
  ``reset_peak_memory_stats``);
- ``limit`` — ``torch.cuda.mem_get_info(dev)[1]``, the card's total;
- ``reserved`` — ``reserved_bytes.all.current``: what the caching
  allocator holds from CUDA, in use or cached for reuse.  The JAX
  allocator has no such split; ``reserved - in_use`` is memory no other
  process can have although no tensor holds it.

Per-model weight footprints come from the serving pool: a pooled
sub-plugin with ``weight_bytes()`` (``torch-cuda`` has one) exports
``nns_model_weight_bytes{pool,placement}``.

With no CUDA device in use (the CPU tests) the table is empty, as on the
JAX package's CPU backend.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence

#: snapshot-table kind -> ``torch.cuda.memory_stats`` key (``limit`` is
#: read from ``mem_get_info`` instead)
MEMORY_KINDS = {
    "in_use": "allocated_bytes.all.current",
    "peak": "allocated_bytes.all.peak",
    "reserved": "reserved_bytes.all.current",
}


def _devices() -> Sequence[Any]:
    """The CUDA devices this process initialized — without initializing
    CUDA: a scrape of a process that never touched the card must not
    start a context."""
    torch = sys.modules.get("torch")
    if torch is None:
        return ()
    try:
        if not torch.cuda.is_initialized():
            return ()
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    except (RuntimeError, AttributeError):
        return ()


def device_memory_table(devices: Optional[Sequence[Any]] = None
                        ) -> List[dict]:
    """One row per device: ``{"device", "in_use", "peak", "limit",
    "reserved"}`` in bytes.  A device whose allocator reports nothing is
    skipped, not errored."""
    import torch

    rows: List[dict] = []
    for d in (devices if devices is not None else _devices()):
        try:
            stats = torch.cuda.memory_stats(d)
            limit = torch.cuda.mem_get_info(d)[1]
        except (RuntimeError, AssertionError, ValueError):
            continue
        if not stats:
            continue
        row: Dict[str, Any] = {"device": str(d)}
        for kind, key in MEMORY_KINDS.items():
            v = stats.get(key)
            if v is not None:
                row[kind] = int(v)
        row["limit"] = int(limit)
        rows.append(row)
    return rows


def device_memory_summary(devices: Optional[Sequence[Any]] = None
                          ) -> List[dict]:
    """The ``/healthz`` slice: device + in-use bytes only."""
    return [{"device": r["device"], "in_use": r.get("in_use")}
            for r in device_memory_table(devices)]
