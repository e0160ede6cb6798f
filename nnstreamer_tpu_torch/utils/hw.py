"""Hardware detection / capability probing.

Counterpart of the JAX package's ``utils/hw.py``.  Parity target: the
reference's hw_accel.c (NEON/SIMD probing) and the accelerator strings
the filter layer parses (``parse_accl_hw_fill``).

Here the inventory comes from ``torch.cuda``: :func:`probe` lists every
visible CUDA device with its name, count and free/total memory
(``torch.cuda.mem_get_info``), and the CPU always.  The ``accelerator=``
property of a filter selects among these (``utils/device.py``).  A
device the probe cannot read raises: nothing falls back quietly.
"""

from __future__ import annotations

import os
from typing import Dict, List


def probe() -> Dict[str, List[dict]]:
    """Platform (``cuda``, ``cpu``) → list of device capability dicts."""
    import torch

    out: Dict[str, List[dict]] = {}
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        entries = []
        for i in range(n):
            free, total = torch.cuda.mem_get_info(i)
            entries.append({
                "id": i,
                "kind": torch.cuda.get_device_name(i),
                "platform": "cuda",
                "process_index": 0,
                "count": n,
                "bytes_limit": int(total),
                "bytes_in_use": int(total - free),
            })
        out["cuda"] = entries
    out["cpu"] = [{"id": 0, "kind": "cpu", "platform": "cpu",
                   "process_index": 0, "count": 1,
                   "cores": os.cpu_count() or 1}]
    return out


def accelerator_available(kind: str) -> bool:
    """True when ``accelerator=<kind>`` would resolve to a device
    (``gpu`` and ``cuda`` name the card)."""
    k = (kind or "").strip().lower()
    if k == "gpu":
        k = "cuda"
    return bool(probe().get(k))
