"""Shared fleet scrape client — ONE snapshot-over-HTTP implementation.

``nns-top --connect`` and the ``obs/watch.py`` watchdog's fleet mode
observe the same endpoints (``serve_metrics`` / ``NNS_TPU_TORCH_METRICS_PORT``
``/json``); this module holds the one fetch/parse implementation both
share, including the failure-tolerance contract that used to live
inline in ``top.py``: a process dying MID-response surfaces as
``http.client`` errors or a truncated-JSON ``ValueError`` rather than
an ``OSError`` — every one of those is captured per endpoint, never
raised, so one flapping endpoint cannot kill a dashboard or a watchdog
sampler.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional


def fetch_snapshot(connect: Optional[str] = None) -> dict:
    """One registry snapshot: scraped over HTTP when ``connect``
    (``host:port``) is given, read from the in-process global registry
    otherwise."""
    if connect:
        import urllib.request

        url = f"http://{connect}/json"
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            return json.loads(resp.read().decode())
    from .metrics import REGISTRY

    return REGISTRY.snapshot()


def fetch_fleet(endpoints: List[Optional[str]],
                fetch: Optional[Callable[[Optional[str]], dict]] = None
                ) -> List[dict]:
    """One sample per endpoint: ``{"endpoint", "snap"|None, "error"}``.
    Scrape failures are captured, not raised — the caller decides
    whether a dead endpoint is fatal (``nns-top --once``), transient
    (live top), or an alertable condition (``nns-watch``
    ``endpoint-down``).  ``fetch`` overrides the per-endpoint fetch
    function (tests, and ``top.py``'s monkeypatchable re-export)."""
    from http.client import HTTPException

    fetch = fetch or fetch_snapshot
    out = []
    for ep in endpoints:
        entry = {"endpoint": ep or "local", "snap": None, "error": None}
        try:
            entry["snap"] = fetch(ep)
        except (OSError, HTTPException, ValueError) as e:
            entry["error"] = str(e) or type(e).__name__
        out.append(entry)
    return out
