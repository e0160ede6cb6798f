"""``nnstreamer_tpu_torch.obs`` — the port's observability layer.

Counterpart of the JAX package's ``obs/`` (Documentation/observability.md
describes the JAX package's; the port keeps its module names, metric
families, label sets and snapshot keys):

- :mod:`.metrics` — the process-wide registry of labeled counters /
  gauges / histograms that absorbs the runtime's stats at scrape time,
  with Prometheus text exposition, a JSON snapshot and a stdlib-http
  endpoint (``serve_metrics`` / ``NNS_TPU_TORCH_METRICS_PORT``);
- :mod:`.tracer` — the per-buffer latency tracer fed by hook points in
  the runtime, sampled 1-in-N, with per-element residency and Chrome
  trace-event export;
- :mod:`.hooks` — the one-global-read dispatch point the hot path checks;
- :mod:`.tracectx` — the wire contexts that carry a sampled trace across
  a process hop, and their clock math;
- :mod:`.transfer` — the byte-exact host↔device transfer ledger;
- :mod:`.devicemem` — scrape-time card memory (``torch.cuda.memory_stats``)
  and per-pool weight footprints;
- :mod:`.hwspec` — the card's peak table (an H100 row);
- :mod:`.xlacost` — per-program FLOP/byte capture and the scrape-time
  MFU join;
- :mod:`.stagestat` / :mod:`.tenantstat` — cascade offload and per-tenant
  device-time attribution;
- :mod:`.flightrec` — the always-on flight recorder.

The JAX package's ``prof``, ``control``, ``watch``, ``forecast``,
``scrape``, ``top``, ``benchgate`` and ``meshstat`` come with later
slices.
"""

from __future__ import annotations

from . import hooks
from .metrics import REGISTRY, LinkMetrics, MetricsRegistry, serve_metrics
from .tracer import TRACE_META_KEY, LatencyTracer

__all__ = [
    "REGISTRY",
    "LinkMetrics",
    "MetricsRegistry",
    "serve_metrics",
    "LatencyTracer",
    "TRACE_META_KEY",
    "hooks",
]
