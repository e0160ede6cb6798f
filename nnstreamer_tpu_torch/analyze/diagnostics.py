"""Diagnostic model + stable code catalog for the static pipeline verifier.

Counterpart of the JAX package's ``analyze/diagnostics.py``: the same
codes with the same severities, their titles naming the port's seams
(``torch-cuda``, the ``NNS_TPU_TORCH_*`` keys, ``runtime/fusion.py``, the
kernel cache of ``ops/build.py``).

Every finding of every pass is a :class:`Diagnostic` with a stable code:

- ``NNS1xx`` — graph structure (links, cycles, reachability, sinks)
- ``NNS2xx`` — caps dry-run (negotiation without starting anything)
- ``NNS3xx`` — concurrency lint over the runtime sources
- ``NNS4xx`` — codebase lint over the whole package
- ``NNS5xx`` — performance-shape checks (micro-batching topology)
- ``NNS6xx`` — whole-package concurrency analysis (lock-order graph,
  deadlock cycles, hold-and-block, shared state, leaf locks)

Codes are append-only: a released code never changes meaning, so CI
suppressions and golden files stay valid across versions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


class Severity:
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    ORDER = {ERROR: 0, WARNING: 1, INFO: 2}


#: code -> (default severity, one-line title).  The catalog drives the
#: docs (Documentation/analyze.md) and the every-code-covered test.
CODES: Dict[str, Tuple[str, str]] = {
    "NNS100": (Severity.ERROR, "pipeline description does not parse"),
    "NNS101": (Severity.ERROR, "sink pad is not linked"),
    "NNS102": (Severity.WARNING,
               "src pad is not linked (data will be dropped)"),
    "NNS103": (Severity.ERROR,
               "double link: pad is already connected"),
    "NNS104": (Severity.ERROR, "cycle in the pipeline graph"),
    "NNS105": (Severity.WARNING,
               "element unreachable from any source"),
    "NNS106": (Severity.WARNING, "pipeline has no sink element"),
    "NNS107": (Severity.ERROR, "pipeline has no source element"),
    "NNS108": (Severity.WARNING,
               "fan-in element inputs disagree on framerate"),
    "NNS201": (Severity.ERROR, "empty caps intersection at link"),
    "NNS202": (Severity.ERROR, "caps cannot be fixated at link"),
    "NNS203": (Severity.INFO,
               "source output caps unknown at analysis time"),
    "NNS204": (Severity.ERROR,
               "element rejected caps during negotiation"),
    "NNS205": (Severity.INFO,
               "filter sub-plugin could not be opened statically"),
    "NNS206": (Severity.INFO, "negotiation did not reach this pad"),
    "NNS301": (Severity.ERROR,
               "blocking call inside a bus-watch handler"),
    "NNS302": (Severity.ERROR,
               "bus post while holding a lock (handler reentrancy)"),
    "NNS303": (Severity.WARNING, "blocking call while holding a lock"),
    "NNS401": (Severity.ERROR, "registered element declares no pads"),
    "NNS402": (Severity.WARNING, "host numpy op in device hot path"),
    "NNS403": (Severity.ERROR, "bare except"),
    "NNS501": (Severity.WARNING,
               "tensor_filter batch>1 with no upstream queue "
               "(no thread boundary: the window cannot fill)"),
    "NNS502": (Severity.WARNING,
               "tensor_filter batch>1 with latency=1 "
               "(per-invoke sync defeats coalescing)"),
    "NNS503": (Severity.WARNING,
               "same torch-cuda model opened by multiple filters without "
               "share-model (duplicated weights and programs in card memory)"),
    "NNS504": (Severity.WARNING,
               "share-model=true on a stateful/custom framework "
               "(one host-side instance across pipelines is unsafe)"),
    "NNS505": (Severity.INFO,
               "tensor_filter latency=1 behind a queue (the reported "
               "latency excludes queue residency and can mislead)"),
    "NNS506": (Severity.INFO,
               "tensor_query_client tracing a cross-host link without "
               "NTP sync (span alignment relies on the in-band "
               "symmetric-delay estimate alone)"),
    "NNS507": (Severity.WARNING,
               "tensor_query_client on a cross-host link with "
               "timeout=0 or max-request=0 (unbounded in-flight "
               "growth against a dead or stalled server)"),
    "NNS508": (Severity.WARNING,
               "observability props (stat-sample-interval-ms / "
               "latency=1 / latency-report / trace) set while obs is "
               "globally disabled (NNS_TPU_TORCH_OBS_DISABLE) — the props "
               "silently no-op"),
    "NNS509": (Severity.WARNING,
               "mesh placement whose batch (or a micro-batch bucket) "
               "is not divisible by the mesh data-axis size — the "
               "window cannot shard evenly, so pad slots (or full "
               "replication) burn device time on every dispatch"),
    "NNS510": (Severity.WARNING,
               "watch rules file problem: malformed rule grammar, or "
               "a rule referencing a metric family the registry never "
               "exports (the alert can never fire)"),
    "NNS511": (Severity.WARNING,
               "controller playbook file problem: malformed grammar, "
               "an unknown rule name or actuator, or an actuation "
               "target (pool/link) no element in the analyzed "
               "pipeline creates (the playbook can never act)"),
    "NNS512": (Severity.WARNING,
               "share-model pool placement problem (pool-level "
               "NNS509): the pool's effective batch/batch-buckets "
               "are not divisible by the mesh data-axis size (every "
               "coalesced cross-pipeline window pads or replicates), "
               "or sharing filters declare provably conflicting "
               "placements (the pool refuses them at start with a "
               "PoolConflictError)"),
    "NNS513": (Severity.WARNING,
               "model lifecycle misconfiguration "
               "(runtime/lifecycle.py): canary= with bad grammar, on "
               "a non-shared filter, or without any watch rule "
               "binding the version-labelled series (the canary "
               "verdict would never trigger); is-updatable on a "
               "framework without reload support; or "
               "NNS_TPU_TORCH_COMPILE_CACHE_DIR pointing at a missing/"
               "unwritable directory (the kernel cache of "
               "ops/build.py cannot keep its libraries)"),
    "NNS514": (Severity.WARNING,
               "residency fence: a host-only element sandwiched "
               "between two device-resident stages — the frame drains "
               "device→host to feed it and re-uploads host→device to "
               "leave it, one full round-trip pair per frame in a "
               "chain that would otherwise stay in card memory "
               "(Documentation/dataflow.md)"),
    "NNS515": (Severity.WARNING,
               "fusion blocked: a linear transform→filter→decoder "
               "segment cannot collapse into one program per window "
               "(runtime/fusion.py) for a "
               "breakable reason — an interposed queue/tee, "
               "share-model=true or invoke-dynamic on the filter, or "
               "a decoder configuration without a device scheme; each "
               "window pays one dispatch per stage instead of one "
               "total (Documentation/fusion.md)"),
    "NNS516": (Severity.WARNING,
               "pipeline-split misconfiguration: stage device subsets "
               "overlap or index past the inventory, a tensor_if "
               "offload branch reaches its cross-subset stage only "
               "through a host-only element (the per-branch face of "
               "NNS514 — the device-channel handoff degrades to a "
               "d2h+h2d pair per offloaded frame), or the cascade's "
               "heavy-stage filter lacks share-model=true "
               "(Documentation/serving.md)"),
    "NNS517": (Severity.WARNING,
               "tenancy/forecast misconfiguration: tenant= on a "
               "filter without share-model=true (attribution splits "
               "the SHARED pool's device-seconds — a private filter "
               "never bills), or a forecast watch rule that cannot "
               "predict: missing/non-positive horizon, bound to a "
               "histogram family, or a horizon shorter than 3 sampler "
               "intervals (Documentation/observability.md)"),
    "NNS518": (Severity.WARNING,
               "host-profiler misconfiguration: NNS_TPU_TORCH_PROF / "
               "NNS_TPU_TORCH_PROF_DEEP_DIR set together with "
               "NNS_TPU_TORCH_OBS_DISABLE (the profiler is strictly inert — "
               "silent no-op, the NNS508 family), an unparsable or "
               "unworkable sampling rate (> 250 Hz: the sampler walks "
               "every thread's stack per tick and stops being "
               "low-overhead), or a deep-profile episode "
               "(NNS_TPU_TORCH_PROF_DEEP_SECONDS) longer than a watch "
               "rule's for= window (the capture outlasts the episode "
               "that triggered it; Documentation/observability.md)"),
    "NNS601": (Severity.ERROR,
               "lock-order cycle across the package: two code paths "
               "take the same locks in opposite orders (potential "
               "deadlock; both acquisition paths printed)"),
    "NNS602": (Severity.WARNING,
               "hold-and-block: a blocking call (socket recv/accept/"
               "sendall, Event.wait, join, synchronize, "
               "registry snapshot) made — directly or through package "
               "calls — while a lock is held"),
    "NNS603": (Severity.WARNING,
               "unguarded shared state: a field written both from a "
               "Thread(target=...) entry point and from a public "
               "method with no guarding lock"),
    "NNS604": (Severity.ERROR,
               "leaf-lock discipline: a lock declared '# nns-lock: "
               "leaf' is held while another lock is acquired"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding.  ``element``/``pad`` name the pipeline location for
    NNS1xx/NNS2xx; for source lint (NNS3xx/NNS4xx) ``element`` is the
    file path and ``pad`` the ``L<line>`` location."""

    code: str
    severity: str
    element: Optional[str]
    pad: Optional[str]
    message: str
    hint: Optional[str] = None

    @classmethod
    def make(cls, code: str, message: str, element: Optional[str] = None,
             pad: Optional[str] = None, hint: Optional[str] = None,
             severity: Optional[str] = None) -> "Diagnostic":
        sev = severity or CODES[code][0]
        return cls(code=code, severity=sev, element=element, pad=pad,
                   message=message, hint=hint)

    def to_dict(self) -> dict:
        return {"code": self.code, "severity": self.severity,
                "element": self.element, "pad": self.pad,
                "message": self.message, "hint": self.hint}

    def sort_key(self):
        return (Severity.ORDER.get(self.severity, 9), self.code,
                self.element or "", self.pad or "", self.message)

    def __str__(self):
        loc = ""
        if self.element:
            loc = f" [{self.element}" + (f".{self.pad}" if self.pad
                                         else "") + "]"
        s = f"{self.code} {self.severity:<7}{loc} {self.message}"
        if self.hint:
            # identical prefix per hint line keeps caret markers aligned
            for line in self.hint.split("\n"):
                s += f"\n        hint| {line}"
        return s


def sort_diagnostics(diags: List[Diagnostic]) -> List[Diagnostic]:
    return sorted(diags, key=lambda d: d.sort_key())


def counts(diags: List[Diagnostic]) -> Dict[str, int]:
    out = {Severity.ERROR: 0, Severity.WARNING: 0, Severity.INFO: 0}
    for d in diags:
        out[d.severity] = out.get(d.severity, 0) + 1
    return out
