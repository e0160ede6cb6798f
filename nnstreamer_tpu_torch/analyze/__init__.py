"""``nnstreamer_tpu_torch.analyze`` — static pipeline verifier + codebase lint.

Counterpart of the JAX package's ``analyze/`` (``nns-lint``): proves a
pipeline description is well-formed *before* any thread or card
computation runs (caps negotiation at PAUSED, made a standalone pure
function), and keeps the port's own code honest with concurrency and
style passes.

A description is built on the ``meta`` device (``utils/device.py``):
tensors there carry a shape and no data, so opening a model runs its
forward for the output schema alone, nothing is computed and no CUDA
context is opened — the analyzer runs the same on a machine with a card
and on one without.

Passes / diagnostic families (catalog: ``diagnostics.CODES``,
docs: ``Documentation/analyze.md``):

1. graph verifier     — ``NNS1xx`` (:mod:`.graph`)
2. caps dry-run       — ``NNS2xx`` + ``NNS108`` (:mod:`.capsflow`)
3. concurrency + lint — ``NNS3xx``/``NNS4xx`` (:mod:`.codelint`)
4. lock-order analysis — ``NNS6xx`` (:mod:`.concurrency`): the static
   half of the concurrency correctness layer; the runtime half is the
   lockdep witness (``utils/lockdep.py``, ``NNS_TPU_TORCH_LOCKDEP=1``)

CLI: ``python -m nnstreamer_tpu_torch.analyze`` (``nns-torch-lint``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .capsflow import caps_dry_run
from .codelint import lint_package, lint_source
from .concurrency import LockGraph, analyze_package_concurrency, \
    lint_concurrency_source
from .diagnostics import CODES, Diagnostic, Severity, counts, \
    sort_diagnostics
from .graph import verify_graph

__all__ = [
    "CODES", "Diagnostic", "LockGraph", "Severity",
    "analyze_description", "analyze_package_concurrency",
    "analyze_pipeline", "caps_dry_run", "counts",
    "lint_concurrency_source", "lint_package", "lint_source",
    "sort_diagnostics", "verify_graph",
]


def analyze_pipeline(pipe, fragment: bool = False) -> List[Diagnostic]:
    """Run the graph verifier and the caps dry-run over an assembled (not
    started) Pipeline.  Pure: no threads, no element start, pad caps
    restored."""
    return sort_diagnostics(verify_graph(pipe, fragment)
                            + caps_dry_run(pipe, fragment))


def analyze_description(desc: str, fragment: bool = False
                        ) -> Tuple[List[Diagnostic], Optional[object]]:
    """Parse a ``gst-launch``-style description onto the ``meta`` device
    and analyze it.  Returns ``(diagnostics, pipeline-or-None)``; a
    description that does not parse yields a single NNS100/NNS103
    diagnostic pointing at the offending offset."""
    from ..runtime.parser import ParseError, parse_launch

    try:
        pipe = parse_launch(desc, device="meta")
    except ParseError as e:
        msg = str(e)
        code = "NNS103" if e.kind == "double-link" else "NNS100"
        hint = None
        if e.pos is not None:
            hint = e.context(desc)
        return [Diagnostic.make(
            code, msg,
            pad=None if e.pos is None else f"offset {e.pos}",
            hint=hint)], None
    except Exception as e:  # element constructor blew up on a bad prop
        return [Diagnostic.make(
            "NNS100", f"cannot build pipeline: "
            f"{type(e).__name__}: {e}")], None
    return analyze_pipeline(pipe, fragment), pipe
