"""Shared helpers for the model importers (tflite/tf/onnx): a copy of
the JAX package's ``filters/importer_util.py``.

The importers rebuild graphs that were exported at batch 1; keeping
them batch-flexible without silently regrouping interior reshapes is a
shared contract, implemented once here so the importers cannot drift.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def batch_flex_target(tgt: Tuple[int, ...],
                      value_shape: Sequence[int],
                      batch: int,
                      recorded_src: Optional[Sequence[int]] = None
                      ) -> Tuple[int, ...]:
    """Rewrite a concrete reshape target exported at batch 1 to be
    batch-flexible — ``(1, ...) -> (-1, ...)`` — ONLY when the leading
    1 is actually the batch dim:

    * the graph recorded a static source shape that also leads with
      the batch (``recorded_src[0] == 1``), i.e. a pure per-sample
      regroup; or
    * no static source shape is available, but the runtime value's
      per-sample element count matches the target's
      (``prod(value_shape)/batch == prod(tgt[1:])``).

    An interior reshape whose leading 1 is a genuine dimension keeps
    its concrete shape and fails loudly at batch > 1 instead of
    silently regrouping elements.
    """
    if tgt and tgt[0] == 1 and -1 in tgt[1:]:
        # wildcard tail (e.g. ONNX's (1, -1)): the per-sample count is
        # unknowable, but a leading 1 alongside a tail wildcard can
        # only mean the batch — pin it to the runtime batch so the
        # wildcard resolves per sample
        b = max(int(batch), 1)
        if int(np.prod(value_shape)) % b == 0:
            return (b,) + tgt[1:]
        return tgt
    if not (tgt and tgt[0] == 1 and -1 not in tgt[1:]):
        return tgt
    has_src = recorded_src is not None and len(recorded_src) > 0
    if has_src:
        ok = recorded_src[0] == 1
    else:
        b = max(int(batch), 1)
        total = int(np.prod(value_shape))
        ok = (total % b == 0
              and total // b == int(np.prod(tgt[1:])))
    return (-1,) + tgt[1:] if ok else tgt


def parse_custom_prop(custom: str, key: str, default: str) -> str:
    """Extract ``key:<value>`` from a tensor_filter ``custom=`` string
    (comma-separated ``k:v`` pairs, whitespace tolerated) — shared by
    the importer front ends so the grammar cannot drift."""
    for kv in (custom or "").split(","):
        kv = kv.strip()
        if kv.startswith(key + ":"):
            return kv.split(":", 1)[1].strip()
    return default
