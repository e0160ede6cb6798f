"""Tracer hook state — the runtime-facing side of ``obs``.

Counterpart of the JAX package's ``obs/hooks.py``.  Deliberately tiny and
stdlib-only: the runtime hot path (``runtime/element.py``,
``runtime/batching.py``, ``elements/basic.py``, the filter and the pool)
imports it at module load and guards every hook site with one global
read::

    from ..obs import hooks as _hooks
    ...
    t = _hooks.tracer
    if t is not None:
        t.pre_chain(self, buf)

With no tracer attached (the default) a hook site costs one attribute
load and one ``is None`` branch: no allocation, no callback, no
per-buffer state (``tests/test_torch_obs.py`` holds it).
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils.conf import ENV_PREFIX

#: the environment key of the global kill switch
DISABLE_ENV = f"{ENV_PREFIX}OBS_DISABLE"


def _env_disabled() -> bool:
    return os.environ.get(DISABLE_ENV, "").strip() not in ("", "0")


#: ``NNS_TPU_TORCH_OBS_DISABLE=1`` turns the whole obs layer off for the
#: process: tracer attach no-ops, the blocking stats samples stop (so a
#: dispatch never waits for the card and keeps no output alive for the
#: next sample), the transfer ledger, cost capture, tenant and stage
#: stores and the flight recorder stay inert.  Read once at import.
DISABLED: bool = _env_disabled()

#: the attached tracer (``obs.tracer.LatencyTracer``-shaped), or None.
#: Read unlocked on the hot path; a stale read costs at most one
#: traced/untraced buffer.
tracer: Optional[object] = None


def obs_disabled() -> bool:
    """Whether the kill switch is set, re-reading the environment (the
    hot paths use the import-time :data:`DISABLED` instead)."""
    return DISABLED or _env_disabled()


def attach(t) -> None:
    """Attach ``t`` as the process-wide tracer (replaces any previous).
    A no-op while the kill switch is set."""
    global tracer
    if DISABLED:
        return
    tracer = t


def detach() -> None:
    global tracer
    tracer = None
