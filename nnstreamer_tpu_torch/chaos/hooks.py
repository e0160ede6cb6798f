"""Process-wide chaos hook: the one global the hot paths read.

Counterpart of the JAX package's ``chaos/hooks.py``, mirroring
:mod:`nnstreamer_tpu_torch.obs.hooks`: seams (the pool dispatch, the
filter's dispatch, the batching window) read ``plan`` ONCE per event and
do nothing when it is ``None``, so a process without chaos pays a single
attribute load per frame.  Install a plan with
:func:`nnstreamer_tpu_torch.chaos.install_plan`, or set
``NNS_TPU_TORCH_CHAOS``, read when the first pipeline starts.
"""

from __future__ import annotations

import os
from typing import Optional

from ..utils.conf import ENV_PREFIX

#: the environment key of the process-wide plan
CHAOS_ENV = f"{ENV_PREFIX}CHAOS"

#: the active FaultPlan, or None (chaos detached — the default)
plan = None

_env_checked = False


def maybe_install_from_env() -> None:
    """``NNS_TPU_TORCH_CHAOS=<spec>`` installs a process-wide plan when
    the first pipeline starts.  Checked once per process."""
    global _env_checked, plan
    if _env_checked:
        return
    _env_checked = True
    spec = os.environ.get(CHAOS_ENV, "").strip()
    if not spec or plan is not None:
        return
    from .plan import FaultPlan

    try:
        plan = FaultPlan.parse(spec)
    except ValueError as e:
        from ..utils.log import logw

        logw("ignoring malformed %s=%r: %s", CHAOS_ENV, spec, e)


def active_plan() -> Optional["object"]:
    return plan
