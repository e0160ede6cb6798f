"""Chaos engineering for the serving stack: deterministic fault injection
(:mod:`.plan`), the reconnect backoff + circuit breaker the edge links
share (:mod:`.retrypolicy`, steered by the actuator API), and the
process-wide hook the seams read (:mod:`.hooks`).

Counterpart of the JAX package's ``chaos/``.  The edge transports that
call the retry policy and ``FaultPlan.wire`` come with the port's edge
slice.
"""

from __future__ import annotations

from typing import Optional

from . import hooks as _hooks
from .plan import (
    FAULTS,
    INVOKE_FAULTS,
    QUEUE_FAULTS,
    WIRE_FAULTS,
    ChaosInvokeError,
    FaultPlan,
    FaultSpec,
    WireOp,
)
from .retrypolicy import BreakerOpen, RetryPolicy

__all__ = [
    "ChaosInvokeError", "FAULTS", "FaultPlan", "FaultSpec",
    "INVOKE_FAULTS", "QUEUE_FAULTS", "WIRE_FAULTS", "WireOp",
    "BreakerOpen", "RetryPolicy",
    "install_plan", "uninstall_plan", "active_plan",
]


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide: every seam starts consulting it."""
    _hooks.plan = plan
    return plan


def uninstall_plan() -> None:
    """Detach the process-wide plan (the seams go back to zero-cost)."""
    _hooks.plan = None


def active_plan() -> Optional[FaultPlan]:
    return _hooks.plan
