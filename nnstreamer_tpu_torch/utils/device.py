"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU, and
asking for the card on a machine without one is an error — the port never
carries on quietly on the CPU.

The ``meta`` device places a pipeline for static verification only (the
analyzer, ``analyze/``): a tensor there has a shape and no data, so a
model's forward on it computes its output schema and nothing else, and
no CUDA context is opened.  Such a pipeline cannot start.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"``/``"gpu"``/``"cuda:N"``/``"cpu"``/``"meta"`` (or a
    ``torch.device``) → ``torch.device``; raises RuntimeError for a CUDA
    device when ``torch.cuda.is_available()`` is False."""
    if isinstance(device, str) and device.strip().lower() == "gpu":
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(
            f"unsupported device {dev} (expected cuda, cpu or meta)")
    return dev


_card = threading.local()
_hooks = None


def _obs_hooks():
    """``obs/hooks.py``, bound at the first card wait (the obs package
    imports this module)."""
    global _hooks
    from ..obs import hooks

    _hooks = hooks
    return hooks


def card_wait(fn, *args):
    """``fn(*args)``: a call that blocks until the card finished queued
    work (an event's ``synchronize``, a device→host copy, ``.item()``),
    its wall time added to this thread's card-wait clock
    (:func:`card_wait_seconds`).

    Every card wait on the port's paths goes through here, for the host
    profiler (``obs/prof.py``): a thread blocked in CUDA sits in C code
    with the caller's Python frame on top, so the sampler would count it
    as running.  With this function on top it is counted as waiting
    (``card_wait`` is one of the profiler's wait leaves), and the element
    loops move the clock's delta from their run side to their wait side.
    Under ``NNS_TPU_TORCH_OBS_DISABLE`` it is ``fn(*args)`` alone."""
    if (_hooks or _obs_hooks()).DISABLED:
        return fn(*args)
    t0 = time.monotonic()
    c0 = time.thread_time()
    try:
        return fn(*args)
    finally:
        _card.c = getattr(_card, "c", 0.0) + (time.thread_time() - c0)
        _card.s = getattr(_card, "s", 0.0) + (time.monotonic() - t0)


def card_wait_seconds() -> float:
    """Wall seconds this thread spent in :func:`card_wait` so far."""
    return getattr(_card, "s", 0.0)


def card_wait_cpu_seconds() -> float:
    """Thread CPU seconds spent inside :func:`card_wait` so far (a
    synchronize may spin while it waits)."""
    return getattr(_card, "c", 0.0)


def block_all(outs) -> None:
    """Wait until the card finished every tensor in ``outs``: one
    synchronize per CUDA device among them; CPU tensors are ready."""
    devices = {o.device for o in outs
               if isinstance(o, torch.Tensor) and o.is_cuda}
    for d in devices:
        card_wait(torch.cuda.synchronize, d)


def parse_accel_kind(accl: str) -> Optional[str]:
    """Device kind out of the reference's ``accelerator=`` grammar
    ("true:gpu", "gpu", "cuda", "cpu", "" = the pipeline's device).
    Returns "cuda", "cpu" or None."""
    kind = None
    for part in (accl or "").split(":"):
        p = part.strip().lower()
        if p in ("gpu", "cuda"):
            kind = "cuda"
        elif p == "cpu":
            kind = "cpu"
        elif p == "tpu":
            raise ValueError("accelerator=tpu: this port runs on cuda or cpu")
    return kind


def device_key(accelerator: str, device: Optional[torch.device]) -> str:
    """Where a filter with this ``accelerator=`` in a pipeline on
    ``device`` runs, as a key: two filters with the same key run on the
    same device (so they may share one model instance)."""
    kind = parse_accel_kind(accelerator)
    dev = torch.device(kind) if kind is not None else \
        (device if device is not None else torch.device("cuda"))
    return dev.type if dev.index in (None, 0) else str(dev)
