"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU, and
asking for the card on a machine without one is an error — the port never
carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"``/``"gpu"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``)
    → ``torch.device``; raises RuntimeError for a CUDA device when
    ``torch.cuda.is_available()`` is False."""
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
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


def block_all(outs) -> None:
    """Wait until the card finished every tensor in ``outs``: one
    synchronize per CUDA device among them; CPU tensors are ready."""
    devices = {o.device for o in outs
               if isinstance(o, torch.Tensor) and o.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


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
