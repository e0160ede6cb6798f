"""Hardware peak table — the denominator of every utilization figure.

Counterpart of the JAX package's ``obs/hwspec.py``: MFU and HBM-bandwidth
utilization are ratios against the card's published peaks, and this
module is their one source (``chip_smoke.py`` reads its bounds from here,
so a kernel's roofline share and ``nns_mfu`` share a denominator).

The port's cards resolve by ``torch.cuda.get_device_name()``:

- ``NVIDIA H100 80GB HBM3`` (SXM, 700 W): 989.4e12 FLOP/s dense bf16 and
  3.35e12 B/s HBM3 (NVIDIA's H100 data sheet);
- ``H100 PCIe``: 756e12 FLOP/s dense bf16 and 2.0e12 B/s.

The rates assume the card's full power limit; a card set below it runs
slower under load, so figures are quoted beside ``nvidia-smi``'s
``power.limit``.  An unknown name, and the CPU, resolve to ``None``: cost
capture still exports flops, bytes and intensity, but no utilization is
derived, because a made-up peak would be worse than none.
:func:`set_override` pins a spec explicitly (tests, what-if modeling).

No price is guessed: ``chip_hour_usd`` is 0.0 in every row, and the
tenant dollars read ``NNS_TPU_TORCH_CHIP_HOUR_USD`` (:func:`chip_hour_price`).
The ``tpu`` row is the JAX package's v5e figure, kept as data so the
parity tests can pin both packages to one spec; no port figure is quoted
against it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional

from ..utils.conf import ENV_PREFIX

#: the environment key of the chip-hour price
PRICE_ENV = f"{ENV_PREFIX}CHIP_HOUR_USD"


@dataclasses.dataclass(frozen=True)
class HwSpec:
    """Public peak figures of one accelerator."""

    name: str
    peak_flops: float        #: dense bf16 peak, FLOP/s per chip
    hbm_bw: float            #: HBM bandwidth, bytes/s per chip
    ici_bw: float = 0.0      #: chip-to-chip bandwidth, bytes/s per chip
    chip_hour_usd: float = 0.0  #: $/chip-hour (0.0: not known)

    @property
    def ridge(self) -> float:
        """Roofline ridge point (flops/byte): programs above it are
        compute-bound, below it bandwidth-bound."""
        return self.peak_flops / self.hbm_bw if self.hbm_bw else 0.0


#: H100 SXM5 80 GB (NVIDIA H100 data sheet, dense, 700 W)
H100_SXM = HwSpec(name="h100-sxm", peak_flops=989.4e12, hbm_bw=3.35e12)
#: H100 PCIe 80 GB (NVIDIA H100 data sheet, dense, 350 W)
H100_PCIE = HwSpec(name="h100-pcie", peak_flops=756e12, hbm_bw=2.0e12)

#: the JAX package's v5e row (197 TFLOP/s bf16, 819 GB/s), data only
V5E = HwSpec(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
             ici_bw=200e9, chip_hour_usd=1.20)

#: substring of ``torch.cuda.get_device_name()`` -> spec, first match
#: wins (the PCIe part's name also contains "H100")
DEVICE_SPECS = (
    ("H100 PCIe", H100_PCIE),
    ("H100 80GB HBM3", H100_SXM),
    ("H100 SXM", H100_SXM),
)

#: platform tag -> spec for the tags that are not card names
PLATFORM_SPECS: Dict[str, Optional[HwSpec]] = {
    "tpu": V5E,
    "cpu": None,
}

_lock = threading.Lock()
_override: Optional[HwSpec] = None


def set_override(spec: Optional[HwSpec]) -> Optional[HwSpec]:
    """Pin the spec every utilization derivation uses (None clears it).
    Returns the previous override so tests can restore it."""
    global _override
    with _lock:
        prev = _override
        _override = spec
    return prev


def spec_for_device_name(name: Optional[str]) -> Optional[HwSpec]:
    """The row of a card by its ``torch.cuda.get_device_name()``, or None
    for an unknown card."""
    for key, spec in DEVICE_SPECS:
        if key in str(name or ""):
            return spec
    return None


def device_platform(device) -> str:
    """The platform tag cost rows carry: the card's name for a CUDA
    device (what :func:`spec_for_platform` resolves), ``cpu`` otherwise."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def spec_for_platform(platform: Optional[str]) -> Optional[HwSpec]:
    """The peak table entry for a platform tag (``cpu``, ``tpu``) or a
    card name, or None when the hardware is unknown (no utilization is
    derived).  An override wins."""
    with _lock:
        if _override is not None:
            return _override
    tag = str(platform or "")
    if tag.lower() in PLATFORM_SPECS:
        return PLATFORM_SPECS[tag.lower()]
    return spec_for_device_name(tag)


def chip_hour_price(platform: Optional[str] = None) -> float:
    """The $/chip-hour the tenant dollars multiply device-seconds by:
    ``NNS_TPU_TORCH_CHIP_HOUR_USD``, then the spec's own figure (0.0 for
    every card row).  0.0 when nothing sets a price — the tenant table
    still carries device-seconds."""
    env = os.environ.get(PRICE_ENV, "").strip()
    if env:
        try:
            return max(float(env), 0.0)
        except ValueError:
            pass  # a malformed override must not break a scrape
    spec = spec_for_platform(platform)
    return spec.chip_hour_usd if spec is not None else 0.0
