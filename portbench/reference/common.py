"""What every plain reference shares: the input normalization, the
lower-precision operand rounding of the control, TF32 off, and the seeded
generators the weights and frames are drawn from.

Plain ``torch`` only: nothing here imports the program under test.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import torch

#: the largest finite float8 e4m3 value
FP8_MAX = 448.0


def no_tf32() -> None:
    """Float32 products stay float32 on the card (TF32 would round each
    operand to 10 mantissa bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``: any
    whole number, negative or past 64 bits included, maps to one."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def normalize(frames_u8: torch.Tensor, sub: float, div: float) -> torch.Tensor:
    """uint8 frames → float32 ``(x - sub) / div``."""
    return (frames_u8.to(torch.float32) - sub) / div


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude maps to 448), back in float32: what an fp8
    product's operand holds."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def operand_cast(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding applied to both operands of every convolution and
    matrix product: none for ``float32`` (the reference), e4m3 for
    ``fp8`` (the control, the precision below the configurations'
    bfloat16)."""
    if precision == "float32":
        return lambda t: t
    if precision == "fp8":
        return fp8_round
    raise ValueError(f"unknown reference precision {precision!r}")
