"""Operand roundings for the control: the reference computed one precision below
what a configuration states (`Reference.set_precision`).

- ``fp8``: e4m3 with one scale per tensor (amax to 448), as an fp8 matmul
  path would feed its operands: the step below a bf16 trunk.
- ``tf32``: 10 mantissa bits, rounded to nearest, as the tensor cores read
  fp32 operands with TF32 on: the step below fp32 with TF32 off.
- ``bf16``: 7 mantissa bits: the step below fp32 that already runs in TF32.

Each returns fp32, so the products still accumulate in fp32 as on the card.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    d = t.detach()
    scale = d.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return t + ((d / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale - d)


def tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.detach().float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return t + (rounded - t).detach()


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t + (t.detach().to(torch.bfloat16).to(t.dtype) - t).detach()


BY_NAME = {"fp8": fp8, "tf32": tf32, "bf16": bf16}
