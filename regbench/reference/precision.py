"""The control's precision: TF32, the step below float32 that would tempt
a faster version (float32 products whose operands keep 10 mantissa bits).

:func:`tf32_matmul` rounds the operands to 10 mantissa bits and multiplies
them in float32, which is what a TF32 product does.  It does so on every
device: on the card cuBLAS runs a product of inner size 3 on its float32
cores even with TF32 allowed (measured: the program with
``allow_tf32 = True`` read the same spacing to the last bit), so switching
TF32 on would not make the control.
"""
from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits (to
    nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of float32 tensors as TF32 computes it."""
    return tf32_round(a.to(torch.float32)) @ tf32_round(b.to(torch.float32))


def expansion_d2(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(S, T) squared distances |q|^2 - 2 q.r + |r|^2 in float32 with the
    product in TF32, clamped at 0: the distance form a matrix product
    gives."""
    q, r = q.to(torch.float32), r.to(torch.float32)
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    rr = torch.sum(r * r, dim=-1)
    return torch.clamp(qq - 2.0 * tf32_matmul(q, r.T) + rr[None], min=0.0)
