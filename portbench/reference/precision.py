"""
The precisions the references compute in.

``float64`` is the reference.  The lower ones are the controls of the
comparison: ``tf32`` keeps float32 tensors and rounds both operands of every
matrix product to TF32's 10-bit mantissa (round to nearest), as the tensor
cores do, so it reads the same on the CPU and on the card.
"""

from __future__ import annotations

import torch

__all__ = ["PRECISIONS", "dtype_of", "matmul", "tf32_round"]

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value: 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` (batched where the operands are) in ``precision``."""
    if precision == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    return torch.matmul(a, b)
