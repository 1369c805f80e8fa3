"""
Batched ALS solves for serving: fold-in of implicit-feedback users.

Port of the serving part of ``lkpy_tpu/ops/als.py``: :func:`implicit_otor`,
:func:`solve_implicit_bucket` and :func:`batched_spd_solve`.  The Gram
matrices and right-hand sides are plain batched matrix products in float32,
as JAX computes them outside any kernel; the SPD solve is the hand-written
kernel of :mod:`lkpy_tpu_torch.ops.spd_solve`.

Implicit ALS (Hu et al.):  A = (YᵀY + λI) + Gᵀ diag(c) G,   y = Gᵀ (c + 1).
"""

from __future__ import annotations

import torch

from lkpy_tpu_torch.ops.spd_solve import spd_solve

__all__ = ["batched_spd_solve", "implicit_otor", "solve_implicit_bucket"]


def batched_spd_solve(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = y`` for a batch of small SPD systems (B, k, k) × (B, k),
    through the SPD-solve kernel on the card (its plain version on the CPU)."""
    return spd_solve(A, y)


def solve_implicit_bucket(
    cols: torch.Tensor,  # (B, P) integer
    conf: torch.Tensor,  # (B, P) f32 — confidence deltas c = w*r (C_u − I)
    mask: torch.Tensor,  # (B, P) bool
    right: torch.Tensor,  # (n_right, k) f32
    otor: torch.Tensor,  # (k, k) = YᵀY + λI
) -> torch.Tensor:
    """One bucket of implicit-ALS row solves (Hu et al. confidence weighting);
    returns (B, k) solutions."""
    G = right[cols]  # (B, P, k) gather
    m = mask.to(right.dtype)
    cm = conf * m
    A = otor + torch.bmm((G * cm[:, :, None]).transpose(1, 2), G)
    y = torch.bmm(G.transpose(1, 2), ((conf + 1.0) * m)[:, :, None])[:, :, 0]
    return batched_spd_solve(A, y).to(right.dtype)


def implicit_otor(right: torch.Tensor, reg: float) -> torch.Tensor:
    """YᵀY + λI (reference: als/_implicit.py ``_implicit_otor``)."""
    k = right.shape[1]
    return right.T @ right + reg * torch.eye(k, dtype=right.dtype, device=right.device)
