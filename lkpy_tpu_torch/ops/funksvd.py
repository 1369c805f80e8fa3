"""
FunkSVD featurewise SGD.

Port of ``lkpy_tpu/ops/funksvd.py`` (reference: src/accel/funksvd.rs:66-128):
each latent feature trains by *minibatch* SGD, as in the JAX package —
per-batch errors, segment-summed gradients, one update of both columns a
batch — keeping the reference's featurewise structure, residual estimates,
trailing-value term and clamping.  Where the JAX package scans the batches
inside one compiled program, the port loops over batches and epochs in
Python, each step 14 kernels on the tensors' device (13 without a range),
with no host synchronization; the RMSE stays a device scalar.

The segment sums and the update are one ``index_add_`` a column, which
adds ``lr·g`` entry by entry where the JAX package adds ``lr·Σg``: the same
update, rounded otherwise.  On the CPU it adds in order, on the card with
float atomics, so there the order of a sum is not fixed.
"""

from __future__ import annotations

import math

import torch

__all__ = ["train_feature"]


def train_feature(
    users: torch.Tensor,
    items: torch.Tensor,
    ratings: torch.Tensor,
    mask: torch.Tensor,
    est: torch.Tensor,
    u_col: torch.Tensor,
    i_col: torch.Tensor,
    trail: float,
    lr: float,
    reg: float,
    rmin: float,
    rmax: float,
    n_users: int,
    n_items: int,
    epochs: int,
    batch: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train one latent feature; returns ``(u_col, i_col, rmse)``.

    Args:
        users: (N,) int64 user numbers, shuffled, N a multiple of ``batch``
            (padding slots point at user 0 and are masked).
        items: (N,) int64 item numbers.
        ratings: (N,) float32 ratings.
        mask: (N,) float32, 1 for a real rating and 0 for padding.
        est: (N,) float32 baseline plus the earlier features' products.
        u_col: (n_users,) float32 current feature column (not modified).
        i_col: (n_items,) float32 current feature column (not modified).
        trail: the trailing-value term of the features not yet trained.

    Returns:
        the trained columns and the last epoch's RMSE over the real ratings,
        a float32 device scalar (0 for ``epochs=0``).
    """
    n_batches = users.shape[0] // batch
    us, its = users.view(n_batches, batch), items.view(n_batches, batch)
    rs, ms, es = ratings.view(n_batches, batch), mask.view(n_batches, batch), est.view(n_batches, batch)
    # reg·mask, 0 on padding: uf·(reg·mask) is the JAX package's reg·uf·mask to the bit
    regm = (reg * mask).view(n_batches, batch)
    clamped = rmin > -math.inf or rmax < math.inf
    u_col, i_col = u_col.clone(), i_col.clone()
    sse = torch.zeros((), dtype=torch.float32, device=u_col.device)
    for _ in range(epochs):
        sses = torch.empty(n_batches, dtype=torch.float32, device=u_col.device)
        for b in range(n_batches):
            bu, bi = us[b], its[b]
            uf = u_col[bu]
            if_ = i_col[bi]
            pred = torch.addcmul(es[b], uf, if_) + trail
            if clamped:
                pred.clamp_(rmin, rmax)
            err = (rs[b] - pred).mul_(ms[b])
            # both gradients from the batch's old values, then both columns updated
            u_col.index_add_(0, bu, torch.addcmul(err * if_, uf, regm[b], value=-1.0), alpha=lr)
            i_col.index_add_(0, bi, torch.addcmul(err * uf, if_, regm[b], value=-1.0), alpha=lr)
            torch.dot(err, err, out=sses[b])
        sse = sses.sum()
    n_real = torch.clamp(mask.sum(), min=1.0)
    return u_col, i_col, torch.sqrt(sse / n_real)
