"""
Implicit-feedback ALS, plainly (Hu, Koren & Volinsky, ICDM 2008, as LensKit's
``ImplicitMFScorer`` states it).

With confidence ``c = weight`` for every observed pair and preference 1,
one row's factors solve the normal equations

    A = YᵀY + reg·I + weight · Σ_{i ∈ row} y_i y_iᵀ,     b = (1 + weight) · Σ_{i ∈ row} y_i,

over the opposite table ``Y``.  An epoch solves every user against the item
table, then every item against the new user table.  Fold-in solves the same
system for a history.  The rows are taken in blocks of equal padded width,
gathered with ``index_select`` and summed with ``torch.bmm``; the systems are
solved by Cholesky.  Everything is in the given precision
(:mod:`portbench.reference.precision`).
"""

from __future__ import annotations

import torch

from portbench.reference.precision import dtype_of, matmul

__all__ = ["csr", "epoch", "fold_in", "scores", "solve_rows"]

#: entries gathered at once: 2 M × k = 64 float64 is 1 GiB
BLOCK_ENTRIES = 1 << 21


def csr(rows: torch.Tensor, cols: torch.Tensor, n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row pointers and column numbers of the pairs ``(rows, cols)``."""
    order = torch.argsort(rows * (int(cols.max()) + 1) + cols)
    counts = torch.bincount(rows, minlength=n_rows)
    rowptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return rowptr, cols[order]


def solve_rows(rowptr, colind, right, reg: float, weight: float, precision: str, rows=None) -> torch.Tensor:
    """Each row's factors (``rows`` of the CSR, all by default) against ``right``."""
    dtype = dtype_of(precision)
    Y = right.to(dtype)
    k = Y.shape[1]
    eye = torch.eye(k, dtype=dtype, device=Y.device)
    otor = matmul(Y.T, Y, precision) + reg * eye
    if rows is None:
        rows = torch.arange(rowptr.shape[0] - 1, device=rowptr.device)
    lengths = rowptr[rows + 1] - rowptr[rows]
    out = torch.zeros((rows.shape[0], k), dtype=dtype, device=Y.device)
    by_len = torch.argsort(lengths)
    lens_sorted = lengths[by_len].tolist()
    start = 0
    while start < len(lens_sorted):
        width = max(1, 1 << (max(lens_sorted[start], 1) - 1).bit_length())
        stop = start
        while stop < len(lens_sorted) and lens_sorted[stop] <= width and (stop - start + 1) * width <= max(BLOCK_ENTRIES, width):
            stop += 1
        pos = by_len[start:stop]
        first = rowptr[rows[pos]]
        offs = torch.arange(width, device=Y.device)
        mask = offs[None, :] < lengths[pos][:, None]
        idx = torch.clamp(first[:, None] + offs[None, :], max=colind.shape[0] - 1)
        G = Y[colind[idx]] * mask[:, :, None].to(dtype)
        A = otor + weight * matmul(G.transpose(1, 2), G, precision)
        b = (1.0 + weight) * G.sum(dim=1)
        out[pos] = torch.cholesky_solve(b[:, :, None], torch.linalg.cholesky(A))[:, :, 0]
        start = stop
    return out


def epoch(users_csr, items_csr, U, V, reg: float, weight: float, precision: str):
    """One epoch from tables ``U`` (users) and ``V`` (items): the new ``(U, V)``."""
    U = solve_rows(*users_csr, V, reg, weight, precision)
    V = solve_rows(*items_csr, U, reg, weight, precision)
    return U, V


def fold_in(users_csr, users, V, reg: float, weight: float, precision: str) -> torch.Tensor:
    """The factors of ``users`` folded in from their histories against ``V``."""
    return solve_rows(*users_csr, V, reg, weight, precision, rows=users)


def scores(user_vecs, V, precision: str) -> torch.Tensor:
    """Every item's score for each user vector."""
    return matmul(user_vecs.to(dtype_of(precision)), V.to(dtype_of(precision)).T, precision)
