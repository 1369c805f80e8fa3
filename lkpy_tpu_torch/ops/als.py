"""
Batched ALS solves: training epochs and fold-in.

Port of ``lkpy_tpu/ops/als.py`` (reference: src/accel/als/explicit.rs:54,81
and src/accel/als/implicit.rs:26; LAPACK ``sposv`` per row via
src/accel/als/solve.rs:47).  Rows are bucketed by length into padded
batches (:func:`lkpy_tpu_torch.ops.sparse.bucket_rows`) and cut into
fixed-shape chunks (:func:`chunk_buckets`), which stay on the device across
epochs.  Each chunk of a half-epoch

1. forms the per-row normal equations with the hand-written gather-and-Gram
   kernel (:mod:`lkpy_tpu_torch.ops.gather_gram`): it reads the
   opposite-side factor rows ``right[cols]`` by index into shared memory and
   sums A's lower triangle and y in float32 registers, so the gathered
   (B, P, k) rows never reach device memory (the JAX package gathers with
   XLA and forms them with einsums; the plain version, on the CPU, is
   ``index_select``, a weighted copy and two ``torch.bmm``),
2. solves them with the hand-written training kernel
   (:mod:`lkpy_tpu_torch.ops.spd_solve_chunked`, the port of the TPU's
   ``pallas_gj`` kernel; its plain version on the CPU),
3. scatters the real rows' solutions into the factor table and adds their
   change to the update delta.

Fold-in of serving (:func:`solve_implicit_bucket`,
:func:`solve_explicit_bucket`, and :func:`solve_row_implicit`,
:func:`solve_row_explicit` for one query) forms its equations with the same
kernel and solves them through the fold-in kernel of
:mod:`lkpy_tpu_torch.ops.spd_solve`.

Explicit ALS (reference explicit.rs:81):  A = GᵀG + λ·n_u·I,  y = Gᵀ r.
Implicit ALS (reference implicit.rs:26, Hu et al.):
  A = (YᵀY + λI) + Gᵀ diag(c) G,   y = Gᵀ (c + 1),   c = w·r.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.ops.gather_gram import gather_gram
from lkpy_tpu_torch.ops.sparse import PaddedRowMatrix
from lkpy_tpu_torch.ops.spd_solve import spd_solve
from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked

__all__ = [
    "ChunkedRows",
    "als_epoch",
    "als_half_epoch",
    "batched_spd_solve",
    "chunk_buckets",
    "chunk_stats",
    "epoch_flops",
    "implicit_otor",
    "solve_explicit_bucket",
    "solve_implicit_bucket",
    "solve_row_explicit",
    "solve_row_implicit",
]

#: row number of the padding rows that fill a bucket's last chunk
INT32_MAX = int(np.iinfo(np.int32).max)

# a chunk holds about 4M entries, as the JAX package's bound on its live
# (B, P, k) gathered-factor tensor (1 GB at k=64 f32); the port's kernel
# gathers into shared memory, so the bound now sets only the launch size
_CHUNK_ENTRIES = 4_000_000


def batched_spd_solve(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = y`` for a batch of small SPD systems (B, k, k) × (B, k),
    through the fold-in SPD-solve kernel on the card (its plain version on
    the CPU): in registers over 32, 64 or 128 threads a system for k ≤ 128,
    the mapping chosen from (B, k) by ``ops/spd_solve.py::fold_route``, in
    shared memory above."""
    return spd_solve(A, y)


def solve_explicit_bucket(
    cols: torch.Tensor,  # (B, P) integer
    vals: torch.Tensor,  # (B, P) f32 (normalized ratings)
    mask: torch.Tensor,  # (B, P) bool
    right: torch.Tensor,  # (n_right, k) f32
    reg: float,
) -> torch.Tensor:
    """One bucket of explicit-ALS row solves; returns (B, k) solutions (a row
    without entries has A = 0 and a non-finite solution)."""
    A, y = gather_gram(cols, vals, mask, right, reg=reg)
    return batched_spd_solve(A, y).to(right.dtype)


def solve_implicit_bucket(
    cols: torch.Tensor,  # (B, P) integer
    conf: torch.Tensor,  # (B, P) f32 — confidence deltas c = w*r (C_u − I)
    mask: torch.Tensor,  # (B, P) bool
    right: torch.Tensor,  # (n_right, k) f32
    otor: torch.Tensor,  # (k, k) = YᵀY + λI
) -> torch.Tensor:
    """One bucket of implicit-ALS row solves (Hu et al. confidence weighting);
    returns (B, k) solutions."""
    A, y = gather_gram(cols, conf, mask, right, otor=otor)
    return batched_spd_solve(A, y).to(right.dtype)


def implicit_otor(right: torch.Tensor, reg: float) -> torch.Tensor:
    """YᵀY + λI (reference: als/_implicit.py ``_implicit_otor``)."""
    k = right.shape[1]
    return right.T @ right + reg * torch.eye(k, dtype=right.dtype, device=right.device)


class ChunkedRows(NamedTuple):
    """A padded row bucket reshaped into fixed-shape chunks, on the device.

    ``rows[c, b]`` is the original row number of slot (c, b).  The bucket's
    ``n_real`` real rows fill the first slots of ``rows.reshape(-1)``; the
    padding rows after them carry row number INT32_MAX (out of range for any
    table) and no entries.
    """

    rows: torch.Tensor  # (C, B) int32
    cols: torch.Tensor  # (C, B, P) int32
    values: torch.Tensor  # (C, B, P) f32
    mask: torch.Tensor  # (C, B, P) bool
    n_real: int

    def real_rows(self, c: int) -> int:
        """How many of chunk ``c``'s slots hold real rows (they come first)."""
        B = self.rows.shape[1]
        return max(0, min(B, self.n_real - c * B))


def chunk_buckets(
    buckets: list[PaddedRowMatrix],
    *,
    entries: int = _CHUNK_ENTRIES,
    device: str | torch.device | None = None,
) -> tuple[ChunkedRows, ...]:
    """Reshape padded buckets into fixed-shape chunks and upload them.

    Each bucket of width P is split into C chunks of B ≈ ``entries // P``
    rows.  The chunk count is picked first and the chunks are then sized to
    fit, so a bucket gains fewer than 8 padding rows per chunk (each costs
    a full solve).  The arrays go to ``device`` (the card unless
    ``device="cpu"``) once; the trainer keeps them there across epochs.
    """
    dev = resolve_device(device)
    out = []
    for b in buckets:
        Bn, P = b.cols.shape
        step0 = max(entries // max(P, 1), 8)
        C = max(-(-Bn // step0), 1)
        step = -(-Bn // (C * 8)) * 8
        pad = C * step - Bn
        rows = np.pad(b.rows, (0, pad), constant_values=INT32_MAX)
        cols = np.pad(b.cols, ((0, pad), (0, 0)))
        mask = np.pad(b.mask, ((0, pad), (0, 0)))
        vals = mask.astype(np.float32) if b.values is None else np.pad(b.values, ((0, pad), (0, 0)))
        out.append(
            ChunkedRows(
                torch.from_numpy(rows.reshape(C, step)).to(dev),
                torch.from_numpy(cols.reshape(C, step, P)).to(dev),
                torch.from_numpy(vals.reshape(C, step, P)).to(dev),
                torch.from_numpy(mask.reshape(C, step, P)).to(dev),
                Bn,
            )
        )
    return tuple(out)


def chunk_stats(chunks: tuple[ChunkedRows, ...]) -> dict:
    """Padding occupancy of a set of chunked buckets.

    ``occupancy`` is real entries / padded entries: every padded entry costs
    a gather and Gram work; padding rows also cost whole solves."""
    entries = real = rows = real_rows = 0
    for ch in chunks:
        C, B, P = ch.cols.shape
        entries += C * B * P
        real += int(ch.mask.sum())
        rows += C * B
        real_rows += int((ch.rows < INT32_MAX).sum())
    return {
        "padded_entries": entries,
        "real_entries": real,
        "occupancy": real / entries if entries else 1.0,
        "padded_rows": rows,
        "real_rows": real_rows,
        "row_occupancy": real_rows / rows if rows else 1.0,
    }


def epoch_flops(u_stats: dict, i_stats: dict, k: int, *, useful: bool) -> float:
    """Flops of one ALS epoch (both halves): 2·k² multiply-adds = 4·k² flops
    per (entry) of the Gram, k³/3 per row solve (the Cholesky count).
    ``useful`` counts only real entries and rows; padded counts give the
    work the device actually does."""
    e_u = u_stats["real_entries" if useful else "padded_entries"]
    e_i = i_stats["real_entries" if useful else "padded_entries"]
    r_u = u_stats["real_rows" if useful else "padded_rows"]
    r_i = i_stats["real_rows" if useful else "padded_rows"]
    gram = 2.0 * (e_u + e_i) * k * k * 2.0
    solves = (r_u + r_i) * (k**3) / 3.0
    return gram + solves


def _solve_chunk(cols, values, mask, right, otor, reg, mode: str) -> torch.Tensor:
    """One chunk's row solves through the training kernel: (B, k)."""
    A, y = gather_gram(cols, values, mask, right, **({"otor": otor} if mode == "implicit" else {"reg": reg}))
    return spd_solve_chunked(A, y)


def _run_half(left, right, reg: float, chunks, mode: str):
    """One half-epoch: solve every chunk against ``right`` and write the
    real rows into a copy of ``left``.

    Only each chunk's real rows (a prefix of its slots, known on the host)
    are read from ``left`` and written back, so the padding rows' solutions,
    which are NaN in explicit mode (A = 0), never reach the table or the
    delta, and no index is out of range.  Nothing here waits for the
    device: the squared delta stays a device scalar.
    """
    if mode not in ("implicit", "explicit"):
        raise ValueError(f"unknown ALS mode {mode!r}")
    left = left.clone()
    otor = implicit_otor(right, reg) if mode == "implicit" else None
    dsq = torch.zeros((), dtype=torch.float32, device=left.device)
    for ch in chunks:
        for c in range(ch.rows.shape[0]):
            nv = ch.real_rows(c)
            if nv == 0:
                continue
            x = _solve_chunk(ch.cols[c], ch.values[c], ch.mask[c], right, otor, reg, mode)[:nv]
            rows = ch.rows[c, :nv]
            dsq = dsq + torch.sum(torch.square(x - left[rows]))
            left[rows] = x
    return left, dsq


def _as_chunks(buckets, device: torch.device) -> tuple[ChunkedRows, ...]:
    if buckets and isinstance(buckets[0], PaddedRowMatrix):
        return chunk_buckets(buckets, device=device)
    return tuple(buckets)


def als_half_epoch(
    buckets,
    left: torch.Tensor,
    right: torch.Tensor,
    reg: float,
    *,
    mode: str,
) -> tuple[torch.Tensor, float]:
    """
    Solve one side of an ALS iteration.

    Args:
        buckets: padded row buckets (or pre-built :func:`chunk_buckets`
            output) of the interaction matrix (values are normalized ratings
            for explicit, confidence deltas for implicit).
        left: (n_left, k) factor table being updated (not modified).
        right: (n_right, k) fixed factor table.
        reg: regularization strength.
        mode: "explicit" or "implicit".

    Returns:
        (updated left table, Frobenius norm of the update delta) — the delta
        matches the reference's convergence metric (explicit.rs ``frob``).
    """
    chunks = _as_chunks(buckets, left.device)
    left, delta_sq = _run_half(left, right, reg, chunks, mode)
    return left, float(torch.sqrt(delta_sq))


def als_epoch(
    u_buckets,
    i_buckets,
    u: torch.Tensor,
    i: torch.Tensor,
    u_reg: float,
    i_reg: float,
    *,
    mode: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    One full ALS epoch (user half, then item half), without waiting for the
    device: the returned update deltas are device scalars — convert them
    with ``float`` only where a convergence check needs them.
    ``u_buckets``/``i_buckets`` may be bucket lists or pre-built
    :func:`chunk_buckets` tuples (pass the latter to avoid re-chunking and
    re-uploading every epoch).  ``u`` and ``i`` are not modified.
    """
    u_chunks = _as_chunks(u_buckets, u.device)
    i_chunks = _as_chunks(i_buckets, i.device)
    u, du = _run_half(u, i, u_reg, u_chunks, mode)
    i, di = _run_half(i, u, i_reg, i_chunks, mode)
    return u, i, torch.sqrt(du), torch.sqrt(di)


# ---- single-row (fold-in) solves of per-query scoring ----------------------
# One user's history as a bucket of one row, on the device of ``right``: on the
# card one gather-and-Gram launch and one fold-in solve (B2), with the tables
# left there.
def _one_row(item_nums: torch.Tensor, right: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    cols = item_nums.reshape(1, -1)
    return cols, torch.ones(cols.shape, dtype=torch.bool, device=right.device)


def solve_row_explicit(item_nums: torch.Tensor, ratings: torch.Tensor, right: torch.Tensor, reg: float) -> torch.Tensor:
    """Fold-in solve for one user's normalized ratings (reference:
    als/_explicit.py:121 ``_train_bias_row_cholesky``): (k,) on the device of
    ``right``; zeros for an empty history."""
    if len(item_nums) == 0:
        return torch.zeros(right.shape[1], dtype=right.dtype, device=right.device)
    cols, mask = _one_row(item_nums, right)
    return solve_explicit_bucket(cols, ratings.reshape(1, -1).to(right.dtype), mask, right, reg)[0]


def solve_row_implicit(item_nums: torch.Tensor, conf: torch.Tensor, right: torch.Tensor, otor: torch.Tensor) -> torch.Tensor:
    """Fold-in solve for one user's confidence values (reference:
    als/_implicit.py:97 ``_train_new_row``): (k,) on the device of
    ``right``; zeros for an empty history."""
    if len(item_nums) == 0:
        return torch.zeros(right.shape[1], dtype=right.dtype, device=right.device)
    cols, mask = _one_row(item_nums, right)
    return solve_implicit_bucket(cols, conf.reshape(1, -1).to(right.dtype), mask, right, otor)[0]
