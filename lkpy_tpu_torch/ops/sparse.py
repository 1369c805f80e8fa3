"""
Sparse layouts.

Port of ``lkpy_tpu/ops/sparse.py``:

- :class:`DeviceCOO`: flat (row, col, value) tensors on a device, the
  examples the gradient-family trainers batch from.
- :class:`PaddedRowMatrix`, :func:`pad_rows` and :func:`bucket_rows` with
  its geometric width ladder: padded rows for batched per-row solves.  They
  run on the host in NumPy and give the same arrays as the JAX package;
  :func:`lkpy_tpu_torch.ops.als.chunk_buckets` cuts the buckets into
  fixed-shape chunks and uploads them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data.matrix import CSR

__all__ = ["DeviceCOO", "PaddedRowMatrix", "pad_rows", "bucket_rows", "round_up"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class DeviceCOO(NamedTuple):
    """Flat COO tensors on a device (int32 indices, float32 values)."""

    row: torch.Tensor  # (nnz,) int32
    col: torch.Tensor  # (nnz,) int32
    values: torch.Tensor | None  # (nnz,) float32
    shape: tuple[int, int]

    @classmethod
    def from_csr(cls, csr: CSR, field: str | None = "rating", device: str | torch.device | None = None) -> "DeviceCOO":
        """The entries of ``csr`` in row-major order on ``device`` (the card
        unless ``"cpu"``), with the values of ``field`` (the CSR's own
        values for ``"rating"`` or a field it lacks; none for None)."""
        dev = resolve_device(device)
        coo = csr.to_coo()
        if field is None:
            vals = None
        elif field == "rating" or field not in csr.fields:
            vals = coo.values
        else:
            vals = csr.fields[field]
        return cls(
            torch.as_tensor(coo.row.astype(np.int32), device=dev),
            torch.as_tensor(coo.col.astype(np.int32), device=dev),
            None if vals is None else torch.as_tensor(np.asarray(vals, dtype=np.float32), device=dev),
            csr.shape,
        )

    @property
    def nnz(self) -> int:
        return self.row.shape[0]


@dataclass(frozen=True)
class PaddedRowMatrix:
    """
    Rows padded to fixed width ``P`` with a validity mask (NumPy arrays).

    ``cols[i, j]`` is the j-th column index of row ``rows[i]`` (0 where
    padded), ``mask`` marks real entries.  ``rows`` maps padded slots back to
    original row numbers (identity when all rows are present).
    """

    rows: np.ndarray  # (B,) int32 original row numbers
    cols: np.ndarray  # (B, P) int32
    values: np.ndarray | None  # (B, P) float32
    mask: np.ndarray  # (B, P) bool
    shape: tuple[int, int]  # original (nrows, ncols)

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @property
    def n(self) -> int:
        return self.cols.shape[0]


def _value_source(csr: CSR, field: str | None) -> np.ndarray | None:
    if field is None:
        return None
    if field == "rating":
        return csr.values
    return csr.fields.get(field)


def pad_rows(
    csr: CSR,
    *,
    width: int | None = None,
    align: int = 8,
    rows: np.ndarray | None = None,
    field: str | None = "rating",
) -> PaddedRowMatrix:
    """
    Pad CSR rows into a dense (B, P) layout.

    Args:
        csr: the host CSR matrix.
        width: pad width (default: max row length, rounded up to ``align``).
        rows: specific row numbers to extract (default all).
        field: value field name ("rating" = CSR values; None = structural).
    """
    if rows is None:
        rows = np.arange(csr.nrows, dtype=np.int32)
    rows = np.asarray(rows, dtype=np.int32)
    lens = (csr.rowptr[rows + 1] - csr.rowptr[rows]).astype(np.int64)
    maxlen = int(lens.max()) if len(lens) else 0
    P = width if width is not None else max(round_up(max(maxlen, 1), align), align)
    if maxlen > P:
        raise ValueError(f"row length {maxlen} exceeds pad width {P}")
    B = len(rows)
    cols = np.zeros((B, P), dtype=np.int32)
    vsrc = _value_source(csr, field)
    vals = np.zeros((B, P), dtype=np.float32) if vsrc is not None else None
    # vectorized fill via flat gather
    starts = csr.rowptr[rows]
    idx = np.arange(P)[None, :]
    valid = idx < lens[:, None]
    src = np.minimum(starts[:, None] + idx, csr.nnz - 1 if csr.nnz else 0)
    if csr.nnz:
        cols = np.where(valid, csr.colind[src], 0).astype(np.int32)
        if vals is not None:
            vals = np.where(valid, vsrc[src], 0.0).astype(np.float32)
    return PaddedRowMatrix(rows, cols, vals, valid, csr.shape)


_FINE_LADDER_BELOW = 32_768


def _width_ladder(min_width: int, cap: int, ratio: float) -> list[int]:
    """Geometric bucket-width ladder.  ``ratio=2.0`` is the classic
    power-of-two ladder (worst-case occupancy 0.5); smaller ratios insert
    mid widths, which pad less but make more buckets.  Above
    ``_FINE_LADDER_BELOW`` the ladder steps ×2: rows that wide are so few
    that padding there is noise."""
    widths = [min_width]
    while widths[-1] < cap:
        r = ratio if widths[-1] < _FINE_LADDER_BELOW else 2.0
        nxt = int(widths[-1] * r)
        nxt = round_up(nxt, 8 if nxt >= 16 else 4)
        if nxt <= widths[-1]:
            nxt = widths[-1] * 2
        widths.append(nxt)
    return widths


def bucket_rows(
    csr: CSR,
    *,
    min_width: int = 8,
    max_width: int | None = None,
    field: str | None = "rating",
    ratio: float = 2.0,
) -> list[PaddedRowMatrix]:
    """
    Group the non-empty rows into geometric-width buckets and pad each
    bucket, so every bucket has one static shape; padding waste per bucket
    is < (1 − 1/ratio).  Rows longer than ``max_width`` are truncated to
    their ``max_width`` first entries (callers that must not truncate pass
    ``max_width=None``).  Every padded slot costs a factor-row gather and
    Gram work on the ALS path, so ``ratio`` trades that waste against the
    number of buckets (:func:`_width_ladder`).
    """
    lens = csr.row_lengths()
    nonempty = np.nonzero(lens > 0)[0].astype(np.int32)
    if len(nonempty) == 0:
        return []
    buckets: list[PaddedRowMatrix] = []
    blens = lens[nonempty]
    cap = int(blens.max())
    if max_width is not None:
        cap = min(cap, max_width)
    done = np.zeros(len(nonempty), dtype=bool)
    for width in _width_ladder(min_width, cap, ratio):
        if max_width is not None and width >= max_width:
            sel = ~done
            width = max_width
        else:
            sel = (~done) & (blens <= width)
        rows = nonempty[sel]
        if len(rows):
            if max_width is not None and width == max_width and int(blens[sel].max()) > width:
                buckets.append(_pad_truncate(csr, rows, width, field))
            else:
                buckets.append(pad_rows(csr, width=width, rows=rows, field=field))
            done |= sel
        if done.all():
            break
    return buckets


def _pad_truncate(csr: CSR, rows: np.ndarray, width: int, field: str | None) -> PaddedRowMatrix:
    """Pad rows, truncating over-long rows to their first ``width`` entries."""
    B = len(rows)
    cols = np.zeros((B, width), dtype=np.int32)
    mask = np.zeros((B, width), dtype=bool)
    vsrc = _value_source(csr, field)
    vals = np.zeros((B, width), dtype=np.float32) if vsrc is not None else None
    for b, r in enumerate(rows):
        s, e = csr.row_extent(int(r))
        n = min(e - s, width)
        cols[b, :n] = csr.colind[s : s + n]
        mask[b, :n] = True
        if vals is not None:
            vals[b, :n] = vsrc[s : s + n]
    return PaddedRowMatrix(rows.astype(np.int32), cols, vals, mask, csr.shape)
