"""
Sparse matrix structures (host side).

Port of ``lkpy_tpu/data/matrix.py`` (reference: src/lenskit/data/matrix.py
``CSRStructure``/``COOStructure``): plain NumPy CSR/COO structs, assembled
with NumPy alone.  The serving path uploads the CSR's row pointers and
column indices to the device once and gathers histories there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

__all__ = ["CSR", "COO"]


class COO(NamedTuple):
    """Coordinate-format structure."""

    row: np.ndarray  # int32 [nnz]
    col: np.ndarray  # int32 [nnz]
    values: np.ndarray | None  # float32 [nnz] or None (structural)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return len(self.row)

    def to_csr(self) -> "CSR":
        return CSR.from_coo(self.row, self.col, self.values, self.shape)


@dataclass(frozen=True)
class CSR:
    """
    Compressed sparse row matrix with optional values and extra per-entry
    fields.  Column indices within each row are sorted ascending.
    """

    rowptr: np.ndarray  # int64 [nrows+1]
    colind: np.ndarray  # int32 [nnz]
    values: np.ndarray | None  # float32 [nnz]
    shape: tuple[int, int]
    fields: dict = field(default_factory=dict)  # name -> [nnz] arrays (e.g. timestamp)

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return len(self.colind)

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.rowptr).astype(np.int32)

    def row_extent(self, r: int) -> tuple[int, int]:
        return int(self.rowptr[r]), int(self.rowptr[r + 1])

    def row_cols(self, r: int) -> np.ndarray:
        s, e = self.row_extent(r)
        return self.colind[s:e]

    @classmethod
    def from_coo(
        cls,
        row: np.ndarray,
        col: np.ndarray,
        values: np.ndarray | None,
        shape: tuple[int, int],
        fields: dict | None = None,
    ) -> "CSR":
        """Build CSR from COO triples, sorting by (row, col)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        order = np.lexsort((col, row))
        colind = col[order].astype(np.int32)
        counts = np.bincount(row[order], minlength=shape[0])
        rowptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=rowptr[1:])
        vals = None if values is None else np.asarray(values, dtype=np.float32)[order]
        flds = {n: np.asarray(v)[order] for n, v in (fields or {}).items()}
        return cls(rowptr, colind, vals, shape, flds)

    def transpose(self) -> "CSR":
        """CSC-style transpose."""
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64), self.row_lengths())
        return CSR.from_coo(
            self.colind.astype(np.int64), rows, self.values, (self.ncols, self.nrows), dict(self.fields)
        )

    def to_coo(self) -> COO:
        rows = np.repeat(np.arange(self.nrows, dtype=np.int32), self.row_lengths())
        return COO(rows, self.colind.astype(np.int32), self.values, self.shape)

    def drop_values(self) -> "CSR":
        return CSR(self.rowptr, self.colind, None, self.shape, self.fields)

    def with_values(self, values: np.ndarray) -> "CSR":
        values = np.asarray(values, dtype=np.float32)
        if len(values) != self.nnz:
            raise ValueError(f"{len(values)} values for a CSR with {self.nnz} entries")
        return CSR(self.rowptr, self.colind, values, self.shape, self.fields)
