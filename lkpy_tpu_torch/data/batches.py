"""Batch iteration helper (port of ``lkpy_tpu/data/batches.py``; reference:
src/lenskit/data/_batches.py ``BatchedRange``)."""

from __future__ import annotations

from typing import Iterator

__all__ = ["BatchedRange"]


class BatchedRange:
    """Iterate a range in fixed-size batches, yielding (start, end) pairs."""

    def __init__(self, n: int, batch_size: int):
        self.n = n
        self.batch_size = batch_size

    def __len__(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[int, int]]:
        for lo in range(0, self.n, self.batch_size):
            yield lo, min(lo + self.batch_size, self.n)

    def slices(self) -> Iterator[slice]:
        for lo, hi in self:
            yield slice(lo, hi)
