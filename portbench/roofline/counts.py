"""
The operations and bytes each kernel's inputs need, and the least time they
allow (:func:`bound_s`).  Only real entries and rows count: padding is work
the kernel chooses to do.

* G (``gather_gram``): per real entry of a row, ``k(k+1)/2`` multiply-adds
  for A's lower triangle and ``k`` for y, so ``k(k+1) + 2k`` operations.
  Bytes: each real entry's column number and value read once (4 + 4), each
  row's A triangle and y written once.  The table rows that the entries
  name are read at least once; they are not counted, which only lowers the
  bound.
* An SPD solve (B1 ``spd_solve_chunked``, B2 ``spd_solve``): a Cholesky
  (``k³/3``) and two triangular solves (``2k²``) a system; A's lower triangle
  and y read once, x written once.
* A float32 product of ``(m, k)`` by ``(k, n)``: ``2mkn`` operations.
"""

from __future__ import annotations

from portbench.roofline.peaks import BYTES_PER_S, F32_FLOP_PER_S

__all__ = ["bound_s", "gram_bytes", "gram_ops", "matmul_ops", "solve_bytes", "solve_ops"]


def gram_ops(entries: int, k: int) -> float:
    return float(entries) * (k * (k + 1) + 2 * k)


def gram_bytes(entries: int, rows: int, k: int) -> float:
    return float(entries) * 8 + float(rows) * (k * (k + 1) // 2 + k) * 4


def solve_ops(rows: int, k: int) -> float:
    return float(rows) * (k**3 / 3 + 2 * k * k)


def solve_bytes(rows: int, k: int) -> float:
    return float(rows) * (k * (k + 1) // 2 + 2 * k) * 4


def matmul_ops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def bound_s(ops: float, nbytes: float, flop_per_s: float = F32_FLOP_PER_S) -> float:
    """The least time for ``ops`` operations and ``nbytes`` bytes: the
    larger of the two at the card's peaks."""
    return max(ops / flop_per_s, nbytes / BYTES_PER_S)
