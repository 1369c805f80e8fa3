"""The frozen arithmetic against counts made by hand at small shapes."""

import pytest

from portbench.roofline import counts, peaks


def test_gram_counts_by_hand():
    # k = 2: A's lower triangle has 3 multiply-adds an entry, y has 2: 10 operations
    assert counts.gram_ops(1, 2) == 10
    assert counts.gram_ops(5, 64) == 5 * (64 * 65 + 128)
    # 5 entries × (4 + 4) bytes in, 2 rows × (triangle 3 + y 2) × 4 bytes out
    assert counts.gram_bytes(5, 2, 2) == 40 + 2 * 5 * 4


def test_solve_counts_by_hand():
    # k = 3: Cholesky 9, two triangular solves 18
    assert counts.solve_ops(1, 3) == pytest.approx(27.0)
    # A's lower triangle (6) and y (3) in, x (3) out, 4 bytes each
    assert counts.solve_bytes(2, 3) == 2 * 12 * 4


def test_matmul_and_bound():
    assert counts.matmul_ops(2, 3, 4) == 48
    assert counts.bound_s(peaks.F32_FLOP_PER_S, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, peaks.BYTES_PER_S) == pytest.approx(1.0)
    assert counts.bound_s(peaks.F32_FLOP_PER_S, 2 * peaks.BYTES_PER_S) == pytest.approx(2.0)
