"""
Rank weighting models (port of ``lkpy_tpu/metrics/_weighting.py``;
reference: src/lenskit/metrics/ranking/_weighting.py).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

__all__ = ["RankWeight", "LogRankWeight", "GeometricRankWeight"]


class RankWeight(ABC):
    """Multiplicative rank weights (rank 1 = best)."""

    @abstractmethod
    def weight(self, ranks: np.ndarray) -> np.ndarray: ...

    def log_weight(self, ranks: np.ndarray) -> np.ndarray:
        return np.log(self.weight(ranks))

    def series_sum(self) -> float | None:
        """Sum of the infinite weight series, if convergent."""
        return None


class LogRankWeight(RankWeight):
    """Logarithmic discount w(i) = 1/max(log_b(i+offset), 1) — the DCG weight
    (reference: _weighting.py:89)."""

    def __init__(self, *, base: float = 2, offset: int = 0):
        self.base = base
        self.offset = offset

    def weight(self, ranks):
        ranks = np.asarray(ranks, dtype=np.float64)
        logs = np.log(ranks + self.offset) / np.log(self.base)
        return np.reciprocal(np.maximum(logs, 1.0))


class GeometricRankWeight(RankWeight):
    """Geometric weight w(i) = p^(i−1) — the RBP weight
    (reference: _weighting.py:57)."""

    def __init__(self, patience: float = 0.85):
        assert 0 < patience < 1
        self.patience = patience

    def weight(self, ranks):
        ranks = np.asarray(ranks, dtype=np.float64)
        return np.power(self.patience, ranks - 1)

    def log_weight(self, ranks):
        return np.log(self.patience) * (np.asarray(ranks, dtype=np.float64) - 1)

    def series_sum(self) -> float:
        return 1.0 / (1.0 - self.patience)
