"""Statistical helpers (port of ``lkpy_tpu/utils/stats.py``; reference:
src/lenskit/stats.py)."""

from __future__ import annotations

import numpy as np

__all__ = ["gini", "damped_mean"]


def gini(values: np.ndarray) -> float:
    """
    Gini coefficient of a non-negative distribution
    (reference: src/lenskit/stats.py ``gini``).

    0 = perfectly equal, 1 = fully concentrated.
    """
    x = np.sort(np.asarray(values, dtype=np.float64))
    n = len(x)
    if n == 0 or x.sum() == 0:
        return 0.0
    cum = np.cumsum(x)
    # Gini = (n + 1 - 2 * sum(cum) / cum[-1]) / n
    return float((n + 1 - 2 * np.sum(cum) / cum[-1]) / n)


def damped_mean(values: np.ndarray, damping: float) -> float:
    v = np.asarray(values, dtype=np.float64)
    return float(v.sum() / (len(v) + damping))
