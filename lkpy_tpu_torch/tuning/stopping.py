"""Plateau early-stopping (port of ``lkpy_tpu/tuning/stopping.py``;
reference: src/lenskit/tuning/_stopping.py:23)."""

from __future__ import annotations

import numpy as np

__all__ = ["PlateauStopRule"]


class PlateauStopRule:
    """Stop when the metric has not improved by ``min_delta`` for
    ``patience`` checks."""

    def __init__(self, patience: int = 3, min_delta: float = 1e-4, maximize: bool = True):
        self.patience = patience
        self.min_delta = min_delta
        self.maximize = maximize
        self.best = -np.inf if maximize else np.inf
        self.stale = 0

    def update(self, value: float) -> bool:
        """Record a measurement; returns True if training should STOP."""
        improved = (
            value > self.best + self.min_delta if self.maximize else value < self.best - self.min_delta
        )
        if improved:
            self.best = value
            self.stale = 0
        else:
            self.stale += 1
        return self.stale >= self.patience
