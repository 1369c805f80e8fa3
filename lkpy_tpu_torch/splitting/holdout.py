"""
Per-user holdout methods (port of ``lkpy_tpu/splitting/holdout.py``;
reference: src/lenskit/splitting/_holdout.py:44-131).  The samplers draw
through :func:`~lkpy_tpu_torch.random.random_generator`, so one seed picks
the same items as in the JAX package.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from lkpy_tpu_torch.data import ItemList
from lkpy_tpu_torch.random import RNGInput, random_generator

__all__ = ["HoldoutMethod", "SampleN", "SampleFrac", "LastN", "LastFrac"]


class HoldoutMethod(Protocol):  # pragma: no cover - protocol
    """Select test items from a user's item list."""

    def __call__(self, items: ItemList) -> ItemList: ...


class SampleN:
    """Randomly sample N items (reference: _holdout.py:44)."""

    def __init__(self, n: int, rng: RNGInput = None):
        self.n = n
        self.rng = random_generator(rng)

    def __call__(self, items: ItemList) -> ItemList:
        if len(items) <= self.n:
            return items
        picks = self.rng.choice(len(items), size=self.n, replace=False)
        return items[picks]


class SampleFrac:
    """Randomly sample a fraction of items (reference: _holdout.py:74)."""

    def __init__(self, frac: float, rng: RNGInput = None):
        self.fraction = frac
        self.rng = random_generator(rng)

    def __call__(self, items: ItemList) -> ItemList:
        n = round(len(items) * self.fraction)
        picks = self.rng.choice(len(items), size=n, replace=False)
        return items[picks]


class LastN:
    """The last N items by timestamp (reference: _holdout.py:98)."""

    def __init__(self, n: int, field: str = "timestamp"):
        self.n = n
        self.field = field

    def __call__(self, items: ItemList) -> ItemList:
        ts = items.field(self.field)
        if ts is None:
            raise ValueError(f"items have no field {self.field!r}")
        order = np.argsort(ts, kind="stable")
        return items[order[-self.n :]]


class LastFrac:
    """The last fraction of items by timestamp (reference: _holdout.py:118)."""

    def __init__(self, frac: float, field: str = "timestamp"):
        self.fraction = frac
        self.field = field

    def __call__(self, items: ItemList) -> ItemList:
        ts = items.field(self.field)
        if ts is None:
            raise ValueError(f"items have no field {self.field!r}")
        n = round(len(items) * self.fraction)
        order = np.argsort(ts, kind="stable")
        return items[order[len(items) - n :]]
