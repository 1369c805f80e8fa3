"""
Generic accumulators (port of ``lkpy_tpu/data/accum.py``; reference:
src/lenskit/data/accum/ — ``Accumulator``/``AccumulatorFactory``
protocols, ``ObjectListAccumulator``, ``ValueStatAccumulator``/
``ValueStatistics``).
"""

from __future__ import annotations

from typing import Protocol, TypedDict, TypeVar, runtime_checkable

import numpy as np

__all__ = ["Accumulator", "AccumulatorFactory", "ObjectListAccumulator", "ValueStatAccumulator", "ValueStatistics"]

X = TypeVar("X")
R = TypeVar("R")


@runtime_checkable
class Accumulator(Protocol[X, R]):  # pragma: no cover - protocol
    def add(self, value: X) -> None: ...

    def accumulate(self) -> R: ...


@runtime_checkable
class AccumulatorFactory(Protocol[X, R]):  # pragma: no cover - protocol
    def create_accumulator(self) -> Accumulator[X, R]: ...


class ObjectListAccumulator:
    """Collect values into a list (reference: accum/_object.py:10)."""

    def __init__(self):
        self._values: list = []

    def __len__(self) -> int:
        return len(self._values)

    def add(self, value) -> None:
        self._values.append(value)

    def accumulate(self) -> list:
        return self._values


class ValueStatistics(TypedDict):
    mean: float
    median: float
    std: float
    min: float
    max: float
    count: int


class ValueStatAccumulator:
    """Summary statistics over numeric values (reference: accum/_value.py:27).

    ``default`` is imputed for None/NaN adds (None = skip)."""

    def __init__(self, default: float | None = 0.0):
        self.default = default
        self._values: list[float] = []

    def add(self, value: float | None) -> None:
        if value is None or (isinstance(value, float) and np.isnan(value)):
            value = self.default
            if value is None:
                return
        self._values.append(float(value))

    def accumulate(self) -> ValueStatistics:
        if not self._values:
            return ValueStatistics(mean=np.nan, median=np.nan, std=np.nan, min=np.nan, max=np.nan, count=0)
        arr = np.asarray(self._values)
        return ValueStatistics(
            mean=float(arr.mean()),
            median=float(np.median(arr)),
            std=float(arr.std(ddof=1)) if len(arr) > 1 else 0.0,
            min=float(arr.min()),
            max=float(arr.max()),
            count=len(arr),
        )
