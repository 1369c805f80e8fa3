"""
Metric base classes (port of ``lkpy_tpu/metrics/_base.py``).

Capability parity with the reference metric framework
(reference: src/lenskit/metrics/_base.py:37,115): ``Metric``, ``ListMetric``,
``GlobalMetric``, ``RankingMetricBase`` (list truncation), plus simple
statistics accumulation.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Protocol

import numpy as np

from lkpy_tpu_torch.data import ItemList, ItemListCollection

__all__ = ["Metric", "ListMetric", "GlobalMetric", "RankingMetricBase", "MetricFunction", "MetricAccumulator"]


class MetricFunction(Protocol):  # pragma: no cover - protocol
    """Per-list metric as a plain function."""

    def __call__(self, output: ItemList, test: ItemList, /) -> float: ...


class Metric(ABC):
    """Base class for metrics (reference: _base.py:37)."""

    default: float | None = 0.0
    "Value imputed for lists with no measurement (None = skip)."

    @property
    def label(self) -> str:
        return self.__class__.__name__

    def __str__(self):
        return f"Metric {self.label}"


class ListMetric(Metric):
    """Per-list metric; summary = statistics of per-list values
    (reference: _base.py:115)."""

    @abstractmethod
    def measure_list(self, output: ItemList, test: ItemList, /) -> float:
        raise NotImplementedError


class GlobalMetric(Metric):
    """Metric over a whole run (reference: _base.py ``GlobalMetric``)."""

    @abstractmethod
    def measure_run(self, output: ItemListCollection, test: ItemListCollection, /) -> float:
        raise NotImplementedError


class RankingMetricBase(Metric):
    """Base for top-N ranking metrics: handles truncation at n
    (reference: ranking/_base.py)."""

    n: int | None

    def __init__(self, n: int | None = None, *, k: int | None = None):
        if n is None:
            n = k
        self.n = n

    @property
    def label(self) -> str:
        base = self.__class__.__name__
        return f"{base}@{self.n}" if self.n is not None else base

    def truncate(self, recs: ItemList) -> ItemList:
        if self.n is not None and len(recs) > self.n:
            if recs.ordered:
                return recs[: self.n]
            raise ValueError("top-n ranking metric requires ordered lists")
        return recs


class MetricAccumulator:
    """Accumulate per-list values into summary statistics (mean/median/std)."""

    def __init__(self, label: str, default: float | None = 0.0):
        self.label = label
        self.default = default
        self.values: list[float] = []

    def add(self, value: float | None):
        if value is None or (isinstance(value, float) and np.isnan(value)):
            value = self.default
            if value is None:
                return
        self.values.append(float(value))

    def summary(self) -> dict[str, float]:
        if not self.values:
            return {"mean": np.nan, "median": np.nan, "std": np.nan, "count": 0}
        arr = np.asarray(self.values)
        return {
            "mean": float(np.mean(arr)),
            "median": float(np.median(arr)),
            "std": float(np.std(arr, ddof=1)) if len(arr) > 1 else 0.0,
            "count": len(arr),
        }
