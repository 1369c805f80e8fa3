"""
Measurement collection and bulk run analysis (port of
``lkpy_tpu/metrics/collect.py``).

Capability parity with the reference ``MeasurementCollector``
(reference: src/lenskit/metrics/_collect.py:60) and ``RunAnalysis``
(reference: src/lenskit/metrics/bulk.py:118).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import pandas as pd

from lkpy_tpu_torch.data import ItemList, ItemListCollection
from lkpy_tpu_torch.logging import get_logger
from lkpy_tpu_torch.metrics._base import GlobalMetric, ListMetric, Metric, MetricAccumulator

_log = get_logger(__name__)

__all__ = ["RunAnalysis", "RunAnalysisResult", "MeasurementCollector"]


@dataclass
class _MetricEntry:
    metric: Metric | Any
    label: str
    default: float | None


class MeasurementCollector:
    """Collects per-list measurements across metrics (reference: _collect.py:60)."""

    def __init__(self):
        self.metrics: list[_MetricEntry] = []
        self._accums: list[MetricAccumulator] = []
        self._rows: list[dict[str, Any]] = []

    def add_metric(self, metric, label: str | None = None, default: float | None = None):
        if isinstance(metric, type):
            metric = metric()
        mlabel = label or getattr(metric, "label", None) or type(metric).__name__
        mdefault = default if default is not None else getattr(metric, "default", 0.0)
        self.metrics.append(_MetricEntry(metric, mlabel, mdefault))
        self._accums.append(MetricAccumulator(mlabel, mdefault))

    def measure_list(self, key: tuple, key_fields: tuple, output: ItemList, test: ItemList):
        row: dict[str, Any] = dict(zip(key_fields, key))
        for entry, accum in zip(self.metrics, self._accums):
            m = entry.metric
            if isinstance(m, GlobalMetric):
                continue
            if isinstance(m, ListMetric):
                val = m.measure_list(output, test)
            elif callable(m):
                val = m(output, test)
            else:  # pragma: no cover
                raise TypeError(f"invalid metric {m}")
            row[entry.label] = val
            accum.add(val)
        self._rows.append(row)

    def measure_run(self, outputs: ItemListCollection, test: ItemListCollection) -> dict[str, float]:
        vals = {}
        for entry in self.metrics:
            if isinstance(entry.metric, GlobalMetric):
                vals[entry.label] = entry.metric.measure_run(outputs, test)
        return vals

    def list_metrics(self) -> pd.DataFrame:
        df = pd.DataFrame(self._rows)
        return df

    def summary(self, global_vals: dict[str, float] | None = None) -> pd.DataFrame:
        rows = {}
        for entry, accum in zip(self.metrics, self._accums):
            if isinstance(entry.metric, GlobalMetric):
                continue
            rows[entry.label] = accum.summary()
        df = pd.DataFrame(rows).T
        if df.empty:
            # global-only analyses: give the frame its column schema so the
            # global rows below can be inserted
            df = pd.DataFrame(columns=["mean", "median", "std", "count"])
        if global_vals:
            for label, v in global_vals.items():
                df.loc[label] = {"mean": v, "median": np.nan, "std": np.nan, "count": np.nan}
        df.index.name = "metric"
        return df


class RunAnalysisResult:
    """Results of a run analysis (reference: bulk.py:56)."""

    def __init__(self, list_df: pd.DataFrame, summary_df: pd.DataFrame, defaults: dict[str, float | None]):
        self._list = list_df
        self._summary = summary_df
        self._defaults = defaults

    def list_metrics(self, *, fill_missing: bool = True) -> pd.DataFrame:
        df = self._list
        if fill_missing:
            df = df.fillna({k: v for k, v in self._defaults.items() if v is not None})
        return df

    def list_summary(self) -> pd.DataFrame:
        return self._summary

    def global_metrics(self) -> pd.Series:
        return self._summary["mean"]


class RunAnalysis:
    """Bulk measurement of a recommendation run (reference: bulk.py:118)."""

    def __init__(self, *metrics):
        self.collector = MeasurementCollector()
        for m in metrics:
            self.collector.add_metric(m)

    def add_metric(self, metric, label: str | None = None, default: float | None = None):
        self.collector.add_metric(metric, label, default)

    def measure(self, outputs: ItemListCollection, test: ItemListCollection) -> RunAnalysisResult:
        n_missing = 0
        for key, out in outputs.items():
            t = test.lookup_projected(key)
            if t is None:
                # the reference measures against an empty list so the row
                # exists with NaN values, later filled by metric defaults
                # (reference: _collect.py:180)
                n_missing += 1
                t = ItemList()
            self.collector.measure_list(tuple(key), outputs.key_fields, out, t)
        if n_missing:
            _log.warning("no test data for some lists; measured against empty", count=n_missing)
        gvals = self.collector.measure_run(outputs, test)
        defaults = {e.label: e.default for e in self.collector.metrics}
        return RunAnalysisResult(self.collector.list_metrics(), self.collector.summary(gvals), defaults)
