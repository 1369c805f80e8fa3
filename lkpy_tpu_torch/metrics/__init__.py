"""
Evaluation metrics (port of ``lkpy_tpu.metrics``; reference:
src/lenskit/metrics/__init__.py).  Metrics run on the host in NumPy, as in
the JAX package.
"""

from lkpy_tpu_torch.metrics._base import GlobalMetric, ListMetric, Metric, MetricFunction, RankingMetricBase
from lkpy_tpu_torch.metrics._weighting import GeometricRankWeight, LogRankWeight, RankWeight
from lkpy_tpu_torch.metrics.basic import ListLength, TestItemCount, UniqueItemCount
from lkpy_tpu_torch.metrics.collect import MeasurementCollector, RunAnalysis, RunAnalysisResult
from lkpy_tpu_torch.metrics.predict import MAE, RMSE, mae, rmse
from lkpy_tpu_torch.metrics.quick import QuickResults, quick_measure_model
from lkpy_tpu_torch.metrics.ranking import (
    DCG,
    ILS,
    NDCG,
    RBP,
    AveragePrecision,
    Entropy,
    ExposureGini,
    Hit,
    ListGini,
    MeanPopRank,
    Precision,
    RankBiasedEntropy,
    Recall,
    RecipRank,
)
from lkpy_tpu_torch.metrics.reranking import least_item_promoted, rank_biased_overlap

__all__ = [
    "AveragePrecision",
    "DCG",
    "Entropy",
    "ExposureGini",
    "GeometricRankWeight",
    "GlobalMetric",
    "Hit",
    "ILS",
    "ListGini",
    "ListLength",
    "ListMetric",
    "LogRankWeight",
    "MAE",
    "MeanPopRank",
    "MeasurementCollector",
    "Metric",
    "MetricFunction",
    "NDCG",
    "Precision",
    "QuickResults",
    "RankBiasedEntropy",
    "RankWeight",
    "RankingMetricBase",
    "RBP",
    "Recall",
    "RecipRank",
    "RMSE",
    "RunAnalysis",
    "RunAnalysisResult",
    "TestItemCount",
    "UniqueItemCount",
    "least_item_promoted",
    "mae",
    "quick_measure_model",
    "rank_biased_overlap",
    "rmse",
]


def measure_list(metric, output, test=None, *args, **kwargs):
    """Measure a single list with a metric, instantiating it if given a
    class (reference: metrics/__init__.py:99).  Convenience for one-off
    measurement without a :class:`RunAnalysis`."""
    from lkpy_tpu_torch.data import ItemList

    if isinstance(metric, type):
        metric = metric(*args, **kwargs)
    if test is None:
        test = ItemList()
    if isinstance(metric, ListMetric):
        return metric.measure_list(output, test)
    if callable(metric):
        return metric(output, test)
    raise TypeError(f"invalid metric {metric!r}")


def call_metric(metric, output, test=None, *args, **kwargs):
    """Deprecated alias for :func:`measure_list`
    (reference: metrics/__init__.py:81)."""
    import warnings

    warnings.warn("call_metric is deprecated, use measure_list instead", DeprecationWarning)
    return measure_list(metric, output, test, *args, **kwargs)


__all__ += ["call_metric", "measure_list"]
