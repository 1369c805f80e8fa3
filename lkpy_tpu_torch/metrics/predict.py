"""
Prediction-accuracy metrics (port of ``lkpy_tpu/metrics/predict.py``;
reference: src/lenskit/metrics/predict.py:114,147).
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from lkpy_tpu_torch.data import ItemList
from lkpy_tpu_torch.metrics._base import ListMetric

__all__ = ["PredictMetric", "RMSE", "MAE", "rmse", "mae"]


class PredictMetric(ListMetric):
    """
    Base for prediction metrics: aligns predicted scores with test ratings
    (reference: predict.py ``PredictMetric``).

    Args:
        missing_scores: how to treat test items with no prediction —
            "error" or "ignore".
        missing_truth: how to treat predictions for unrated items.
    """

    default = None  # missing prediction accuracy is undefined, not 0

    def __init__(
        self,
        missing_scores: Literal["error", "ignore"] = "error",
        missing_truth: Literal["error", "ignore"] = "error",
    ):
        self.missing_scores = missing_scores
        self.missing_truth = missing_truth

    def align(self, output: ItemList, test: ItemList) -> tuple[np.ndarray, np.ndarray]:
        preds = output.scores()
        if preds is None:
            raise ValueError("output list has no scores")
        ratings = test.field("rating")
        if ratings is None:
            raise ValueError("test list has no ratings")
        # join on item id
        out_ids = output.ids()
        t_ids = test.ids()
        t_pos = {k: i for i, k in enumerate(t_ids.tolist())}
        ps, rs = [], []
        matched = np.zeros(len(t_ids), dtype=bool)
        for i, iid in enumerate(out_ids.tolist()):
            j = t_pos.get(iid)
            if j is None:
                if self.missing_truth == "error":
                    raise ValueError(f"prediction for unrated item {iid!r}")
                continue
            matched[j] = True
            if np.isnan(preds[i]):
                if self.missing_scores == "error":
                    raise ValueError(f"missing prediction for test item {iid!r}")
                continue
            ps.append(preds[i])
            rs.append(ratings[j])
        if self.missing_scores == "error" and not matched.all():
            raise ValueError(f"{int((~matched).sum())} test items have no predictions")
        return np.asarray(ps, dtype=np.float64), np.asarray(rs, dtype=np.float64)


class RMSE(PredictMetric):
    """Root mean squared error (reference: predict.py:114)."""

    def measure_list(self, output: ItemList, test: ItemList) -> float:
        ps, rs = self.align(output, test)
        if len(ps) == 0:
            return np.nan
        return float(np.sqrt(np.mean((ps - rs) ** 2)))


class MAE(PredictMetric):
    """Mean absolute error (reference: predict.py:147)."""

    def measure_list(self, output: ItemList, test: ItemList) -> float:
        ps, rs = self.align(output, test)
        if len(ps) == 0:
            return np.nan
        return float(np.mean(np.abs(ps - rs)))


def rmse(output: ItemList, test: ItemList, missing_scores="ignore", missing_truth="ignore") -> float:
    return RMSE(missing_scores, missing_truth).measure_list(output, test)


def mae(output: ItemList, test: ItemList, missing_scores="ignore", missing_truth="ignore") -> float:
    return MAE(missing_scores, missing_truth).measure_list(output, test)
