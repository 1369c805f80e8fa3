"""
Quick model measurement harness (port of ``lkpy_tpu/metrics/quick.py``;
reference: src/lenskit/metrics/_quick.py:22 ``quick_measure_model``):
20% user sample, 20% per-user holdout, top-N recommendations, standard
metrics — the accuracy-gate entry point used by model tests.

The split and the metrics run on the host; ``Pipeline.train`` trains on
``device`` (the card unless ``device="cpu"``), and the recommendations come
from the per-query :class:`~lkpy_tpu_torch.batch.BatchPipelineRunner`, as in
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import pandas as pd
import torch

from lkpy_tpu_torch.batch import BatchPipelineRunner
from lkpy_tpu_torch.data import Dataset, ItemListCollection
from lkpy_tpu_torch.metrics.collect import RunAnalysis, RunAnalysisResult
from lkpy_tpu_torch.metrics.predict import MAE, RMSE
from lkpy_tpu_torch.metrics.ranking import NDCG, RBP, Hit, Precision, Recall, RecipRank
from lkpy_tpu_torch.pipeline import topn_pipeline
from lkpy_tpu_torch.random import RNGInput
from lkpy_tpu_torch.splitting import SampleFrac, TTSplit, sample_users
from lkpy_tpu_torch.training import TrainingOptions

__all__ = ["quick_measure_model", "QuickResults"]


@dataclass
class QuickResults:
    split: TTSplit
    recommendations: ItemListCollection
    predictions: ItemListCollection | None
    run_analysis: RunAnalysisResult
    pred_analysis: RunAnalysisResult | None

    def list_summary(self) -> pd.DataFrame:
        df = self.run_analysis.list_summary()
        if self.pred_analysis is not None:
            df = pd.concat([df, self.pred_analysis.list_summary()])
        return df

    def global_metrics(self) -> pd.Series:
        return self.list_summary()["mean"]


def quick_measure_model(
    scorer,
    data: Dataset,
    *,
    predicts_ratings: bool = False,
    n_recs: int = 20,
    user_frac: float = 0.2,
    holdout_frac: float = 0.2,
    rng: RNGInput = 42,
    n_jobs: int | None = None,
    device: str | torch.device | None = None,
) -> QuickResults:
    """Train + evaluate a scorer on a quick user-sample split
    (reference: _quick.py:22).  ``device`` is where the pipeline trains:
    the card unless ``device="cpu"``."""
    n_sample = max(int(data.user_count * user_frac), 1)
    split = sample_users(data, n_sample, SampleFrac(holdout_frac, rng=rng), rng=rng)

    pipe = topn_pipeline(scorer, predicts_ratings=predicts_ratings, n=n_recs)
    pipe.train(split.train, TrainingOptions(rng=rng, device=device))

    runner = BatchPipelineRunner(n_jobs=n_jobs, progress=False)
    runner.recommend(n=n_recs)
    if predicts_ratings:
        runner.predict()
    results = runner.run(pipe, split.test)

    recs = results.output("recommendations")
    ra = RunAnalysis(NDCG(n_recs), RBP(n_recs), Precision(n_recs), Recall(n_recs), RecipRank(n_recs), Hit(n_recs))
    run_res = ra.measure(recs, split.test)

    preds = None
    pred_res = None
    if predicts_ratings:
        preds = results.output("predictions")
        pa = RunAnalysis(RMSE("ignore", "ignore"), MAE("ignore", "ignore"))
        pred_res = pa.measure(preds, split.test)

    return QuickResults(split, recs, preds, run_res, pred_res)
