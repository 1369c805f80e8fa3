"""
Standard pipelines: top-N recommendation and rating prediction.

Port of ``lkpy_tpu/pipeline/common.py``; capability parity with the reference's standard pipelines
(reference: src/lenskit/pipeline/_common.py:24 ``RecPipelineBuilder``,
:113-157 standard topn graph, :254 ``topn_pipeline``,
:293 ``predict_pipeline``).
"""

from __future__ import annotations

from typing import Any

from lkpy_tpu_torch.data.items import ItemList
from lkpy_tpu_torch.data.query import RecQuery
from lkpy_tpu_torch.pipeline.builder import PipelineBuilder
from lkpy_tpu_torch.pipeline.pipeline import Pipeline

__all__ = ["RecPipelineBuilder", "topn_pipeline", "predict_pipeline"]


class RecPipelineBuilder:
    """
    Builder for the standard recommendation pipeline
    (reference: _common.py:24).

    Graph: query → history-lookup → candidate-selector →
    (items | candidates) → scorer → ranker, with optional rating predictor
    fallback.
    """

    def __init__(self):
        self._scorer = None
        self._scorer_name = None
        self._ranker = None
        self._predicts_ratings = False
        self._fallback = None
        self._n: int | None = None

    def scorer(self, score: Any, *, name: str | None = None):
        self._scorer = score
        self._scorer_name = name

    def ranker(self, rank: Any = None, *, n: int | None = None):
        self._ranker = rank
        self._n = n

    def predicts_ratings(self, *, fallback: Any = None):
        self._predicts_ratings = True
        self._fallback = fallback

    def build(self, name: str | None = None) -> Pipeline:
        from lkpy_tpu_torch.models.basic import (
            TopNRanker,
            TrainingItemsCandidateSelector,
            UserTrainingHistoryLookup,
        )

        if self._scorer is None:
            raise ValueError("no scorer specified")
        pb = PipelineBuilder(name)
        query = pb.create_input("query", RecQuery, int, str, ItemList, type(None))
        items = pb.create_input("items", ItemList, type(None), required=False)
        n_in = pb.create_input("n", int, type(None), required=False)

        history = pb.add_component("history-lookup", UserTrainingHistoryLookup(), query=query)
        cand = pb.add_component("candidate-selector", TrainingItemsCandidateSelector(), query=history)
        candidates = pb.use_first_of("candidates", items, cand)
        score = pb.add_component(
            self._scorer_name or "scorer", self._scorer, query=history, items=candidates
        )
        ranker = self._ranker if self._ranker is not None else TopNRanker(n=self._n or -1)
        rank = pb.add_component("ranker", ranker, items=score, n=n_in)
        pb.alias("recommender", rank)
        if score.name != "scorer":
            pb.alias("scorer", score)
        pb.default_component(rank)
        if self._predicts_ratings:
            if self._fallback is not None:
                from lkpy_tpu_torch.models.basic import FallbackScorer

                fscore = pb.add_component("fallback-predictor", self._fallback, query=history, items=candidates)
                fb = pb.add_component("rating-merger", FallbackScorer(), scores=score, backup=fscore)
                pb.alias("rating-predictor", fb)
            else:
                pb.alias("rating-predictor", score)
        return pb.build()


def topn_pipeline(
    scorer: Any,
    *,
    predicts_ratings: bool = False,
    n: int | None = None,
    name: str | None = None,
) -> Pipeline:
    """The standard top-N pipeline for a scorer (reference: _common.py:254)."""
    rpb = RecPipelineBuilder()
    rpb.scorer(scorer)
    rpb.ranker(n=n)
    if predicts_ratings:
        rpb.predicts_ratings()
    return rpb.build(name)


def predict_pipeline(scorer: Any, *, fallback: bool | Any = True, n: int | None = None) -> Pipeline:
    """A rating-prediction pipeline with optional bias fallback
    (reference: _common.py:293)."""
    from lkpy_tpu_torch.models.bias import BiasScorer

    rpb = RecPipelineBuilder()
    rpb.scorer(scorer)
    rpb.ranker(n=n)
    if fallback is True:
        fallback = BiasScorer()
    rpb.predicts_ratings(fallback=fallback or None)
    return rpb.build()
