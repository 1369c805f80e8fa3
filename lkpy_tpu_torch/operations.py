"""
One-shot user-facing operations.

Port of ``lkpy_tpu/operations.py``; capability parity with reference ``lenskit.operations``
(reference: src/lenskit/operations.py:18,63,102): ``recommend``, ``score``,
``predict`` call the corresponding named pipeline nodes.
"""

from __future__ import annotations

from lkpy_tpu_torch.data.items import ItemList
from lkpy_tpu_torch.data.query import QueryInput, RecQuery
from lkpy_tpu_torch.pipeline.pipeline import Pipeline

__all__ = ["recommend", "score", "predict"]


def recommend(
    pipeline: Pipeline,
    query: QueryInput = None,
    n: int | None = None,
    items: ItemList | None = None,
) -> ItemList:
    """Generate recommendations (reference: operations.py:18)."""
    q = RecQuery.create(query)
    return pipeline.run("recommender", query=q, n=n, items=items)


def score(pipeline: Pipeline, query: QueryInput, items: ItemList) -> ItemList:
    """Score a set of items for a query (reference: operations.py:63)."""
    q = RecQuery.create(query)
    return pipeline.run("scorer", query=q, items=items)


def predict(pipeline: Pipeline, query: QueryInput, items: ItemList) -> ItemList:
    """Predict ratings for items (reference: operations.py:102)."""
    q = RecQuery.create(query)
    return pipeline.run("rating-predictor", query=q, items=items)
