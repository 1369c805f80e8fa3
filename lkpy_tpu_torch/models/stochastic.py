"""
Stochastic ranking.

Port of ``lkpy_tpu/models/stochastic.py`` (reference:
src/lenskit/stochastic/_ranker.py:59 ``StochasticTopNRanker``): items are
sampled without replacement with probability proportional to softmax(score),
by the Gumbel-top-k trick (Gumbel noise added to the scaled scores, then a
sort).  The noise comes from :mod:`lkpy_tpu_torch.random`'s NumPy generators,
the JAX package's, so both packages give the same lists for the same seed.
"""

from __future__ import annotations

import numpy as np
from pydantic import BaseModel

from lkpy_tpu_torch.data import ItemList, QueryInput, RecQuery
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.random import derive_seed, random_generator

__all__ = ["StochasticTopNRanker", "StochasticTopNConfig", "stochastic_rank"]


def stochastic_rank(items: ItemList, n: int | None, seed, *, scale: float = 1.0) -> ItemList:
    """Gumbel-top-k softmax sampling of an item list: the first ``n`` (all
    if None or negative) of the items with a score, ranked."""
    scores = items.scores()
    if scores is None:
        raise ValueError("stochastic ranking requires scores")
    valid = ~np.isnan(scores)
    k = int(valid.sum())
    if n is not None and n >= 0:
        k = min(k, n)
    gumbel = random_generator(seed).gumbel(size=len(scores))
    keys = np.where(valid, scores * scale + gumbel, -np.inf)
    order = np.argsort(-keys, kind="stable")[:k]
    return ItemList(items[order], ordered=True, rank=np.arange(1, k + 1, dtype=np.int32), scores=scores[order])


class StochasticTopNConfig(BaseModel):
    n: int = -1
    rng: int | None = None
    scale: float = 1.0
    "Multiplier applied to scores before softmax (inverse temperature)."


class StochasticTopNRanker(Component):
    """Softmax-weighted stochastic top-N ranker; the noise is seeded from
    the configured ``rng`` and the query's user."""

    config: StochasticTopNConfig

    def __call__(self, items: ItemList, query: QueryInput = None, n: int | None = None) -> ItemList:
        if n is None or n < 0:
            n = self.config.n
        query = RecQuery.create(query)
        seed = derive_seed("StochasticTopNRanker", query.user_id, base=self.config.rng)
        return stochastic_rank(items, n, seed, scale=self.config.scale)
