"""
Baseline / utility components.

Port of ``lkpy_tpu/models/basic.py`` (reference: src/lenskit/basic/):
``PopScorer``/``TimeBoundedPopScore`` (popularity.py:36,101), ``TopNRanker``
(topn.py:32), ``RandomSelector`` (random.py:27), ``SoftmaxRanker``
(stochastic/_ranker.py:59),
``UserTrainingHistoryLookup``/``KnownRatingScorer`` (history.py:37,112),
``TrainingItemsCandidateSelector`` (candidates.py:50), ``FallbackScorer``
(composite.py:19).  They run on the host with NumPy, as in the JAX package.
"""

from __future__ import annotations

from datetime import datetime
from typing import Literal

import numpy as np
from pydantic import BaseModel

from lkpy_tpu_torch.data import Dataset, ItemList, MatrixRelationshipSet, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.lazy import Lazy
from lkpy_tpu_torch.models.stochastic import stochastic_rank
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.random import derive_seed, random_generator
from lkpy_tpu_torch.training import TrainingOptions

__all__ = [
    "PopConfig",
    "PopScorer",
    "TimeBoundedPopConfig",
    "TimeBoundedPopScore",
    "TopNConfig",
    "TopNRanker",
    "RandomSelector",
    "SoftmaxConfig",
    "SoftmaxRanker",
    "UserTrainingHistoryLookup",
    "KnownRatingScorer",
    "TrainingItemsCandidateSelector",
    "FallbackScorer",
]


# ---------------------------------------------------------------------------
# popularity
class PopConfig(BaseModel):
    """Popularity scoring configuration (reference: popularity.py)."""

    score: Literal["quantile", "rank", "count"] = "quantile"


class PopScorer(Component):
    """Score items by popularity (reference: popularity.py:36)."""

    config: PopConfig
    items: Vocabulary
    item_scores: np.ndarray

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "item_scores")

    @is_trained.setter
    def is_trained(self, v):
        pass

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        self.items = data.items
        counts = data.item_stats()["count"].to_numpy().astype(np.float64)
        self.item_scores = self._score_counts(counts)

    def _score_counts(self, counts: np.ndarray) -> np.ndarray:
        method = self.config.score
        if method == "count":
            return counts.astype(np.float32)
        order = np.argsort(counts, kind="stable")
        if method == "rank":
            # average rank for ties, matching pandas .rank()
            ranks = np.empty(len(counts), dtype=np.float64)
            sorted_c = counts[order]
            ranks_sorted = np.arange(1, len(counts) + 1, dtype=np.float64)
            # average within tie groups
            _, inv, cnt = np.unique(sorted_c, return_inverse=True, return_counts=True)
            sums = np.zeros(len(cnt))
            np.add.at(sums, inv, ranks_sorted)
            ranks[order] = (sums / cnt)[inv]
            return ranks.astype(np.float32)
        if method == "quantile":
            # cumulative mass of counts, in count order (reference semantics)
            cmass = np.cumsum(counts[order])
            total = counts.sum()
            dens = np.empty(len(counts), dtype=np.float64)
            dens[order] = cmass / total if total > 0 else 0.0
            return dens.astype(np.float32)
        raise ValueError(f"invalid scoring method {method!r}")

    def __call__(self, items: ItemList) -> ItemList:
        nums = items.numbers(vocabulary=self.items, missing="negative")
        scores = np.full(len(items), np.nan, np.float32)
        ok = nums >= 0
        scores[ok] = self.item_scores[nums[ok]]
        return ItemList(items, scores=scores)


class TimeBoundedPopConfig(PopConfig):
    cutoff: datetime | float = 0.0
    """Only interactions after this time count toward popularity."""


class TimeBoundedPopScore(PopScorer):
    """Popularity within a recent time window (reference: popularity.py:101)."""

    config: TimeBoundedPopConfig

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        self.items = data.items
        csr = data.interaction_matrix().csr(None)
        ts = data.interaction_matrix().csr("rating").fields.get("timestamp")
        cutoff = self.config.cutoff
        if isinstance(cutoff, datetime):
            cutoff = cutoff.timestamp()
        counts = np.zeros(len(self.items), dtype=np.float64)
        if ts is not None:
            keep = ts >= cutoff
            np.add.at(counts, csr.colind[keep], 1.0)
        else:
            np.add.at(counts, csr.colind, 1.0)
        self.item_scores = self._score_counts(counts)


# ---------------------------------------------------------------------------
# ranking
class TopNConfig(BaseModel):
    """Top-N configuration (reference: topn.py)."""

    n: int = -1
    "Number of items to return (−1 = unlimited)."


class TopNRanker(Component):
    """Rank items by score, returning the top N (reference: topn.py:32)."""

    config: TopNConfig

    def __call__(self, items: ItemList, n: int | None = None) -> ItemList:
        if n is None or n < 0:
            n = self.config.n
        return items.top_n(n if n is not None and n >= 0 else None)


class RandomConfig(BaseModel):
    n: int = -1
    rng: int | None = None


class RandomSelector(Component):
    """Randomly select items (reference: random.py:27)."""

    config: RandomConfig

    def __call__(self, items: ItemList, query: QueryInput = None, n: int | None = None) -> ItemList:
        if n is None or n < 0:
            n = self.config.n
        if n is None or n < 0:
            n = len(items)
        n = min(n, len(items))
        query = RecQuery.create(query)
        seed = derive_seed("RandomSelector", query.user_id, base=self.config.rng)
        rng = random_generator(seed)
        picks = rng.choice(len(items), size=n, replace=False) if len(items) else np.array([], dtype=int)
        return items[picks]


class SoftmaxConfig(BaseModel):
    n: int = -1
    rng: int | None = None


class SoftmaxRanker(Component):
    """Stochastic ranking by softmax-weighted sampling without replacement
    (:func:`lkpy_tpu_torch.models.stochastic.stochastic_rank`, scale 1),
    seeded from the configured ``rng`` and the query's user."""

    config: SoftmaxConfig

    def __call__(self, items: ItemList, query: QueryInput = None, n: int | None = None) -> ItemList:
        if n is None or n < 0:
            n = self.config.n
        query = RecQuery.create(query)
        seed = derive_seed("SoftmaxRanker", query.user_id, base=self.config.rng)
        return stochastic_rank(items, n, seed)


# ---------------------------------------------------------------------------
# history & candidates
class LookupConfig(BaseModel):
    interaction_class: str | None = None


class UserTrainingHistoryLookup(Component):
    """Fill in the query's user history from training data (reference: history.py:37)."""

    config: LookupConfig
    interactions: MatrixRelationshipSet | None

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "interactions")

    @is_trained.setter
    def is_trained(self, v):
        pass

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        ints = data.interactions(self.config.interaction_class)
        if "user" not in ints.entities:
            self.interactions = None
            return
        # the dataset's cached matrix (the JAX package builds a new one, the same, from the table each time)
        self.interactions = data.interaction_matrix(self.config.interaction_class)

    def __call__(self, query: QueryInput) -> RecQuery:
        query = RecQuery.create(query)
        if query.user_id is None or self.interactions is None:
            return query
        if query.user_items is None:
            uid = query.user_id
            id_dtype = self.interactions.row_vocabulary.ids.dtype
            if isinstance(uid, str) and id_dtype.kind in "iu":
                uid = id_dtype.type(uid)
            query.user_items = self.interactions.row_items(uid)
        return query


class KnownRatingConfig(BaseModel):
    score: Literal["rating", "indicator"] = "rating"
    source: Literal["query", "training"] = "training"


class KnownRatingScorer(Component):
    """Score items with their known (training or query) ratings
    (reference: history.py:112)."""

    config: KnownRatingConfig
    matrix: MatrixRelationshipSet | None = None

    @property
    def is_trained(self) -> bool:
        return self.config.source == "query" or self.matrix is not None

    @is_trained.setter
    def is_trained(self, v):
        pass

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        if self.config.source == "query":
            return
        self.matrix = data.interaction_matrix()

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        query = RecQuery.create(query)
        scores = np.full(len(items), np.nan, dtype=np.float32)
        known: ItemList | None = None
        if self.config.source == "query":
            known = query.user_items
        elif self.matrix is not None and query.user_id is not None:
            known = self.matrix.row_items(query.user_id)
        if known is not None and len(known):
            kids = known.ids()
            kr = known.field("rating")
            pos = {k: i for i, k in enumerate(kids.tolist())}
            for i, iid in enumerate(items.ids().tolist()):
                j = pos.get(iid)
                if j is not None:
                    if self.config.score == "indicator":
                        scores[i] = 1.0
                    elif kr is not None:
                        scores[i] = kr[j]
            if self.config.score == "indicator":
                scores = np.nan_to_num(scores, nan=0.0)
        return ItemList(items, scores=scores)


class TrainingItemsCandidateConfig(BaseModel):
    exclude: Literal["user-history", "all", "none"] = "user-history"


class TrainingItemsCandidateSelector(Component):
    """All training items, minus the query's history (reference: candidates.py:50)."""

    config: TrainingItemsCandidateConfig
    items_: Vocabulary

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "items_")

    @is_trained.setter
    def is_trained(self, v):
        pass

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        self.items_ = data.items

    def __call__(self, query: QueryInput) -> ItemList:
        query = RecQuery.create(query)
        items = ItemList.from_vocabulary(self.items_)
        if self.config.exclude != "none" and query.user_items is not None and len(query.user_items):
            items = items.remove(query.user_items)
        return items


# ---------------------------------------------------------------------------
# composition
class FallbackScorer(Component):
    """Fill missing (NaN) scores from a backup scorer (reference: composite.py:19).

    The ``backup`` input is :class:`~lkpy_tpu_torch.lazy.Lazy` (as in the
    reference): in a pipeline the backup scorer node only RUNS when the
    primary left NaNs to fill.  Direct callers may still pass a plain
    ``ItemList``."""

    config: None

    def __call__(self, scores: ItemList, backup: "Lazy[ItemList]") -> ItemList:
        s = scores.scores()
        if s is None:
            return backup.get() if isinstance(backup, Lazy) else backup
        s = s.copy()
        missing = np.isnan(s)
        if not missing.any():
            return scores
        if isinstance(backup, Lazy):
            backup = backup.get()
        bs = backup.scores()
        if bs is not None:
            # align by item ID
            bmap = dict(zip(backup.ids().tolist(), bs.tolist()))
            ids = scores.ids()
            for i in np.nonzero(missing)[0]:
                v = bmap.get(ids[i])
                if v is not None:
                    s[i] = v
        return ItemList(scores, scores=s)
