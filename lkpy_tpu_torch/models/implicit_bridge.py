"""
Bridges to the ``implicit`` package.

Port of ``lkpy_tpu/models/implicit_bridge.py`` (reference:
src/lenskit/implicit.py:44,132,155 — ``BaseRec``, ``ALS``, ``BPR``).  Like
the reference, these require the optional ``implicit`` package; where it is
not installed, ``train`` raises the JAX package's ImportError.  The native
equivalents are :class:`lkpy_tpu_torch.models.als.ImplicitMFScorer` and
FlexMF's BPR preset.  Scoring is host NumPy over the bridged factors.
"""

from __future__ import annotations

import numpy as np
from pydantic import AliasChoices, BaseModel, Field

from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

__all__ = ["ALS", "BPR", "BaseRec"]


class ImplicitConfig(BaseModel):
    factors: int = Field(default=64, validation_alias=AliasChoices("factors", "features", "embedding_size"))
    iterations: int = 15
    regularization: float = 0.01


class BaseRec(Component):
    """Base bridge (reference: implicit.py:44)."""

    config: ImplicitConfig

    users: Vocabulary
    items: Vocabulary
    user_factors: np.ndarray
    item_factors: np.ndarray

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "item_factors")

    @is_trained.setter
    def is_trained(self, v):
        pass

    def _construct(self):  # pragma: no cover - requires optional dep
        raise NotImplementedError

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        model = self._construct()
        matrix = data.interaction_matrix().scipy(None).astype(np.float32)
        model.fit(matrix, show_progress=False)
        self.users = data.users
        self.items = data.items
        self.user_factors = np.asarray(model.user_factors)
        self.item_factors = np.asarray(model.item_factors)

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        query = RecQuery.create(query)
        user_num = None
        if query.user_id is not None:
            user_num = self.users.number(query.user_id, missing="negative")
        scores = np.full(len(items), np.nan, dtype=np.float32)
        if user_num is None or user_num < 0:
            return ItemList(items, scores=scores)
        nums = items.numbers(vocabulary=self.items, missing="negative")
        mask = nums >= 0
        scores[mask] = self.item_factors[nums[mask]] @ self.user_factors[user_num]
        return ItemList(items, scores=scores)


class ALS(BaseRec):
    """implicit-pkg ALS (reference: implicit.py:132)."""

    def _construct(self):
        try:
            from implicit.als import AlternatingLeastSquares
        except ImportError as e:  # pragma: no cover
            raise ImportError("requires the optional 'implicit' package") from e
        return AlternatingLeastSquares(
            factors=self.config.factors,
            iterations=self.config.iterations,
            regularization=self.config.regularization,
        )


class BPR(BaseRec):
    """implicit-pkg BPR (reference: implicit.py:155)."""

    def _construct(self):
        try:
            from implicit.bpr import BayesianPersonalizedRanking
        except ImportError as e:  # pragma: no cover
            raise ImportError("requires the optional 'implicit' package") from e
        return BayesianPersonalizedRanking(
            factors=self.config.factors,
            iterations=self.config.iterations,
            regularization=self.config.regularization,
        )
