"""
Hierarchical Poisson factorization bridge.

Port of ``lkpy_tpu/models/hpf.py`` (reference: src/lenskit/hpf.py:50),
wrapping the optional ``hpfrec`` package.  The bridge is kept for API
parity; where ``hpfrec`` is not installed, ``train`` raises the JAX
package's ImportError, the reference's optional-dependency behaviour.
Scoring is host NumPy over the factors ``hpfrec`` returns.
"""

from __future__ import annotations

import numpy as np
from pydantic import AliasChoices, BaseModel, Field

from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

__all__ = ["HPFConfig", "HPFScorer"]


class HPFConfig(BaseModel):
    """Configuration (reference: hpf.py:30)."""

    features: int = Field(default=50, validation_alias=AliasChoices("features", "embedding_size"))


class HPFScorer(Component):
    """Hierarchical Poisson factorization via hpfrec (reference: hpf.py:50)."""

    config: HPFConfig

    users: Vocabulary
    items: Vocabulary
    user_features: np.ndarray
    item_features: np.ndarray

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "item_features")

    @is_trained.setter
    def is_trained(self, v):
        pass

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        try:
            import hpfrec
        except ImportError as e:  # pragma: no cover - dep not in image
            raise ImportError("HPFScorer requires the optional 'hpfrec' package") from e
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        df = data.interaction_table(ids=True).rename(
            columns={"user_id": "UserId", "item_id": "ItemId", "rating": "Count"}
        )
        if "Count" not in df.columns:
            df["Count"] = 1.0
        hpf = hpfrec.HPF(k=self.config.features, reindex=False, verbose=False)
        users = data.users
        items = data.items
        df["UserId"] = users.numbers(df["UserId"].to_numpy())
        df["ItemId"] = items.numbers(df["ItemId"].to_numpy())
        hpf.fit(df[["UserId", "ItemId", "Count"]])
        self.users = users
        self.items = items
        self.user_features = hpf.Theta
        self.item_features = hpf.Beta

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
        scores[mask] = self.item_features[nums[mask]] @ self.user_features[user_num]
        return ItemList(items, scores=scores)
