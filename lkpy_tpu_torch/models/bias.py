"""
User-item bias model.

Port of ``lkpy_tpu/models/bias.py`` (reference: src/lenskit/basic/bias.py:35
``BiasModel``; ``learn`` :84; ``BiasScorer`` :299).  Model: b_ui = b_g + b_i +
b_u with Bayesian damping (counts + β in the denominator), item biases
computed on global-centered ratings and user biases on item-centered
residuals.

The learning pass is tensor code on the resolved device (segment reductions
of :mod:`lkpy_tpu_torch.ops.segment` over COO interaction arrays, float32);
the learned model holds NumPy arrays on the host, as the JAX package's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch
from pydantic import BaseModel

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data import CSR, Dataset, ItemList, Vocabulary
from lkpy_tpu_torch.data.query import QueryInput, RecQuery
from lkpy_tpu_torch.ops.segment import segment_mean
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

__all__ = ["BiasModel", "BiasConfig", "BiasScorer", "entity_damping"]


def entity_damping(damping, entity: str) -> float:
    """Per-entity damping lookup (reference: bias.py ``entity_damping``)."""
    if isinstance(damping, dict):
        return float(damping.get(entity, 0.0))
    if isinstance(damping, (tuple, list)):
        return float(damping[0] if entity == "user" else damping[1])
    return float(damping)


def _learn_biases(
    unums: torch.Tensor,
    inums: torch.Tensor,
    ratings: torch.Tensor,
    *,
    n_users: int,
    n_items: int,
    user_damping: float,
    item_damping: float,
    with_items: bool = True,
):
    """Bias fit: global mean → damped item means → damped user means.

    ``with_items=False`` skips the item pass entirely, matching the
    reference's ``entities={'user'}`` semantics (bias.py ``learn``), where
    user biases are residuals against the global mean ONLY, not against
    item-centered ratings."""
    g = torch.mean(ratings)
    centered = ratings - g
    if with_items:
        i_bias = segment_mean(centered, inums, n_items, damping=item_damping)
        centered = centered - i_bias[inums.long()]
    else:
        i_bias = torch.zeros(n_items, dtype=ratings.dtype, device=ratings.device)
    u_bias = segment_mean(centered, unums, n_users, damping=user_damping)
    return g, i_bias, u_bias


@dataclass
class BiasModel:
    """Learned bias parameters (reference: bias.py:35)."""

    damping: float | dict | tuple
    global_bias: float
    items: Vocabulary | None = None
    item_biases: np.ndarray | None = None
    users: Vocabulary | None = None
    user_biases: np.ndarray | None = None

    @classmethod
    def learn(
        cls,
        data: Dataset,
        damping=0.0,
        *,
        entities=frozenset({"user", "item"}),
        device: str | torch.device | None = None,
    ) -> "BiasModel":
        """Fit the biases of ``data``'s ratings on ``device`` (the card
        unless ``device="cpu"``)."""
        dev = resolve_device(device)
        matrix = data.interaction_matrix()
        csr = matrix.csr("rating")
        if csr.values is None:
            raise ValueError("bias model requires rating values")
        coo = csr.to_coo()
        g, i_bias, u_bias = _learn_biases(
            torch.from_numpy(coo.row).to(dev),
            torch.from_numpy(coo.col).to(dev),
            torch.from_numpy(np.ascontiguousarray(coo.values, dtype=np.float32)).to(dev),
            n_users=csr.nrows,
            n_items=csr.ncols,
            user_damping=entity_damping(damping, "user"),
            item_damping=entity_damping(damping, "item"),
            with_items="item" in entities,
        )
        model = cls(damping, float(g))
        if "item" in entities:
            model.items = matrix.col_vocabulary
            model.item_biases = i_bias.cpu().numpy()
        if "user" in entities:
            model.users = matrix.row_vocabulary
            model.user_biases = u_bias.cpu().numpy()
        return model

    @classmethod
    def from_numpy(cls, params: dict, damping, users: Vocabulary | None, items: Vocabulary) -> "BiasModel":
        """A model from ``global_bias``, ``item_biases`` and ``user_biases``
        (may be absent or None) held as NumPy arrays, as the JAX package's
        ``BiasModel`` holds them."""
        user_biases = params.get("user_biases")
        return cls(
            damping,
            float(params["global_bias"]),
            items=items,
            item_biases=np.array(params["item_biases"], dtype=np.float32),
            users=users if user_biases is not None else None,
            user_biases=None if user_biases is None else np.array(user_biases, dtype=np.float32),
        )

    def transform_matrix(self, csr: CSR) -> CSR:
        """Subtract biases from CSR rating values
        (reference: bias.py ``transform_matrix``): r' = r − b_g − b_i − b_u."""
        vals = csr.values.astype(np.float64) - self.global_bias
        coo = csr.to_coo()
        if self.item_biases is not None:
            vals = vals - self.item_biases[coo.col]
        if self.user_biases is not None:
            vals = vals - self.user_biases[coo.row]
        return CSR(csr.rowptr, csr.colind, vals.astype(np.float32), csr.shape, csr.fields)

    def compute_for_items(
        self,
        items: ItemList,
        user_id=None,
        user_items: ItemList | None = None,
        *,
        bias: float | None = None,
    ):
        """Composite bias scores for items + a user (reference: bias.py:166).

        Unknown users/items have zero bias."""
        n = len(items)
        scores = np.full(n, self.global_bias, dtype=np.float32)
        if self.item_biases is not None and self.items is not None:
            nums = items.numbers(vocabulary=self.items, missing="negative")
            ok = nums >= 0
            scores[ok] += self.item_biases[nums[ok]]

        if bias is not None:
            return scores + np.float32(bias)

        user_bias = 0.0
        ratings = user_items.field("rating") if user_items is not None else None
        if ratings is not None and len(user_items) > 0:
            # fold-in: damped mean residual of the user's ratings; item
            # biases subtract only when the model HAS them (a users-only
            # model folds residuals against the global mean alone)
            resid = ratings.astype(np.float64) - self.global_bias
            if self.item_biases is not None and self.items is not None:
                nums = user_items.numbers(vocabulary=self.items, missing="negative")
                ok = nums >= 0
                resid[ok] -= self.item_biases[nums[ok]]
            ud = entity_damping(self.damping, "user")
            user_bias = float(np.sum(resid) / (len(resid) + ud))
        elif user_id is not None and self.user_biases is not None and self.users is not None:
            un = self.users.number(user_id, missing="negative")
            if un >= 0:
                user_bias = float(self.user_biases[un])
        return scores + np.float32(user_bias), user_bias


class BiasConfig(BaseModel):
    """Configuration for :class:`BiasScorer` (reference: bias.py ``BiasConfig``)."""

    damping: float | dict[str, float] | tuple[float, float] = 0.0
    entities: set[Literal["user", "item"]] = {"user", "item"}

    def entity_damping(self, entity: str) -> float:
        return entity_damping(self.damping, entity)


class BiasScorer(Component):
    """Bias-based rating prediction (reference: bias.py:299)."""

    config: BiasConfig
    model: BiasModel

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "model")

    @is_trained.setter
    def is_trained(self, value: bool):
        pass

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        self.model = BiasModel.learn(
            data, self.config.damping, entities=self.config.entities, device=options.configured_device()
        )

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        query = RecQuery.create(query)
        scores, _bias = self.model.compute_for_items(items, query.user_id, query.user_items)
        return ItemList(items, scores=scores)
