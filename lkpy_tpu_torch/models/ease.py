"""
EASE: Embarrassingly Shallow Autoencoder (Steck 2019).

Port of ``lkpy_tpu/models/ease.py`` (reference: src/lenskit/knn/ease.py:
48,183,190): the closed-form ridge inverse of the item co-occurrence Gram
matrix, B = −P / diag(P) with a zero diagonal.

The port forms the Gram on the training device with the similarity build's
chunked product (:func:`lkpy_tpu_torch.ops.knn.cooccurrence_gram`, exact
integer counts, equal to the JAX package's SciPy product to the bit), where
the JAX package forms it on the host with SciPy; the inverse is a float32
Cholesky factorization and solve there, and the weights stay on that
device.  A query's scores are the sum of its history's weight rows.
"""

from __future__ import annotations

import numpy as np
import torch
from pydantic import BaseModel

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data import CSR, Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.logging import Stopwatch, get_logger
from lkpy_tpu_torch.ops.knn import cooccurrence_gram
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

_log = get_logger(__name__)

__all__ = ["EASEConfig", "EASEScorer"]


class EASEConfig(BaseModel):
    """Configuration (reference: ease.py:37)."""

    regularization: float = 1.0


def _ease_weights(ui: CSR, regularization: float, device: torch.device) -> torch.Tensor:
    """P = (G + λI)⁻¹ of the binary co-occurrence Gram G of ``ui``; B =
    −P/diag(P) by columns, diag(B) = 0 (reference: ease.py:144-147), as
    float32 on ``device``.  Each n_items² intermediate is dropped as soon as
    it is spent, so at most three are alive (the factor, the identity and
    P).  A non-positive pivot raises (``torch.linalg.cholesky``)."""
    gram = cooccurrence_gram(ui, device=device)
    gram.diagonal().add_(regularization)
    chol = torch.linalg.cholesky(gram)
    del gram
    eye = torch.eye(ui.ncols, dtype=torch.float32, device=device)
    p = torch.cholesky_solve(eye, chol)
    del eye, chol
    p.div_(-p.diagonal().clone())
    return p.fill_diagonal_(0.0)


class EASEScorer(Component):
    """EASE item scorer (reference: ease.py:48)."""

    config: EASEConfig

    items: Vocabulary
    weights: torch.Tensor

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "weights")

    @is_trained.setter
    def is_trained(self, v):
        pass

    @classmethod
    def from_numpy(
        cls,
        weights: np.ndarray,
        items: Vocabulary,
        config: EASEConfig | dict | None = None,
        device: str | torch.device | None = None,
    ) -> "EASEScorer":
        """A scorer from weights held as a NumPy array, as the JAX package's
        ``EASEScorer`` holds them, on ``device`` (the card unless ``"cpu"``)."""
        scorer = cls(config)
        scorer.weights = torch.tensor(np.asarray(weights, dtype=np.float32), device=resolve_device(device))
        scorer.items = items
        return scorer

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        sw = Stopwatch()
        ui = data.interaction_matrix().csr(None)
        self.weights = _ease_weights(ui, self.config.regularization, options.configured_device())
        self.items = data.items
        _log.info("trained EASE", time=str(sw), n_items=data.item_count)

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        query = RecQuery.create(query)
        q_items = query.user_items
        scores = np.full(len(items), np.nan, dtype=np.float32)
        if q_items is None or len(q_items) == 0:
            return ItemList(items, scores=scores)
        q_nums = q_items.numbers(vocabulary=self.items, missing="negative")
        q_good = q_nums[q_nums >= 0]
        if len(q_good) == 0:
            return ItemList(items, scores=scores)
        t_nums = items.numbers(vocabulary=self.items, missing="negative")
        t_mask = t_nums >= 0
        # score = q_vec @ B, restricted to targets: sum the history's rows of B
        dev = self.weights.device
        all_scores = self.weights[torch.from_numpy(q_good.astype(np.int64)).to(dev)].sum(dim=0)
        scores[t_mask] = all_scores[torch.from_numpy(t_nums[t_mask].astype(np.int64)).to(dev)].cpu().numpy()
        return ItemList(items, scores=scores)
