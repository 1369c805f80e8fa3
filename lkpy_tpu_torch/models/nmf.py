"""
Non-negative matrix factorization scorer.

Port of ``lkpy_tpu/models/nmf.py`` (reference: src/lenskit/sklearn/nmf.py:51
— the sklearn NMF bridge): Lee–Seung multiplicative updates for the
Frobenius objective, zero-filled like sklearn's sparse handling, as a loop
of float32 ``torch.mm`` products on the training device.  The dense matrix
is scattered there from the CSR (the JAX package densifies it on the host);
the initial tables are the JAX package's NumPy draws, scaled by the
matrix's mean.  The components stay on the training device.
"""

from __future__ import annotations

import numpy as np
import torch
from pydantic import AliasChoices, BaseModel, Field

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.logging import get_logger
from lkpy_tpu_torch.models._dense import dense_on_device
from lkpy_tpu_torch.models.svd import _item_major, component_scores
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

_log = get_logger(__name__)

__all__ = ["NMFConfig", "NMFScorer"]

_EPS = 1e-9


class NMFConfig(BaseModel):
    """Configuration (reference: sklearn/nmf.py:33)."""

    features: int = Field(default=50, validation_alias=AliasChoices("features", "embedding_size"))
    max_iter: int = 200


def _nmf_mu(a: torch.Tensor, w: torch.Tensor, h: torch.Tensor, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` multiplicative updates for min ‖A − WH‖_F, W, H ≥ 0; returns
    the new ``(w, h)``.  Call with full float32 products (no TF32)."""
    for _ in range(iters):
        # H update
        num = torch.mm(w.T, a)
        den = torch.mm(torch.mm(w.T, w), h)
        h = h * num / (den + _EPS)
        # W update
        num = torch.mm(a, h.T)
        den = torch.mm(w, torch.mm(h, h.T))
        w = w * num / (den + _EPS)
    return w, h


def nmf_init(rng: np.random.Generator, shape: tuple[int, int], k: int, total: float) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's initial tables: absolute standard normals (the
    user table drawn first) scaled by √(mean / k), for a matrix whose
    entries sum to ``total``."""
    scale = np.float32(np.sqrt(np.float32(total / (shape[0] * shape[1])) / k))
    w0 = np.abs(rng.standard_normal((shape[0], k))).astype(np.float32) * scale
    h0 = np.abs(rng.standard_normal((k, shape[1]))).astype(np.float32) * scale
    return w0, h0


class NMFScorer(Component):
    """NMF scorer (reference: sklearn/nmf.py:51).  ``user_components``
    (n_users, k) and ``item_components`` (k, n_items) are float32 tensors on
    the training device."""

    config: NMFConfig

    users: Vocabulary
    items: Vocabulary
    user_components: torch.Tensor
    item_components: torch.Tensor

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "item_components")

    @is_trained.setter
    def is_trained(self, v):
        pass

    @classmethod
    def from_numpy(
        cls,
        params: dict,
        config: NMFConfig | dict | None,
        users: Vocabulary,
        items: Vocabulary,
        device: str | torch.device | None = None,
    ) -> "NMFScorer":
        """A scorer from the JAX package's ``user_components`` and
        ``item_components`` on ``device`` (the card unless ``"cpu"``)."""
        dev = resolve_device(device)
        scorer = cls(config)
        scorer.users, scorer.items = users, items
        scorer.user_components = torch.tensor(np.asarray(params["user_components"], dtype=np.float32), device=dev)
        scorer.item_components = _item_major(torch.tensor(np.asarray(params["item_components"], dtype=np.float32), device=dev))
        return scorer

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        dev = options.configured_device()
        csr = data.interaction_matrix().csr("rating")
        dense = dense_on_device(csr, dev)
        k = min(self.config.features, min(dense.shape))
        total = float(np.sum(csr.values, dtype=np.float64)) if csr.values is not None else float(csr.nnz)
        w0, h0 = nmf_init(options.random_generator(), csr.shape, k, total)
        w, h = _nmf_mu(dense, torch.from_numpy(w0).to(dev), torch.from_numpy(h0).to(dev), self.config.max_iter)
        del dense
        self.user_components = w
        self.item_components = _item_major(h)
        self.users = data.users
        self.items = data.items
        _log.info("trained NMF", features=k)

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        """Scores on the tables' device; every item NaN for an unknown user,
        an unknown item NaN."""
        query = RecQuery.create(query)
        user_num = None
        if query.user_id is not None:
            user_num = self.users.number(query.user_id, missing="negative")
        scores = np.full(len(items), np.nan, dtype=np.float32)
        if user_num is None or user_num < 0:
            return ItemList(items, scores=scores)
        item_nums = items.numbers(vocabulary=self.items, missing="negative")
        component_scores(self.user_components, self.item_components, user_num, item_nums, item_nums >= 0, scores)
        return ItemList(items, scores=scores)
