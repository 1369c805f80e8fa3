"""
Biased truncated-SVD scorer.

Port of ``lkpy_tpu/models/svd.py`` (reference: src/lenskit/sklearn/svd.py:47
— TruncatedSVD over bias-centered ratings): a randomized truncated SVD
(Halko et al.) with one subspace iteration, its products ``torch.mm`` and
its factorizations ``torch.linalg.qr``/``svd`` in float32 on the training
device.  The bias-centered dense matrix is scattered there from the CSR
(the JAX package densifies it on the host and uploads it); ``omega`` is
the JAX package's draw from the options' NumPy generator.  The components
stay on the training device.
"""

from __future__ import annotations

import numpy as np
import torch
from pydantic import AliasChoices, BaseModel, Field

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.logging import get_logger
from lkpy_tpu_torch.models._dense import dense_on_device
from lkpy_tpu_torch.models.bias import BiasModel
from lkpy_tpu_torch.ops.gather_rows import gather_rows
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

_log = get_logger(__name__)

__all__ = ["BiasedSVDConfig", "BiasedSVDScorer", "component_scores"]


class BiasedSVDConfig(BaseModel):
    """Configuration (reference: sklearn/svd.py:31)."""

    features: int = Field(default=50, validation_alias=AliasChoices("features", "embedding_size"))
    damping: float | dict[str, float] = 5.0
    algorithm: str = "randomized"
    n_iter: int = 5


def _rand_svd_core(a_dense: torch.Tensor, omega: torch.Tensor, n_iter_dummy=None):
    """One power-iteration randomized range finder + small SVD; returns
    ``(u, s, vt)``.  Call with full float32 products (no TF32)."""
    y = torch.mm(a_dense, omega)
    q, _ = torch.linalg.qr(y)
    # one subspace iteration for accuracy
    z = torch.mm(a_dense.T, q)
    q2, _ = torch.linalg.qr(z)
    y2 = torch.mm(a_dense, q2)
    q, _ = torch.linalg.qr(y2)
    b = torch.mm(q.T, a_dense)
    u_small, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = torch.mm(q, u_small)
    return u, s, vt


def _item_major(components: torch.Tensor) -> torch.Tensor:
    """(k, n_items) components as the transposed view of an item-major
    (n_items, k) table, whose rows the row gather and the batch route read."""
    return components.T.contiguous().T


def component_scores(user_components, item_components, user_num: int, item_nums: np.ndarray, mask: np.ndarray, scores: np.ndarray):
    """Write the known candidates' scores ``user row @ item_components[:,
    nums]`` into ``scores[mask]``: the candidates' item rows gathered (P),
    the product on the tables' device and one readback."""
    table = item_components.T
    rows = gather_rows(table, torch.as_tensor(item_nums[mask].astype(np.int32), device=table.device))
    scores[mask] = (rows @ user_components[user_num]).cpu().numpy()


class BiasedSVDScorer(Component):
    """Biased SVD scorer (reference: sklearn/svd.py:47).  ``user_components``
    (n_users, k) = U·diag(S) and ``item_components`` (k, n_items) = Vt are
    float32 tensors on the training device; ``bias`` is the
    :class:`BiasModel` the ratings were centered with."""

    config: BiasedSVDConfig

    bias: BiasModel
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
        config: BiasedSVDConfig | dict | None,
        users: Vocabulary,
        items: Vocabulary,
        device: str | torch.device | None = None,
    ) -> "BiasedSVDScorer":
        """A scorer from the JAX package's arrays: ``user_components``,
        ``item_components`` and its ``BiasModel``'s ``global_bias``,
        ``item_biases`` and ``user_biases``; the tables go to ``device``
        (the card unless ``"cpu"``)."""
        dev = resolve_device(device)
        scorer = cls(config)
        scorer.users, scorer.items = users, items
        scorer.user_components = torch.tensor(np.asarray(params["user_components"], dtype=np.float32), device=dev)
        scorer.item_components = _item_major(torch.tensor(np.asarray(params["item_components"], dtype=np.float32), device=dev))
        scorer.bias = BiasModel.from_numpy(params, scorer.config.damping, users, items)
        return scorer

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        dev = options.configured_device()
        csr = data.interaction_matrix().csr("rating")
        if csr.values is None:
            raise ValueError("BiasedSVD requires ratings")
        self.bias = BiasModel.learn(data, damping=self.config.damping, device=dev)
        dense = dense_on_device(self.bias.transform_matrix(csr), dev)

        k = min(self.config.features, min(dense.shape) - 1)
        rng = options.random_generator()
        omega = torch.from_numpy(rng.standard_normal((dense.shape[1], k + 8)).astype(np.float32)).to(dev)
        u, s, vt = _rand_svd_core(dense, omega, self.config.n_iter)
        del dense
        self.user_components = u[:, :k] * s[None, :k]
        self.item_components = _item_major(vt[:k, :])
        self.users = data.users
        self.items = data.items
        _log.info("trained BiasedSVD", features=k)

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        """Scores on the tables' device plus the biases; a user without a
        row gets the biases alone, an unknown item NaN."""
        query = RecQuery.create(query)
        user_num = None
        if query.user_id is not None:
            user_num = self.users.number(query.user_id, missing="negative")
        item_nums = items.numbers(vocabulary=self.items, missing="negative")
        mask = item_nums >= 0
        scores = np.full(len(items), np.nan, dtype=np.float32)
        if user_num is not None and user_num >= 0:
            component_scores(self.user_components, self.item_components, user_num, item_nums, mask, scores)
        else:
            scores[mask] = 0.0
        biases, _ = self.bias.compute_for_items(items, query.user_id, query.user_items)
        return ItemList(items, scores=scores + biases)
