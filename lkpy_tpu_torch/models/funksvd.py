"""
FunkSVD explicit-feedback matrix factorization.

Port of ``lkpy_tpu/models/funksvd.py`` (reference: src/lenskit/funksvd.py:
80,111; Rust src/accel/funksvd.rs:39): featurewise SGD over bias residuals
with trailing-value estimation and range clamping, each feature trained by
minibatch SGD (:func:`lkpy_tpu_torch.ops.funksvd.train_feature`), the JAX
package's documented deviation from exact-order sequential SGD.

The ratings are shuffled on the host by the options' NumPy generator, the
JAX package's draw, and uploaded once; the residual estimates ``est`` stay
on the training device and take each trained feature's products there
(the JAX package updates them on the host once a feature).  The tables stay
on the training device; a query's candidates' rows are gathered there
(:func:`lkpy_tpu_torch.ops.gather_rows.gather_rows`) and only the scores
come back.
"""

from __future__ import annotations

import numpy as np
import torch
from pydantic import AliasChoices, BaseModel, Field

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.config import EmbeddingSizeMixin
from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.logging import Stopwatch, get_logger, item_progress
from lkpy_tpu_torch.models.bias import BiasModel
from lkpy_tpu_torch.ops.funksvd import train_feature
from lkpy_tpu_torch.ops.gather_rows import gather_rows
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

_log = get_logger(__name__)

__all__ = ["FunkSVDConfig", "FunkSVDScorer"]

INITIAL_VALUE = 0.1


class FunkSVDConfig(EmbeddingSizeMixin, BaseModel):
    """Configuration (reference: funksvd.py:34)."""

    embedding_size: int = Field(default=64, validation_alias=AliasChoices("embedding_size", "features"))
    epochs: int = 100
    learning_rate: float = 0.001
    regularization: float = 0.015
    damping: float | dict[str, float] = 5.0
    range: tuple[float, float] | None = None
    batch_size: int = 8192
    "The minibatch size of the featurewise SGD."


def training_arrays(csr, bias: BiasModel, rng: np.random.Generator, batch: int, device: torch.device):
    """The ratings of ``csr`` in the order of ``rng.permutation`` (the JAX
    package's draw), as :func:`~lkpy_tpu_torch.ops.funksvd.train_feature`
    takes them on ``device``: ``(users, items, ratings, mask, est)``, padded
    to a multiple of ``batch`` (padding slots: user and item 0, mask and
    baseline 0); ``est`` is each rating's bias baseline."""
    coo = csr.to_coo()
    n = csr.nnz
    shuf = rng.permutation(n)
    users = coo.row[shuf].astype(np.int64)
    items = coo.col[shuf].astype(np.int64)
    ratings = coo.values[shuf].astype(np.float32)
    est = np.full(n, bias.global_bias, dtype=np.float32)
    est += bias.item_biases[items]
    est += bias.user_biases[users]
    pad = (-n) % batch

    def padded(a):
        return torch.from_numpy(np.concatenate([a, np.zeros(pad, dtype=a.dtype)])).to(device)

    return padded(users), padded(items), padded(ratings), padded(np.ones(n, dtype=np.float32)), padded(est)


class FunkSVDScorer(Component):
    """FunkSVD scorer (reference: funksvd.py:80).  ``user_embeddings``
    (n_users, k) and ``item_embeddings`` (n_items, k) are float32 tensors
    on the training device; ``bias`` is the :class:`BiasModel` of the
    ratings (NumPy arrays on the host)."""

    config: FunkSVDConfig

    bias: BiasModel
    users: Vocabulary
    items: Vocabulary
    user_embeddings: torch.Tensor
    item_embeddings: torch.Tensor

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "item_embeddings")

    @is_trained.setter
    def is_trained(self, v):
        pass

    @classmethod
    def from_numpy(
        cls,
        params: dict,
        config: FunkSVDConfig | dict | None,
        users: Vocabulary,
        items: Vocabulary,
        device: str | torch.device | None = None,
    ) -> "FunkSVDScorer":
        """A scorer from trained parameters held as NumPy arrays, as the JAX
        package's ``FunkSVDScorer`` and its ``BiasModel`` hold them:
        ``user_embeddings``, ``item_embeddings``, ``global_bias``,
        ``item_biases`` and ``user_biases``; the bias damping is the
        config's.  The tables go to ``device`` (the card unless ``"cpu"``)."""
        dev = resolve_device(device)
        scorer = cls(config)
        scorer.users = users
        scorer.items = items
        for name in ("user_embeddings", "item_embeddings"):
            setattr(scorer, name, torch.tensor(np.asarray(params[name], dtype=np.float32), device=dev))
        scorer.bias = BiasModel.from_numpy(params, scorer.config.damping, users, items)
        return scorer

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        sw = Stopwatch()
        dev = options.configured_device()
        csr = data.interaction_matrix().csr("rating")
        if csr.values is None:
            raise ValueError("FunkSVD requires rating values")
        n_users, n_items = csr.shape
        n = csr.nnz

        self.bias = BiasModel.learn(data, damping=self.config.damping, device=dev)

        if self.config.range is not None:
            rmin, rmax = self.config.range
        else:
            rmin, rmax = -np.inf, np.inf
        batch = min(self.config.batch_size, n)
        t_users, t_items, t_ratings, t_mask, t_est = training_arrays(csr, self.bias, options.random_generator(), batch, dev)

        esize = self.config.embedding_size
        uemb = torch.full((n_users, esize), INITIAL_VALUE, dtype=torch.float32, device=dev)
        iemb = torch.full((n_items, esize), INITIAL_VALUE, dtype=torch.float32, device=dev)
        rmses = []
        with item_progress("FunkSVD dimensions", esize) as pb:
            for f in range(esize):
                trail = float(np.float32(INITIAL_VALUE * INITIAL_VALUE * (esize - f - 1)))
                u_col, i_col, rmse = train_feature(
                    t_users, t_items, t_ratings, t_mask, t_est, uemb[:, f], iemb[:, f], trail,
                    self.config.learning_rate, self.config.regularization, rmin, rmax,
                    n_users, n_items, self.config.epochs, batch,
                )  # fmt: skip
                uemb[:, f] = u_col
                iemb[:, f] = i_col
                real = t_est[:n]
                real.copy_(torch.clamp(real + u_col[t_users[:n]] * i_col[t_items[:n]], rmin, rmax))
                rmses.append(rmse)
                pb.update()
        rmses = torch.stack(rmses).cpu().numpy() if rmses else np.zeros(0, np.float32)
        _log.info("trained FunkSVD", time=str(sw), features=esize, rmse=float(rmses[-1]) if len(rmses) else None)

        self.users = data.users
        self.items = data.items
        self.user_embeddings = uemb
        self.item_embeddings = iemb
        self.feature_rmse = rmses

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        """Score ``items`` for one query where the tables lie: the user's
        row, the candidates' rows gathered (P), the product there and one
        readback of the scores, then the biases on the host.  Unknown
        users score NaN throughout, unknown items NaN."""
        query = RecQuery.create(query)
        user_num = None
        if query.user_id is not None:
            user_num = self.users.number(query.user_id, missing="negative")
        if user_num is None or user_num < 0:
            return ItemList(items, scores=np.full(len(items), np.nan, dtype=np.float32))
        item_nums = items.numbers(vocabulary=self.items, missing="negative")
        mask = item_nums >= 0
        scores = np.full(len(items), np.nan, dtype=np.float32)
        table = self.item_embeddings
        rows = gather_rows(table, torch.as_tensor(item_nums[mask].astype(np.int32), device=table.device))
        scores[mask] = (rows @ self.user_embeddings[user_num]).cpu().numpy()
        biases, _ = self.bias.compute_for_items(items, query.user_id, query.user_items)
        return ItemList(items, scores=scores + biases)
