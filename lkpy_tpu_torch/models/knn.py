"""
Nearest-neighbor collaborative filtering.

Port of ``lkpy_tpu/models/knn.py`` (reference: src/lenskit/knn/item.py:87
``ItemKNNScorer`` and src/lenskit/knn/user.py:76 ``UserKNNScorer``), with
the reference's min_sim/save_nbrs/min_nbrs/max_nbrs semantics
(reference: knn/item.py:41-74).

``train`` builds on the card unless ``TrainingOptions(device="cpu")`` and
leaves the neighbour table (item kNN) or the normalized user vectors and
item buckets (user kNN) there; ``__call__`` scores one query where they lie
and reads scores and counts back once.  Each scorer's ``from_numpy`` builds
one from state trained elsewhere.  Multi-device builds (the JAX package's
``options.mesh``) are not part of the port yet.
"""

from __future__ import annotations

from typing import Literal, NamedTuple

import numpy as np
import torch
from pydantic import AliasChoices, BaseModel, Field, field_validator

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.logging import Stopwatch, get_logger
from lkpy_tpu_torch.ops import knn as knn_ops
from lkpy_tpu_torch.ops.sparse import bucket_rows
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

_log = get_logger(__name__)

__all__ = ["ItemKNNConfig", "ItemKNNScorer", "UserKNNConfig", "UserKNNScorer"]

FeedbackType = Literal["explicit", "implicit"]


class ItemKNNConfig(BaseModel):
    """Configuration (reference: knn/item.py:40)."""

    max_nbrs: int = Field(20, validation_alias=AliasChoices("max_nbrs", "nnbrs", "k"))
    min_nbrs: int = 1
    min_sim: float = 1.0e-6
    save_nbrs: int | None = None
    feedback: FeedbackType = "explicit"
    nbr_table_cap: int = 512
    """Padded-width cap of the stored neighbour table when ``save_nbrs`` is
    None (the reference keeps ragged unbounded rows; a padded table needs a
    cap)."""

    @field_validator("min_sim", mode="after")
    @staticmethod
    def clamp_min_sim(sim) -> float:
        return max(sim, float(np.finfo(np.float32).smallest_normal))

    @property
    def explicit(self) -> bool:
        return self.feedback == "explicit"


class ItemKNNScorer(Component):
    """Item-item kNN (reference: knn/item.py:87; train :121, call :236)."""

    config: ItemKNNConfig

    items: Vocabulary
    item_means: np.ndarray | None
    item_counts: torch.Tensor
    sim_table: knn_ops.NeighborTable

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "sim_table")

    @is_trained.setter
    def is_trained(self, v):
        pass

    @classmethod
    def from_numpy(
        cls,
        indices: np.ndarray,
        sims: np.ndarray,
        item_means: np.ndarray | None,
        items: Vocabulary,
        config: ItemKNNConfig | dict | None = None,
        device: str | torch.device | None = None,
    ) -> "ItemKNNScorer":
        """A scorer from a neighbour table held as NumPy arrays, as the JAX
        package's ``sim_table`` holds it, with its ``item_means`` (None for
        implicit feedback) and item vocabulary; the table goes to ``device``
        (the card unless ``"cpu"``)."""
        dev = resolve_device(device)
        scorer = cls(config)
        scorer.sim_table = knn_ops.NeighborTable(
            torch.tensor(np.asarray(indices, dtype=np.int32), device=dev),
            torch.tensor(np.asarray(sims, dtype=np.float32), device=dev),
        )
        scorer.items = items
        scorer.item_means = None if item_means is None else np.asarray(item_means, dtype=np.float32)
        scorer.item_counts = scorer.sim_table.counts()
        return scorer

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        dev = options.configured_device()
        log = _log.bind(n_items=data.item_count, feedback=self.config.feedback)
        sw = Stopwatch()
        matrix = data.interaction_matrix()
        ui = matrix.csr("rating" if self.config.explicit else None)
        iu = ui.transpose()
        if iu.values is None:
            iu = iu.with_values(np.ones(iu.nnz, dtype=np.float32))
        normed, means = knn_ops.normalize_item_matrix(iu, explicit=self.config.explicit)
        log.debug("normalized item vectors", time=str(sw))
        k = self.config.save_nbrs or self.config.nbr_table_cap
        # ui anchors the large-catalog Gram path's device structure
        self.sim_table = knn_ops.similarity_topk(normed, k, self.config.min_sim, user_major=ui, device=dev)
        self.items = data.items
        self.item_means = means
        self.item_counts = self.sim_table.counts()
        log.info(
            "trained item-item similarity",
            time=str(sw),
            pairs=int(self.item_counts.sum()),
            items_with_nbrs=int((self.item_counts > 0).sum()),
        )

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        query = RecQuery.create(query)
        ratings = query.user_items
        if ratings is None or len(ratings) == 0:
            return ItemList(items, scores=np.full(len(items), np.nan, dtype=np.float32))

        ri_nums = ratings.numbers(vocabulary=self.items, missing="negative")
        ri_mask = ri_nums >= 0
        ti_nums = items.numbers(vocabulary=self.items, missing="negative")
        ti_mask = ti_nums >= 0

        scores = np.full(len(items), np.nan, dtype=np.float32)
        counts = np.zeros(len(items), dtype=np.int32)
        if self.config.explicit:
            ri_vals = ratings.field("rating")
            if ri_vals is None:
                raise RuntimeError("explicit-feedback scorer requires rated history")
            ok = ri_mask & np.isfinite(ri_vals)
            s, c = knn_ops.score_items_explicit(
                self.sim_table,
                ti_nums[ti_mask],
                ri_nums[ok],
                ri_vals[ok],
                self.item_means,
                self.config.max_nbrs,
                self.config.min_nbrs,
            )
        else:
            s, c = knn_ops.score_items_implicit(
                self.sim_table,
                ti_nums[ti_mask],
                ri_nums[ri_mask],
                self.config.max_nbrs,
                self.config.min_nbrs,
            )
        scores[ti_mask] = s
        counts[ti_mask] = c
        return ItemList(items, scores=scores, nbr_counts=counts)


class UserKNNConfig(BaseModel):
    """Configuration (reference: knn/user.py:41)."""

    max_nbrs: int = Field(20, validation_alias=AliasChoices("max_nbrs", "nnbrs", "k"))
    min_nbrs: int = 1
    min_sim: float = 1.0e-6
    feedback: FeedbackType = "explicit"

    @field_validator("min_sim", mode="after")
    @staticmethod
    def clamp_min_sim(sim) -> float:
        return max(sim, float(np.finfo(np.float32).smallest_normal))

    @property
    def explicit(self) -> bool:
        return self.feedback == "explicit"


class _ItemBucket(NamedTuple):
    """One popularity bucket of item rows on the device: the item numbers,
    their raters (padded), the raters' centered ratings and the mask."""

    rows: torch.Tensor  # (B,) int64
    cols: torch.Tensor  # (B, P) int32
    values: torch.Tensor  # (B, P) f32
    mask: torch.Tensor  # (B, P) bool


class UserKNNScorer(Component):
    """User-user kNN (reference: knn/user.py:76): the query-to-user
    similarities are one sparse matvec (``index_add_``); per-item neighbour
    selection runs over popularity-bucketed padded item rows (masked
    top-k), all on the device where training put them."""

    config: UserKNNConfig

    users: Vocabulary
    items: Vocabulary
    user_means: np.ndarray | None

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "_nv_rows")

    @is_trained.setter
    def is_trained(self, v):
        pass

    @classmethod
    def from_numpy(
        cls,
        rowptr: np.ndarray,
        colind: np.ndarray,
        values: np.ndarray | None,
        users: Vocabulary,
        items: Vocabulary,
        config: UserKNNConfig | dict | None = None,
        device: str | torch.device | None = None,
    ) -> "UserKNNScorer":
        """A scorer from the user-item CSR arrays (``values`` the ratings,
        or None for implicit feedback) and both vocabularies, prepared as
        :meth:`train` prepares them, on ``device`` (the card unless
        ``"cpu"``)."""
        scorer = cls(config)
        ui = CSR(np.asarray(rowptr, dtype=np.int64), np.asarray(colind, dtype=np.int32), values, (len(users), len(items)))
        scorer._prepare(ui, users, items, resolve_device(device))
        return scorer

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        matrix = data.interaction_matrix()
        ui = matrix.csr("rating" if self.config.explicit else None)
        self._prepare(ui, data.users, data.items, options.configured_device())

    def _prepare(self, ui: CSR, users: Vocabulary, items: Vocabulary, dev: torch.device) -> None:
        """Center (explicit) and normalize the user vectors on the host, and
        put them and the centered item-major buckets on ``dev``."""
        if ui.values is None:
            ui = ui.with_values(np.ones(ui.nnz, dtype=np.float32))
        self.users = users
        self.items = items

        lens = ui.row_lengths()
        rows = np.repeat(np.arange(ui.nrows), lens)
        vals = ui.values.astype(np.float64)
        if self.config.explicit:
            sums = np.zeros(ui.nrows)
            np.add.at(sums, rows, vals)
            means = np.zeros(ui.nrows, dtype=np.float32)
            np.divide(sums, lens, out=means, where=lens > 0)
            self.user_means = means
            centered = vals - means[rows]
        else:
            self.user_means = None
            centered = vals
        norms = np.zeros(ui.nrows)
        np.add.at(norms, rows, centered * centered)
        norms = np.maximum(np.sqrt(norms), np.finfo(np.float32).smallest_normal)
        normed = (centered / norms[rows]).astype(np.float32)

        # normalized user-vector COO for the similarity matvec
        self._nv_rows = torch.tensor(rows.astype(np.int32), device=dev)
        self._nv_cols = torch.tensor(ui.colind, device=dev)
        self._nv_vals = torch.tensor(normed, device=dev)
        # centered (unnormalized) item-major buckets for scoring
        iu = ui.with_values(centered.astype(np.float32)).transpose()
        self._iu_buckets = [
            _ItemBucket(
                torch.tensor(b.rows.astype(np.int64), device=dev),
                torch.tensor(b.cols, device=dev),
                torch.tensor(b.values, device=dev),
                torch.tensor(b.mask, device=dev),
            )
            for b in bucket_rows(iu, field="rating")
        ]
        self._n_items = iu.nrows

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        query = RecQuery.create(query)
        udata = self._get_user_vector(query)
        if udata is None:
            return ItemList(items, scores=np.full(len(items), np.nan, dtype=np.float32))
        uvec, umean, unum = udata

        dev = self._nv_vals.device
        sims = knn_ops.sparse_matvec(
            self._nv_rows, self._nv_cols, self._nv_vals, torch.from_numpy(uvec).to(dev), n_rows=len(self.users)
        )
        if unum is not None and unum >= 0:
            sims[unum] = 0.0
        sims.masked_fill_(sims < self.config.min_sim, 0.0)

        all_scores = torch.full((self._n_items,), torch.nan, dtype=torch.float32, device=dev)
        all_counts = torch.zeros(self._n_items, dtype=torch.int32, device=dev)
        for b in self._iu_buckets:
            s, c = knn_ops.score_users_bucket(
                b.cols, b.values, b.mask, sims, self.config.max_nbrs, self.config.min_nbrs, self.config.explicit
            )
            all_scores[b.rows] = s
            all_counts[b.rows] = c
        if self.config.explicit:
            all_scores += umean

        ti_nums = items.numbers(vocabulary=self.items, missing="negative")
        ti_mask = ti_nums >= 0
        scores = np.full(len(items), np.nan, dtype=np.float32)
        counts = np.zeros(len(items), dtype=np.int32)
        scores[ti_mask], counts[ti_mask] = knn_ops.target_values(all_scores, all_counts, ti_nums[ti_mask])
        return ItemList(items, scores=scores, nbr_counts=counts)

    def _get_user_vector(self, query: RecQuery):
        """The query user's normalized dense vector on the host
        (reference: user.py:257 ``_get_user_data``)."""
        ratings = query.user_items
        unum = None
        if query.user_id is not None:
            unum = self.users.number(query.user_id, missing="negative")
        if ratings is None or len(ratings) == 0 or (self.config.explicit and ratings.field("rating") is None):
            return None
        nums = ratings.numbers(vocabulary=self.items, missing="negative")
        mask = nums >= 0
        if not mask.any():
            return None
        vec = np.zeros(self._n_items, dtype=np.float32)
        if self.config.explicit:
            vals = ratings.field("rating").astype(np.float64)
            umean = float(vals[mask].mean())
            vec[nums[mask]] = vals[mask] - umean
        else:
            umean = 0.0
            vec[nums[mask]] = 1.0
        norm = np.linalg.norm(vec)
        vec /= max(norm, float(np.finfo(np.float32).smallest_normal))
        return vec, umean, unum
