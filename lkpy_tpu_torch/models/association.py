"""
Association-rule item scoring.

Port of ``lkpy_tpu/models/association.py`` (reference:
src/lenskit/knn/association.py:59): item relatedness by conditional
probability P[i|j], lift, or damped lift from co-occurrence counts; scoring
by the mean, the max or the mean of the top ``max_nbrs`` over the query's
reference items.

The co-occurrence counts are the Gram of the binary user-item matrix on the
training device (:func:`lkpy_tpu_torch.ops.knn.cooccurrence_gram`, EASE's
Gram, integer counts exact in float32); the diagonal is zeroed and each row
normalized there, in float64 a row block and stored as float32, the JAX
package's arithmetic.  The scores stay there as a dense ``score_table``; a
query gathers its history's rows (:func:`lkpy_tpu_torch.ops.gather_rows.
gather_rows`) and reduces over them on the device.  ``assoc_scores``, the
JAX package's SciPy matrix, is built from the table when first read.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import scipy.sparse as sps
import torch
from pydantic import BaseModel

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.logging import Stopwatch, get_logger
from lkpy_tpu_torch.models._dense import history_scores
from lkpy_tpu_torch.ops.knn import cooccurrence_gram
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

_log = get_logger(__name__)

__all__ = ["AssociationConfig", "AssociationScorer"]

#: rows of the table normalized at a time (in float64)
_ROW_BLOCK = 2048


class AssociationConfig(BaseModel):
    """Configuration (reference: association.py:30)."""

    method: Literal["probability", "lift"] = "probability"
    damping: float = 0.0
    max_nbrs: int | None = None


def _normalize(gram: torch.Tensor, counts: np.ndarray, n_groups: int, config: AssociationConfig) -> torch.Tensor:
    """The association scores from the co-occurrence ``gram``, in place:
    the diagonal zeroed, each entry over its row item's damped count (and,
    for lift, times ``n_groups`` over its column item's damped count), in
    float64 and stored as float32.  The damped counts are float32, as the
    JAX package forms them."""
    dev = gram.device
    den = torch.from_numpy((counts.astype(np.float32) + np.float32(config.damping)).astype(np.float64)).to(dev)
    gram.fill_diagonal_(0.0)
    for lo in range(0, gram.shape[0], _ROW_BLOCK):
        block = gram[lo : lo + _ROW_BLOCK]
        vals = block.double() / den[lo : lo + _ROW_BLOCK, None]
        if config.method == "lift":
            vals = vals * n_groups / den[None, :]
        # pairs that never co-occur stay 0 (a count of 0 with no damping would make them NaN)
        block.copy_(torch.where(block != 0, vals, 0.0))
    return gram


class AssociationScorer(Component):
    """Association-rule scorer (reference: association.py:59).
    ``score_table`` is the dense (n_items, n_items) float32 table on the
    training device; ``assoc_scores`` its SciPy form, built when read."""

    config: AssociationConfig

    items: Vocabulary
    item_freqs: np.ndarray
    score_table: torch.Tensor

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "score_table")

    @is_trained.setter
    def is_trained(self, v):
        pass

    @property
    def assoc_scores(self) -> sps.csr_array:
        """The scores as the JAX package's ``sps.csr_array`` (explicit
        entries where the score is non-zero), built from ``score_table`` on
        first read and kept."""
        cached = self.__dict__.get("_assoc_scores")
        if cached is None:
            dense = self.score_table.cpu().numpy()
            rows, cols = np.nonzero(dense)
            cached = sps.csr_array((dense[rows, cols], (rows, cols)), shape=dense.shape)
            self._assoc_scores = cached
        return cached

    @classmethod
    def from_numpy(
        cls,
        assoc_scores,
        item_freqs: np.ndarray,
        items: Vocabulary,
        config: AssociationConfig | dict | None = None,
        device: str | torch.device | None = None,
    ) -> "AssociationScorer":
        """A scorer from the JAX package's ``assoc_scores`` (a SciPy sparse
        matrix) and ``item_freqs`` on ``device`` (the card unless
        ``"cpu"``)."""
        dev = resolve_device(device)
        scorer = cls(config)
        scorer.score_table = torch.tensor(np.asarray(sps.csr_array(assoc_scores).todense(), dtype=np.float32), device=dev)
        scorer.item_freqs = np.asarray(item_freqs, dtype=np.int32)
        scorer.items = items
        return scorer

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        sw = Stopwatch()
        matrix = data.interaction_matrix()
        ui = matrix.csr(None)
        counts = np.bincount(ui.colind, minlength=ui.ncols)
        gram = cooccurrence_gram(ui, device=options.configured_device())
        self.__dict__.pop("_assoc_scores", None)
        self.score_table = _normalize(gram, counts, matrix.n_rows, self.config)
        self.items = data.items
        self.item_freqs = counts.astype(np.int32)
        _log.info("trained association rules", time=str(sw), n_items=data.item_count)

    def _reduce(self, rows: torch.Tensor) -> torch.Tensor:
        """The reduction over the (R, n_items) history rows: the max for
        ``max_nbrs=1``, the mean for None, else the mean of each column's
        ``max_nbrs`` largest values."""
        k = self.config.max_nbrs
        if k == 1:
            return rows.max(dim=0).values
        if k is None:
            return rows.mean(dim=0)
        return torch.topk(rows, min(k, rows.shape[0]), dim=0).values.mean(dim=0)

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        query = RecQuery.create(query)
        return ItemList(items, scores=history_scores(self.score_table, self.items, query, items, self._reduce))
