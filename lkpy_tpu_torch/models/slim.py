"""
SLIM: Sparse LInear Methods (Ning & Karypis 2011).

Port of ``lkpy_tpu/models/slim.py`` (reference: src/lenskit/knn/slim.py:53;
Rust CD at src/accel/slim/mod.rs:58): trained with batched FISTA on the
training device (:func:`lkpy_tpu_torch.ops.slim.train_slim`).  ``weights``
is the JAX package's host CSR; the scorer also keeps the weights as a dense
float32 table on the training device, where a query's scores are the sum of
its history's weight rows (gathered by
:func:`lkpy_tpu_torch.ops.gather_rows.gather_rows`), with one readback.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch
from pydantic import BaseModel

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data import CSR, Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.logging import Stopwatch, get_logger, item_progress
from lkpy_tpu_torch.models._dense import dense_on_device, history_scores
from lkpy_tpu_torch.ops.slim import train_slim
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import TrainingOptions

_log = get_logger(__name__)

__all__ = ["SLIMConfig", "SLIMScorer"]


class SLIMConfig(BaseModel):
    """Hyperparameters (reference: slim.py:30)."""

    l1_reg: float = 1.0
    l2_reg: float = 1.0
    max_iters: int = 100
    max_nbrs: int | None = None


class SLIMScorer(Component):
    """SLIM item scorer (reference: slim.py:53).

    ``weights`` is the transposed weight matrix: w[i, j] is the weight of
    predictor item i for target item j (reference: slim.py:84), a host
    CSR; ``weight_table`` holds the same weights dense on the training
    device."""

    config: SLIMConfig

    items: Vocabulary
    weights: CSR
    weight_table: torch.Tensor

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "weights")

    @is_trained.setter
    def is_trained(self, v):
        pass

    @classmethod
    def from_numpy(
        cls,
        weights,
        items: Vocabulary,
        config: SLIMConfig | dict | None = None,
        device: str | torch.device | None = None,
    ) -> "SLIMScorer":
        """A scorer from the JAX package's weight CSR (any object with
        ``to_scipy()``), a SciPy sparse matrix or a dense array, on
        ``device`` (the card unless ``"cpu"``)."""
        dev = resolve_device(device)
        sp = sps.csr_array(weights.to_scipy() if hasattr(weights, "to_scipy") else weights)
        scorer = cls(config)
        scorer.weights = CSR.from_scipy(sp)
        scorer.weight_table = torch.tensor(np.asarray(sp.todense(), dtype=np.float32), device=dev)
        scorer.items = items
        return scorer

    def train(self, data: Dataset, options: TrainingOptions | None = None):
        options = options or TrainingOptions()
        if not options.retrain and self.is_trained:
            return
        sw = Stopwatch()
        dev = options.configured_device()
        ui = data.interaction_matrix().csr(None)
        ui = ui.with_values(np.ones(ui.nnz, dtype=np.float32))
        with item_progress("SLIM columns", data.item_count) as pb:
            self.weights = train_slim(ui, self.config.l1_reg, self.config.l2_reg, self.config.max_iters, progress=pb, device=dev)
        self.weight_table = dense_on_device(self.weights, dev)
        self.items = data.items
        _log.info("trained SLIM", time=str(sw), nnz=self.weights.nnz)

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        """score(j) = the sum over the history's predictor items i of w[i, j]."""
        query = RecQuery.create(query)
        return ItemList(items, scores=history_scores(self.weight_table, self.items, query, items, lambda rows: rows.sum(dim=0)))
