"""Dense tables on the device: the rating matrix of the models that factor
it whole (BiasedSVD, NMF), scattered there from a host CSR, and the
item-by-item tables (SLIM's weights, association's scores) that a query
reads by its history's rows."""

from __future__ import annotations

import numpy as np
import torch

from lkpy_tpu_torch.data import CSR, ItemList, RecQuery, Vocabulary
from lkpy_tpu_torch.ops.gather_rows import gather_rows
from lkpy_tpu_torch.ops.knn import _host_tensor, _row_numbers

__all__ = ["dense_on_device", "history_scores"]


def dense_on_device(csr: CSR, device: torch.device, *, structural: bool = False) -> torch.Tensor:
    """The dense float32 (nrows, ncols) matrix of ``csr`` on ``device``,
    zeros where it has no entry, scattered there from the uploaded entries
    (ones for a ``structural`` matrix or one without values)."""
    out = torch.zeros(csr.shape, dtype=torch.float32, device=device)
    rows, cols = _row_numbers(csr.rowptr, device), _host_tensor(csr.colind, device).long()
    if structural or csr.values is None:
        out[rows, cols] = 1.0
    else:
        out[rows, cols] = _host_tensor(csr.values.astype(np.float32, copy=False), device)
    return out


def history_scores(table: torch.Tensor, items_vocab: Vocabulary, query: RecQuery, items: ItemList, reduce) -> np.ndarray:
    """Scores of ``items`` from the rows of an (n_items, n_items) ``table``
    of the query's history items, gathered on the table's device (P) and
    reduced there over the history by ``reduce`` (a function of the (R,
    n_items) rows), with one readback of the candidates' scores.  NaN for
    every item when the query has no known history item, and for unknown
    items."""
    scores = np.full(len(items), np.nan, dtype=np.float32)
    refs = query.user_items
    if refs is None or len(refs) == 0:
        return scores
    r_nums = refs.numbers(vocabulary=items_vocab, missing="negative")
    r_good = r_nums[r_nums >= 0]
    if len(r_good) == 0:
        return scores
    t_nums = items.numbers(vocabulary=items_vocab, missing="negative")
    t_mask = t_nums >= 0
    dev = table.device
    all_scores = reduce(gather_rows(table, torch.as_tensor(r_good.astype(np.int32), device=dev)))
    scores[t_mask] = all_scores[torch.as_tensor(t_nums[t_mask].astype(np.int64), device=dev)].cpu().numpy()
    return scores
