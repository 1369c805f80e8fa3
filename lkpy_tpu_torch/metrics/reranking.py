"""
Reranking comparison metrics (port of ``lkpy_tpu/metrics/reranking.py``;
reference: src/lenskit/metrics/reranking/_rbo.py, _lip.py) — API-compatible
signatures and semantics with the reference.
"""

from __future__ import annotations

import numpy as np

from lkpy_tpu_torch.data import ItemList
from lkpy_tpu_torch.metrics._weighting import GeometricRankWeight, RankWeight

__all__ = ["rank_biased_overlap", "least_item_promoted"]


def rank_biased_overlap(
    reference: ItemList,
    reranked: ItemList,
    weight: RankWeight | None = None,
    n: int = 10,
) -> float:
    """
    Rank-biased overlap between two rankings (Webber et al. 2010;
    reference: metrics/reranking/_rbo.py:15): the weighted average of
    prefix-agreement at depths 1..n, normalized by the total weight —
    identical lists score exactly 1.0, disjoint lists 0.0.

    Args:
        reference: the base ranking.
        reranked: the ranking to compare.
        weight: rank weighting (default ``GeometricRankWeight(0.85)``).
        n: the depth to which to compute the overlap.
    """
    if weight is None:
        weight = GeometricRankWeight(0.85)
    weights = weight.weight(np.arange(1, n + 1))

    total = 0.0
    total_weights = 0.0
    ref_ids = reference.ids()
    rr_ids = reranked.ids()
    for d, w in enumerate(weights, start=1):
        overlap = len(np.intersect1d(ref_ids[:d], rr_ids[:d], assume_unique=True))
        total += (overlap / d) * w
        total_weights += w
    return total / total_weights


def least_item_promoted(reference: ItemList, reranked: ItemList, n: int = 10) -> float:
    """
    Least Item Promoted (reference: metrics/reranking/_lip.py:14): how many
    positions beyond the top-``n`` the worst-ranked (in the base ranking)
    item of the reranked top-``n`` was promoted from; 0 when nothing came
    from beyond ``n``, NaN when the base ranking is empty.
    """
    if len(reference) == 0:
        return np.nan
    reference_ids = reference.ids()
    lip_rank = n
    for item_id in reranked[:n].ids():
        idx = np.where(reference_ids == item_id)[0]
        if idx.size > 0:
            lip_rank = max(lip_rank, int(idx[0]))
    return float(lip_rank - n)
