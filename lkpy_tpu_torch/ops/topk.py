"""
Top-k utilities: retrieval over an item table, masked top-k and the host
``argtopn``.

Port of ``lkpy_tpu/ops/topk.py`` (reference: src/accel/knn/accum.rs,
src/accel/data/sorting.rs).  On a device, top-k is ``torch.topk``; masked
variants push invalid entries to −inf first.  Large catalogs on the card go
to the fused kernel of :mod:`lkpy_tpu_torch.ops.mips_topk`.
"""

from __future__ import annotations

import numpy as np
import torch

from lkpy_tpu_torch.ops.mips_topk import MAX_FUSED_K, mips_topk

__all__ = ["FUSED_RETRIEVAL_MIN_ITEMS", "argtopn", "fused_route", "masked_top_k", "retrieval_topk", "top_n_indices"]

#: catalog size from which retrieval on the card takes the fused kernel.  Set
#: on an NVIDIA H100 80GB HBM3 (700 W): at k = 10 the kernel was faster than
#: ``torch.topk(q @ I.T)`` at every catalog from 27,000 to 500,000 items and
#: every batch of 64, 1,024 and 4,096 queries that ``chip_smoke.py`` times
#: (1.2× at 64 × 27,000, 2.4× at 64 × 500,000, 4.3× at 4,096 × 500,000;
#: PERF.md), so the batch plays no part; smaller catalogs were not measured
#: and stay on the library route.  The JAX package's point is 200,000.
FUSED_RETRIEVAL_MIN_ITEMS = 27_000
#: catalog size from which the product + ``torch.topk`` route scores the
#: queries in row chunks (the JAX package's point for the same)
LARGE_CATALOG_ITEMS = 200_000


def fused_route(device_type: str, B: int, N: int, k: int) -> bool:
    """Does ``retrieval_topk`` take the fused kernel for ``B`` queries
    against ``N`` items on a device of this type?  A pure function."""
    return device_type == "cuda" and N >= FUSED_RETRIEVAL_MIN_ITEMS and 1 <= k <= MAX_FUSED_K


def retrieval_topk(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    *,
    i_bias: torch.Tensor | None = None,
    exact: bool = True,
    recall_target: float = 0.99,
    chunk: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """
    Top-k maximum-inner-product retrieval: ``queries @ items.T``.

    Dispatch:

    - CUDA tensors, at least :data:`FUSED_RETRIEVAL_MIN_ITEMS` items and
      ``k`` ≤ :data:`~lkpy_tpu_torch.ops.mips_topk.MAX_FUSED_K`
      (:func:`fused_route`): the fused kernel, which never writes the
      scores to device memory and spreads a small batch over the card by
      splitting the items;
    - otherwise the product and ``torch.topk``; for a catalog of at least
      :data:`LARGE_CATALOG_ITEMS` in row chunks of ``chunk``, so that only
      a (chunk, N) slab of scores exists at a time.

    Every route is exact, so ``exact`` and ``recall_target`` (the JAX
    package's switch to the TPU's approximate top-k) change nothing here.
    CPU tensors take the plain route, as the JAX package does off the TPU.

    Returns (scores (B, k) descending, item indices (B, k) int32).
    """
    B = queries.shape[0]
    if fused_route(queries.device.type, B, items.shape[0], k):
        return mips_topk(queries, items, k, i_bias=i_bias)
    large = items.shape[0] >= LARGE_CATALOG_ITEMS
    rows = max(1, min(chunk, B)) if large else max(B, 1)
    vals = torch.empty((B, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    for lo in range(0, B, rows):
        s = queries[lo : lo + rows] @ items.T
        if i_bias is not None:
            s += i_bias
        v, i = torch.topk(s, k, dim=1)
        vals[lo : lo + rows] = v
        idx[lo : lo + rows] = i
    return vals, idx


def masked_top_k(values: torch.Tensor, mask: torch.Tensor | None, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """
    Top-k over the last axis with a validity mask.

    Returns (values, indices int32); masked-out or NaN entries are −inf and
    sort last.
    """
    v = torch.where(torch.isnan(values), -torch.inf, values)
    if mask is not None:
        v = torch.where(mask, v, -torch.inf)
    top, idx = torch.topk(v, k, dim=-1)
    return top, idx.to(torch.int32)


def top_n_indices(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the top-n scores (NaN treated as −inf)."""
    _, idx = masked_top_k(scores, None, n)
    return idx


def argtopn(scores: np.ndarray, n: int | None = None) -> np.ndarray:
    """
    Host-side argtopn matching the reference's ``_accel.data.argtopn``
    (reference: src/accel/data/sorting.rs): indices of top-n by descending
    score, NaNs excluded, ties broken by position (stable).
    """
    scores = np.asarray(scores)
    valid = ~np.isnan(scores)
    k = int(valid.sum())
    if n is not None and n >= 0:
        k = min(k, n)
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    return order[:k]
