"""
Device batch recommendation.

Port of ``lkpy_tpu/batch/device.py``: embedding-family scorers are served
for a whole batch of users at once through the engine in
:mod:`lkpy_tpu_torch.batch.serving` — fold-in (or the trained user table),
one matrix product against the item table, history masking from the device
CSR, and a top-n — and the results come back as an
:class:`~lkpy_tpu_torch.data.ArrayTopNILC`.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.batch.serving import PendingServe, enqueue_serve
from lkpy_tpu_torch.data import ArrayTopNILC, ItemListCollection, MatrixRelationshipSet

__all__ = [
    "PendingRecommend",
    "device_recommend",
    "device_recommend_async",
    "invalidate_device_cache",
]

_dev_cache: dict = {}
_DEV_CACHE_MAX = 32


def invalidate_device_cache() -> None:
    """Drop all cached device copies of host arrays.

    Call after mutating a scorer's tables or a training matrix IN PLACE
    between serving calls: the cache assumes host arrays do not change."""
    _dev_cache.clear()


def _cached_device(arr, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device`` once per array object.

    Keyed by object identity plus the buffer address, shape and dtype (so a
    reallocated array misses) and the device; an entry leaves when its array
    is collected, and the cache keeps at most ``_DEV_CACHE_MAX`` entries.
    Tensors are moved with ``.to(device)``, which is free where they
    already are."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    key = (id(arr), arr.__array_interface__["data"][0], arr.shape, arr.dtype.str, str(device))
    hit = _dev_cache.get(key)
    if hit is not None and hit[0]() is arr:
        return hit[1]
    dev = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    ref = weakref.ref(arr, lambda _r, key=key: _dev_cache.pop(key, None))
    while len(_dev_cache) >= _DEV_CACHE_MAX:
        _dev_cache.pop(next(iter(_dev_cache)))
    _dev_cache[key] = (ref, dev)
    return dev


def _extract_arrays(scorer) -> dict | None:
    """Pull the user and item tables (and any biases) out of an
    embedding-family scorer."""
    if hasattr(scorer, "batch_score_arrays"):
        return scorer.batch_score_arrays()
    if hasattr(scorer, "user_embeddings") and hasattr(scorer, "item_embeddings"):
        # as in the JAX package, a scorer without its user table (trained
        # with user_embeddings=False) is not served in batch
        if scorer.user_embeddings is None or scorer.item_embeddings is None:
            return None
        return {"u_embed": scorer.user_embeddings, "i_embed": scorer.item_embeddings}
    return None


class PendingRecommend:
    """An enqueued batch-recommend call; ``result()`` waits for the
    readback and assembles the :class:`ItemListCollection`."""

    def __init__(self, pending: PendingServe, user_ids, nums, key_field, items_vocab):
        self._pending = pending
        self._user_ids = user_ids
        self._nums = nums
        self._key_field = key_field
        self._items_vocab = items_vocab

    def result(self) -> ItemListCollection:
        scores_s, idx_s, order = self._pending.finalize()
        user_ids, nums = self._user_ids, self._nums
        n = idx_s.shape[1]  # may be < requested n for tiny catalogs
        N = len(user_ids)
        nums_out = np.zeros((N, n), np.int32)
        scores_out = np.full((N, n), -np.inf, np.float32)
        lengths = np.zeros(N, np.int64)
        nums_out[order] = idx_s
        scores_out[order] = scores_s
        # -inf (masked history) sorts to the tail, so the finite prefix is
        # the valid list; unknown users keep length 0 (empty lists)
        lengths[order] = np.isfinite(scores_s).sum(axis=1) * (nums[order] >= 0)
        return ArrayTopNILC([self._key_field], list(user_ids), nums_out, scores_out, lengths, self._items_vocab)


def device_recommend(scorer, user_ids, n: int, matrix: MatrixRelationshipSet, **kw) -> ItemListCollection:
    """
    Batch top-N recommendation on the device.  See
    :func:`device_recommend_async` for the arguments.
    """
    return device_recommend_async(scorer, user_ids, n, matrix, **kw).result()


def device_recommend_async(
    scorer,
    user_ids,
    n: int,
    matrix: MatrixRelationshipSet,
    *,
    chunk: int = 1024,
    key_field: str = "user_id",
    exact: bool | None = None,
    device: str | torch.device | None = None,
) -> PendingRecommend:
    """
    Enqueue a batch top-N recommendation; returns a :class:`PendingRecommend`
    whose ``result()`` yields the :class:`ItemListCollection`.

    Args:
        scorer: an embedding-family scorer (trained).
        user_ids: user IDs to recommend for; unknown IDs get empty lists.
        n: list length.
        matrix: the training interaction matrix (for history exclusion and
            user/item vocabularies).
        chunk: users per block.
        exact: accepted for compatibility with the JAX package; the top-n is
            exact either way (exact recall meets any recall target of the
            TPU's approximate path).
        device: where to run; the card unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    arrays = _extract_arrays(scorer)
    if arrays is None:
        raise TypeError(f"{type(scorer).__name__} does not support device batch scoring")
    users_vocab = matrix.row_vocabulary
    items_vocab = matrix.col_vocabulary
    csr = matrix.csr("rating")

    def _f32_resident(arr):
        return _cached_device(arr, dev).to(torch.float32)

    i_emb = _f32_resident(arrays["i_embed"])
    i_bias = arrays.get("i_bias")
    i_bias_t = None if i_bias is None else _f32_resident(i_bias)
    offset = float(arrays.get("offset", 0.0))

    user_ids = np.asarray(user_ids)
    nums = users_vocab.numbers(user_ids, missing="negative")

    # fold-in recomputes user embeddings from history on the device (the
    # reference's default user_embeddings=True); "prefer" uses the table
    use_fold = (
        hasattr(scorer, "device_fold_kernel")
        and getattr(getattr(scorer, "config", None), "user_embeddings", None) != "prefer"
    )
    kern = None
    kern_args = ()
    u_table = u_bias_t = None
    # implicit fold-in without ratings needs only the history structure
    needs_vals = use_fold and getattr(scorer, "fold_in_needs_ratings", True)
    if use_fold:
        kern, kern_args = scorer.device_fold_kernel()
        kern_args = tuple(_cached_device(a, dev) if isinstance(a, (torch.Tensor, np.ndarray)) else a for a in kern_args)
    else:
        u_table = _f32_resident(arrays["u_embed"])
        u_bias = arrays.get("u_bias")
        u_bias_t = None if u_bias is None else _f32_resident(u_bias)

    pending = enqueue_serve(
        nums,
        csr,
        n=n,
        n_items=len(items_vocab),
        i_emb=i_emb,
        i_bias=i_bias_t,
        offset=offset,
        device=dev,
        kern=kern,
        kern_args=kern_args,
        needs_vals=needs_vals,
        u_table=u_table,
        u_bias=u_bias_t,
        block=chunk,
    )
    return PendingRecommend(pending, user_ids, nums, key_field, items_vocab)
