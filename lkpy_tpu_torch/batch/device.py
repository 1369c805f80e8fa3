"""
Device batch recommendation.

Port of ``lkpy_tpu/batch/device.py``: embedding-family scorers are served
for a whole batch of users at once through the engine in
:mod:`lkpy_tpu_torch.batch.serving` — fold-in (or the trained user table),
one matrix product against the item table, history masking from the device
CSR, and a top-n — and the results come back as an
:class:`~lkpy_tpu_torch.data.ArrayTopNILC`.  With ``mesh=`` each block's
users split over the mesh's ``data`` slots (the TPU package's batch
sharding, the reference's Ray query fan-out, batch/_ray.py).
"""

from __future__ import annotations

import weakref
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.batch.serving import PendingServe, enqueue_serve
from lkpy_tpu_torch.config import lkpy_tpu_config
from lkpy_tpu_torch.data import ArrayTopNILC, ItemListCollection, MatrixRelationshipSet
from lkpy_tpu_torch.logging import Stopwatch, get_logger
from lkpy_tpu_torch.logging.tracing import new_request, span

_log = get_logger(__name__)

__all__ = [
    "BatchScorer",
    "PendingRecommend",
    "device_recommend",
    "device_recommend_async",
    "invalidate_device_cache",
    "supports_device_batch",
    "try_device_recommend",
]


@runtime_checkable
class BatchScorer(Protocol):  # pragma: no cover - protocol
    """Scorers that can score all items for a batch of users on the device."""

    def batch_score_arrays(self) -> dict:
        """Return the tables for batch scoring:
        {"u_embed": (n_users, k), "i_embed": (n_items, k),
         "u_bias": optional (n_users,), "i_bias": optional (n_items,),
         "offset": optional scalar}."""
        ...


_dev_cache: dict = {}
_DEV_CACHE_MAX = 32


def invalidate_device_cache() -> None:
    """Drop all cached device copies of host arrays, and every registered
    residency cache (the kNN build's user-major structure).

    Call after mutating a scorer's tables or a training matrix IN PLACE
    between serving calls: the caches assume host arrays do not change."""
    import lkpy_tpu_torch.ops.knn  # noqa: F401 — registers its cache
    from lkpy_tpu_torch.utils.residency import invalidate_all_residency

    _dev_cache.clear()
    invalidate_all_residency()


def _cached_device(arr, device: torch.device, uploads: list | None = None) -> torch.Tensor:
    """Copy a host array to ``device`` once per array object.

    Keyed by object identity plus the buffer address, shape and dtype (so a
    reallocated array misses) and the device; an entry leaves when its array
    is collected, and the cache keeps at most ``_DEV_CACHE_MAX`` entries.
    Tensors are moved with ``.to(device)``, which is free where they
    already are.  A copy made here appends its bytes to ``uploads``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    arr = np.asarray(arr)
    key = (id(arr), arr.__array_interface__["data"][0], arr.shape, arr.dtype.str, str(device))
    hit = _dev_cache.get(key)
    if hit is not None and hit[0]() is arr:
        return hit[1]
    dev = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if uploads is not None:
        uploads.append(arr.nbytes)
    # the cache is bound here: at interpreter exit the module's globals are gone before the last arrays
    ref = weakref.ref(arr, lambda _r, key=key, cache=_dev_cache: cache.pop(key, None))
    while len(_dev_cache) >= _DEV_CACHE_MAX:
        _dev_cache.pop(next(iter(_dev_cache)))
    _dev_cache[key] = (ref, dev)
    return dev


def supports_device_batch(scorer) -> bool:
    """Whether :func:`device_recommend` can serve ``scorer``."""
    try:
        arrays = _extract_arrays(scorer)
    except (AttributeError, TypeError):
        return False
    return arrays is not None


def _extract_arrays(scorer) -> dict | None:
    """Pull the user and item tables (and any biases and score offset) out
    of an embedding-family scorer: the ALS, FunkSVD and LightGCN tables,
    FlexMF's ``params``, or BiasedSVD's and NMF's components."""
    if hasattr(scorer, "batch_score_arrays"):
        return scorer.batch_score_arrays()
    if hasattr(scorer, "user_embeddings") and hasattr(scorer, "item_embeddings"):
        # as in the JAX package, a scorer without its user table (trained
        # with user_embeddings=False) is not served in batch
        if scorer.user_embeddings is None or scorer.item_embeddings is None:
            return None
        out = {"u_embed": scorer.user_embeddings, "i_embed": scorer.item_embeddings}
        bias = getattr(scorer, "bias", None)
        if bias is not None and getattr(bias, "user_biases", None) is not None:
            out["u_bias"] = bias.user_biases
            out["i_bias"] = bias.item_biases
            out["offset"] = bias.global_bias
        return out
    if hasattr(scorer, "params"):
        # the FlexMF family: a dict of tables, biases and the scorer's offset
        p = scorer.params
        out = {"u_embed": p["u_embed"], "i_embed": p["i_embed"]}
        for name in ("u_bias", "i_bias"):
            if name in p:
                out[name] = p[name]
        out["offset"] = scorer.score_offset()
        return out
    if hasattr(scorer, "user_components") and hasattr(scorer, "item_components"):
        # BiasedSVD and NMF: the item table is the transposed (k, n_items) components
        out = {"u_embed": scorer.user_components, "i_embed": scorer.item_components.T}
        bias = getattr(scorer, "bias", None)
        if bias is not None and getattr(bias, "user_biases", None) is not None:
            out["u_bias"] = bias.user_biases
            out["i_bias"] = bias.item_biases
            out["offset"] = bias.global_bias
        return out
    return None


def try_device_recommend(pipeline, users, n: int | None, *, mesh=None, exact=None) -> ItemListCollection | None:
    """
    Serve a *standard* top-N pipeline through :func:`device_recommend`, if
    possible (JAX package: batch/device.py:155).

    Conditions: the pipeline has 'scorer'/'ranker'/'history-lookup'/
    'candidate-selector' nodes in the standard shape, the candidate
    selector excludes only user history, and the scorer is embedding-family.
    The call runs on the device where the scorer's item table lies, or over
    ``mesh``'s ``data`` slots.  Returns None when unsupported (the caller
    falls back to per-query execution).
    """
    from lkpy_tpu_torch.models.basic import TopNRanker, TrainingItemsCandidateSelector, UserTrainingHistoryLookup

    try:
        scorer = pipeline.node("scorer").component
        ranker = pipeline.node("ranker").component
        lookup = pipeline.node("history-lookup").component
        cand = pipeline.node("candidate-selector").component
    except (KeyError, AttributeError):
        return None
    if not isinstance(ranker, TopNRanker) or not isinstance(lookup, UserTrainingHistoryLookup):
        return None
    if not isinstance(cand, TrainingItemsCandidateSelector) or cand.config.exclude == "none":
        return None
    if getattr(lookup, "interactions", None) is None or not supports_device_batch(scorer):
        return None
    if n is None or n < 0:
        n = ranker.config.n
    if n is None or n < 0:
        return None
    table = _extract_arrays(scorer)["i_embed"]
    device = table.device if isinstance(table, torch.Tensor) and mesh is None else None
    return device_recommend(scorer, users, n, lookup.interactions, exact=exact, device=device, mesh=mesh)


class PendingRecommend:
    """An enqueued batch-recommend call; ``result()`` waits for the
    readback and assembles the :class:`ItemListCollection`.  With
    ``f16`` the scores are rounded to float16 there, finite ones clamped to
    its range first, as the JAX package's compact readback returns them.
    ``n`` is the requested list length and ``sw`` the call's
    :class:`Stopwatch`, stopped when the lists are assembled."""

    def __init__(self, pending: PendingServe, user_ids, nums, n: int, key_field, items_vocab, sw: Stopwatch, f16: bool = False):
        self._pending = pending
        self._user_ids = user_ids
        self._nums = nums
        self._n = n
        self._key_field = key_field
        self._items_vocab = items_vocab
        self._sw = sw
        self._f16 = f16

    @property
    def n(self) -> int:
        return self._n

    @property
    def sw(self) -> Stopwatch:
        return self._sw

    def result(self) -> ItemListCollection:
        scores_s, idx_s, order = self._pending.finalize()
        with span("lkt.serve.assemble", request=self._pending.request):
            if self._f16:
                top = np.finfo(np.float16).max
                scores_s = np.where(np.isfinite(scores_s), np.clip(scores_s, -top, top), scores_s)
                scores_s = scores_s.astype(np.float16).astype(np.float32)
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
            ilc = ArrayTopNILC([self._key_field], list(user_ids), nums_out, scores_out, lengths, self._items_vocab)
            self._sw.stop()
            timings = self._pending.timings or {}
            _log.info(
                "device batch recommend",
                users=N,
                time=str(self._sw),
                us_per_query=round(self._sw.elapsed() * 1e6 / max(N, 1), 1),
                tunnel_ops=timings.get("tunnel_ops"),
            )
            return ilc


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
    mesh=None,
    timings: dict | None = None,
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
        exact: accepted for compatibility with the JAX package, as is the
            settings' ``serving.exact``; the top-n is exact either way
            (exact recall meets any recall target of the TPU's approximate
            path).
        device: where to run; the card unless ``device="cpu"``.
        mesh: a :class:`~lkpy_tpu_torch.parallel.mesh.Mesh`: each block's
            users split over its ``data`` slots (the block rounds to a
            multiple of them), the tables and the training CSR resident on
            each slot's device, the lists read back once from its first
            slot; ``device`` is not read.
        timings: a dict that ``result()`` fills with the JAX package's keys:
            ``enqueue_s`` and ``readback_s`` on the host clock, ``trace``, a
            list of ``(label, seconds, bytes)`` with one entry for each copy
            between host and device in the call (the training CSR's upload
            where it is not resident yet, the user numbers, the readback),
            and ``tunnel_ops``, the count of those copies.

    ``serving.readback_precision = "f16"`` in the settings returns the
    scores rounded to float16, the JAX package's compact readback; the
    lists are the same.

    The call is the span ``lkt.serve.dispatch``, its readback
    ``lkt.serve.readback`` and the rest of ``result()``
    ``lkt.serve.assemble``, the three under one request id
    (:mod:`lkpy_tpu_torch.logging.tracing`).
    """
    request = new_request()
    with span("lkt.serve.dispatch", request=request):
        dev = resolve_device(device) if mesh is None else mesh.first
        sw = Stopwatch()
        serving = lkpy_tpu_config().serving
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
            mesh=mesh,
            timings=timings,
            request=request,
        )
        f16 = serving.readback_precision == "f16"
        return PendingRecommend(pending, user_ids, nums, n, key_field, items_vocab, sw, f16=f16)
