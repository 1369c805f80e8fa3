"""
k-NN similarity and scoring.

Port of ``lkpy_tpu/ops/knn.py`` (reference: src/accel/knn/item_train.rs:95
— CSR×CSRᵀ row sweep with top-k truncation; src/accel/knn/item_score.rs:
23,72 and user_score.rs:22,62 — per-target bounded heaps).  The JAX package
runs these on XLA (``jnp.dot``, ``lax.top_k``, ``segment_sum``); the port
runs them as torch products, ``torch.topk`` and ``index_add_`` on the device
it is given (the card unless ``device="cpu"``).  No hand kernel lies here.

- **Similarity build** (:func:`similarity_topk`): a padded neighbour table
  ``(n_items, K)`` of thresholded cosine similarities, sim 0 marking
  padding, rows descending, kept on the device it was built on.  A small
  matrix is densified once and each item tile computes ``T @ Aᵀ``; a large
  one accumulates the item Gram ``S = Σ CᵀC`` in float32 over equal dense
  user chunks ``C`` scattered on the device from the user-major entries,
  which are uploaded once and cached on ``user_major``
  (:mod:`lkpy_tpu_torch.utils.residency`); then each row tile of ``S`` is
  thresholded, its diagonal zeroed and cut to the top K.
- **Scoring**: each rated item pushes its neighbour row into a dense
  ``(n_items, R)`` contribution matrix on the table's device; per target the
  ``max_nbrs`` largest sims are reduced, and scores and counts come back
  to the host once a call.

Against the JAX package: the top-k is always exact (``approx`` is TPU
hardware, and an exact table meets :data:`APPROX_RECALL_TARGET`, so
nothing is validated or rebuilt); ``torch.topk`` orders ties arbitrarily,
where ``lax.top_k`` puts the lower index first; there are no uint16/bf16
packed chunk shipments, no per-item scale detection, no asynchronous tile
readback and no f16/u16 compact table.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.utils.residency import ResidentCache

__all__ = [
    "normalize_item_matrix",
    "similarity_topk",
    "score_items_explicit",
    "score_items_implicit",
    "invalidate_knn_caches",
    "NeighborTable",
    "cooccurrence_gram",
]

_SMALLEST_NORMAL = float(np.finfo(np.float32).smallest_normal)

#: neighbour-table recall floor of the JAX package's approximate top-k; the
#: port's top-k is exact (recall 1.0), so no build falls below it
APPROX_RECALL_TARGET = 0.98


class NeighborTable(NamedTuple):
    """Padded top-K neighbour table on one device; sim == 0 marks padding."""

    indices: torch.Tensor  # (n_items, K) int32; unspecified where the sim is 0
    sims: torch.Tensor  # (n_items, K) f32, descending per row

    @property
    def n_items(self) -> int:
        return self.indices.shape[0]

    @property
    def k(self) -> int:
        return self.indices.shape[1]

    def counts(self) -> torch.Tensor:
        """Real neighbours per row (int32, on the table's device)."""
        return (self.sims > 0).sum(dim=1, dtype=torch.int32)


#: the user-major structure of a similarity build on each device, anchored on
#: the caller's ``user_major`` CSR
_resident_struct = ResidentCache("knn_gram", max_entries=4)


def invalidate_knn_caches() -> None:
    """Drop the identity-keyed device copies of user-major structures.
    Called by :func:`lkpy_tpu_torch.batch.device.invalidate_device_cache`;
    the cache keys by object identity, which an IN-PLACE mutation of a CSR
    does not change, so mutating callers must invalidate explicitly."""
    _resident_struct.clear()


def knn_bf16_default() -> bool:
    """Default bf16 policy for the Gram chunks of the similarity build: off
    (the JAX package turns it on only on a TPU); ``LKT_KNN_BF16_GRAM``
    overrides (``0``/``false`` disables, anything else enables)."""
    v = os.environ.get("LKT_KNN_BF16_GRAM")
    if v is not None:
        return v not in ("0", "false", "False")
    return False


def _segment_sums(vals: np.ndarray, rowptr: np.ndarray, nrows: int) -> np.ndarray:
    """Per-row float64 sums of CSR-contiguous values via ``np.add.reduceat``."""
    lens = np.diff(rowptr)
    nz = np.flatnonzero(lens > 0)
    out = np.zeros(nrows, dtype=np.float64)
    if len(nz):
        # consecutive non-empty starts segment the value array exactly
        out[nz] = np.add.reduceat(vals.astype(np.float64, copy=False), rowptr[:-1][nz])
    return out


def normalize_item_matrix(iu_csr: CSR, *, explicit: bool) -> tuple[CSR, np.ndarray | None]:
    """
    Center (explicit only) and unit-normalize item vectors on the host
    (reference: knn/item.py:203 ``_center_ratings`` / :222 ``_normalize_rows``).

    ``iu_csr`` is item-major (rows = items, cols = users).
    """
    lens = iu_csr.row_lengths()
    rowptr = iu_csr.rowptr
    nrows = iu_csr.nrows
    raw = iu_csr.values
    means = None
    if not explicit and (raw is None or (len(raw) and raw[0] > 0 and np.all(raw == raw[0]))):
        # implicit, globally constant values: every entry of row i is exactly
        # 1/sqrt(len_i), one np.repeat instead of four O(nnz) passes
        row_scale = np.zeros(nrows, dtype=np.float32)
        nz = lens > 0
        row_scale[nz] = 1.0 / np.sqrt(lens[nz].astype(np.float64))
        return iu_csr.with_values(np.repeat(row_scale, lens)), None
    vals = raw if raw is not None else np.ones(iu_csr.nnz, dtype=np.float32)
    vals = np.asarray(vals, dtype=np.float32)
    if explicit:
        sums = _segment_sums(vals, rowptr, nrows)
        means = np.zeros(nrows, dtype=np.float32)
        np.divide(sums, lens, out=means, where=lens > 0, casting="unsafe")
        vals = vals - np.repeat(means, lens)
    norms = np.sqrt(_segment_sums(vals * vals, rowptr, nrows))
    scale = 1.0 / np.maximum(norms, np.finfo(np.float32).smallest_normal)
    vals = vals * np.repeat(scale.astype(np.float32), lens)
    return iu_csr.with_values(vals.astype(np.float32, copy=False)), means


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _block_topk(block: torch.Tensor, start: int, min_sim: float, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Threshold + self-mask + top-k of one (tile, n_items) block of rows
    ``start ..``; the block is overwritten (a fresh product, or rows of a
    Gram that is thrown away after its last tile)."""
    block.masked_fill_(block < min_sim, 0.0)
    r = torch.arange(block.shape[0], device=block.device)
    block[r, r + start] = 0.0
    sims, idx = torch.topk(block, k, dim=1)
    return sims, idx.to(torch.int32)


def _host_tensor(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _row_numbers(rowptr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The row of each CSR entry (int64) on ``dev``."""
    lens = _host_tensor(np.diff(rowptr), dev)
    return torch.repeat_interleave(torch.arange(len(lens), device=dev), lens)


def _user_major(iu_csr: CSR, user_major: CSR | None, dev: torch.device):
    """The entries of item-major ``iu_csr`` in user-major order on ``dev``:
    ``(rowptr (host int64), users (int64), items (int64), perm (int64))``,
    ``perm`` giving each entry's position in ``iu_csr``.  The transpose is a
    stable sort by user on the device (each user's items stay ascending).
    When ``user_major`` holds the transposed structure, the result is
    cached on it, so a rebuild over the same matrix skips upload and sort."""
    n_items, n_users = iu_csr.shape
    anchor = None
    if user_major is not None and user_major.shape == (n_users, n_items) and user_major.nnz == iu_csr.nnz:
        anchor = user_major
        hit = _resident_struct.get(anchor, extra=str(dev))
        if hit is not None:
            return hit
    users, perm = torch.sort(_host_tensor(iu_csr.colind, dev).long(), stable=True)
    items = _row_numbers(iu_csr.rowptr, dev)[perm]
    rowptr = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(np.bincount(iu_csr.colind, minlength=n_users), out=rowptr[1:])
    struct = (rowptr, users, items, perm)
    if anchor is not None:
        if not np.array_equal(anchor.rowptr, rowptr):
            raise ValueError("user_major does not hold the structure of iu_csr transposed")
        _resident_struct.put(anchor, struct, extra=str(dev))
    return struct


def _user_chunk(n_users: int, n_items: int, max_dense_bytes: int, slab_bytes: int) -> int:
    """Users per dense chunk: the byte budget's count, equalized over the
    chunks it needs (a budget-sized last chunk can be nearly empty, and the
    product pays for its full shape)."""
    budget = max(max_dense_bytes // (n_items * slab_bytes), 1024)
    n_chunks = max(-(-n_users // budget), 1)
    return -(-n_users // n_chunks)


def _accumulate(S: torch.Tensor, C: torch.Tensor) -> None:
    """S += CᵀC with float32 sums: C is float32, or bf16 values whose
    products are exact in float32 (on the card the bf16 product of
    ``torch.mm(..., out_dtype=torch.float32)``)."""
    if C.dtype == torch.float32:
        S.addmm_(C.T, C)
    elif C.device.type == "cuda":
        S.add_(torch.mm(C.T, C, out_dtype=torch.float32))
    else:
        Cf = C.float()
        S.addmm_(Cf.T, Cf)


def _chunked_gram(rowptr, users, items, vals, n_users: int, n_items: int, user_chunk: int, bf16: bool) -> torch.Tensor:
    """``S = Σ CᵀC`` (n_items, n_items) float32 over dense user chunks ``C``
    scattered from user-major entries on their device; one chunk buffer,
    zeroed and refilled for each chunk."""
    dev = users.device
    S = torch.zeros((n_items, n_items), dtype=torch.float32, device=dev)
    C = torch.empty((user_chunk, n_items), dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
    flat = C.view(-1)
    for ulo in range(0, n_users, user_chunk):
        s, e = int(rowptr[ulo]), int(rowptr[min(ulo + user_chunk, n_users)])
        C.zero_()
        flat[(users[s:e] - ulo) * n_items + items[s:e]] = vals[s:e].to(C.dtype)
        _accumulate(S, C)
    return S


def cooccurrence_gram(
    ui_csr: CSR, *, max_dense_bytes: int = 4 << 30, device: str | torch.device | None = None
) -> torch.Tensor:
    """The item co-occurrence Gram ``XᵀX`` of the binary user-item matrix
    ``X`` (``ui_csr``'s structure) as float32 on ``device`` (the card unless
    ``"cpu"``), summed over dense user chunks as :func:`similarity_topk`'s
    Gram path sums.  Counts are integers, exact in float32 below 2²⁴, so it
    equals SciPy's ``X.T @ X`` to the bit."""
    dev = resolve_device(device)
    n_users, n_items = ui_csr.shape
    users = _row_numbers(ui_csr.rowptr, dev)
    items = _host_tensor(ui_csr.colind, dev).long()
    vals = torch.ones(ui_csr.nnz, dtype=torch.float32, device=dev)
    chunk = _user_chunk(n_users, n_items, max_dense_bytes, 4)
    return _chunked_gram(ui_csr.rowptr, users, items, vals, n_users, n_items, chunk, False)


def similarity_topk(
    iu_csr: CSR,
    k: int,
    min_sim: float = 1.0e-6,
    *,
    tile: int = 8192,
    max_dense_bytes: int = 4 << 30,
    approx: bool | None = None,
    recall_validate: bool = True,
    bf16: bool | None = None,
    user_major: CSR | None = None,
    timings: dict | None = None,
    device: str | torch.device | None = None,
) -> NeighborTable:
    """
    Top-K thresholded cosine similarity (reference: item_train.rs:95) on
    ``device`` (the card unless ``"cpu"``).

    ``iu_csr`` must already be normalized (items × users).  Two paths:

    - ``n_items · n_users · 4 <= max_dense_bytes``: densify A once, then
      ``A[tile] @ Aᵀ`` + threshold + top-k a tile;
    - larger: the float32 Gram ``S = Σ CᵀC`` over equal dense user chunks,
      then a threshold + self-mask + top-k a row tile of ``S``.  With
      ``user_major`` (the same matrix, users × items) the device structure
      is cached on it.  ``timings`` receives ``prep_s`` (upload and
      transpose), ``gram_s``, ``topk_s``, ``user_chunk`` and ``chunks``.

    Sims below ``min_sim`` and the diagonal become 0, ``k`` is clamped to
    ``max(n_items - 1, 1)``.  ``bf16`` makes the Gram chunks bfloat16 with
    float32 sums; None resolves as the JAX package resolves it off a TPU
    (:func:`knn_bf16_default`, and only where its top-k would be approximate
    and validated).  The top-k is exact whatever ``approx`` and
    ``recall_validate`` say.
    """
    dev = resolve_device(device)
    n_items, n_users = iu_csr.shape
    k = min(k, max(n_items - 1, 1))
    if approx is None:
        approx = n_items >= 8192  # the JAX package's choice, which its bf16 default follows
    min_sim = max(float(min_sim), _SMALLEST_NORMAL)
    tile = min(tile, n_items)
    out_idx = torch.empty((n_items, k), dtype=torch.int32, device=dev)
    out_sim = torch.empty((n_items, k), dtype=torch.float32, device=dev)

    def run_tiles(block_of) -> None:
        for lo in range(0, n_items, tile):
            hi = min(lo + tile, n_items)
            out_sim[lo:hi], out_idx[lo:hi] = _block_topk(block_of(lo, hi), lo, min_sim, k)

    vals = iu_csr.values if iu_csr.values is not None else np.ones(iu_csr.nnz, dtype=np.float32)
    if n_items * n_users * 4 <= max_dense_bytes:
        A = torch.zeros((n_items, n_users), dtype=torch.float32, device=dev)
        pos = _row_numbers(iu_csr.rowptr, dev) * n_users + _host_tensor(iu_csr.colind, dev).long()
        A.view(-1)[pos] = _host_tensor(vals, dev).float()
        del pos
        run_tiles(lambda lo, hi: A[lo:hi] @ A.T)
        return NeighborTable(out_idx, out_sim)

    if bf16 is None:
        bf16 = knn_bf16_default() and approx and recall_validate
    user_chunk = _user_chunk(n_users, n_items, max_dense_bytes, 2 if bf16 else 4)
    t0 = time.perf_counter()
    rowptr, users, items, perm = _user_major(iu_csr, user_major, dev)
    um_vals = _host_tensor(vals, dev).float()[perm]
    _sync(dev)
    t1 = time.perf_counter()
    S = _chunked_gram(rowptr, users, items, um_vals, n_users, n_items, user_chunk, bf16)
    del um_vals
    _sync(dev)
    t2 = time.perf_counter()
    run_tiles(lambda lo, hi: S[lo:hi])
    _sync(dev)
    if timings is not None:
        timings.update(
            prep_s=t1 - t0,
            gram_s=t2 - t1,
            topk_s=time.perf_counter() - t2,
            user_chunk=user_chunk,
            chunks=-(-n_users // user_chunk),
        )
    return NeighborTable(out_idx, out_sim)


def _score_targets(
    nbr_idx: torch.Tensor,  # (R, K) int32 — neighbour rows of the user's RATED items
    nbr_sim: torch.Tensor,  # (R, K) f32 (0 = padding)
    rated_vals: torch.Tensor,  # (R,) f32 — the user's (centered) ratings (0-padded)
    rated_mask: torch.Tensor,  # (R,) bool — padding mask over rated items
    max_nbrs: int,
    min_nbrs: int,
    average: bool,
    n_items: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """
    Accumulate over rated items' neighbour rows, the reference direction
    (reference: src/accel/knn/item_score.rs:23): each rated item pushes its
    sim into every target of its row; per target the ``max_nbrs`` largest
    sims are reduced.  A dense (n_items, R) contribution matrix and a
    per-target top-k on the rows' device; padding slots (sim 0) land in a
    discarded row.
    """
    R, K = nbr_idx.shape
    dev = nbr_idx.device
    sim_ok = torch.where(rated_mask[:, None], nbr_sim, 0.0)
    r_ids = torch.arange(R, device=dev)[:, None]
    tgt = torch.where(sim_ok > 0, nbr_idx.long(), n_items)
    contrib = torch.zeros((n_items + 1) * R, dtype=nbr_sim.dtype, device=dev)
    contrib[tgt * R + r_ids] = sim_ok
    contrib = contrib.view(n_items + 1, R)[:n_items]
    top_sims, top_pos = torch.topk(contrib, min(max_nbrs, R), dim=1)
    valid = top_sims > 0
    counts = valid.sum(dim=1)
    weights = torch.where(valid, top_sims, 0.0)
    if average:
        num = (weights * rated_vals[top_pos]).sum(dim=1)
        scores = num / weights.abs().sum(dim=1).clamp_min(_SMALLEST_NORMAL)
    else:
        scores = weights.sum(dim=1)
    scores = torch.where(counts >= min_nbrs, scores, torch.nan)
    return scores, counts.to(torch.int32)


def _pad_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def score_users_bucket(
    cols: torch.Tensor,  # (B, P) int32 — user numbers who rated each item
    vals: torch.Tensor,  # (B, P) f32 — their (centered) ratings
    mask: torch.Tensor,  # (B, P) bool
    sims: torch.Tensor,  # (n_users,) f32 — query-to-user similarities (0 = ineligible)
    max_nbrs: int,
    min_nbrs: int,
    average: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """User-kNN per-item scoring for one popularity bucket
    (reference: src/accel/knn/user_score.rs:22,62): top-``max_nbrs`` eligible
    raters per item, similarity-weighted average of centered ratings."""
    w = torch.where(mask, sims[cols], 0.0)
    top_w, top_pos = torch.topk(w, min(max_nbrs, w.shape[1]), dim=1)
    valid = top_w > 0
    counts = valid.sum(dim=1)
    weights = torch.where(valid, top_w, 0.0)
    if average:
        num = (weights * torch.gather(vals, 1, top_pos)).sum(dim=1)
        scores = num / weights.abs().sum(dim=1).clamp_min(_SMALLEST_NORMAL)
    else:
        scores = weights.sum(dim=1)
    scores = torch.where(counts >= min_nbrs, scores, torch.nan)
    return scores, counts.to(torch.int32)


def sparse_matvec(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *, n_rows: int):
    """COO matvec ``y = A @ x`` by ``index_add_`` (the user similarities
    without densifying the user matrix)."""
    out = torch.zeros(n_rows, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, rows, vals * x[cols])


def _history(table: NeighborTable, rated_nums: np.ndarray):
    """The rated items' neighbour rows, padded to a power of two, and the
    padding mask, on the table's device."""
    R = len(rated_nums)
    Rp = _pad_pow2(max(R, 1))
    idx = np.zeros(Rp, dtype=np.int64)
    idx[:R] = rated_nums
    mask = np.zeros(Rp, dtype=bool)
    mask[:R] = True
    dev = table.indices.device
    idx_t = _host_tensor(idx, dev)
    return table.indices[idx_t], table.sims[idx_t], _host_tensor(mask, dev), Rp


def target_values(scores: torch.Tensor, counts: torch.Tensor, target_nums: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Scores and counts of the targets, read back in one transfer."""
    t = _host_tensor(np.asarray(target_nums, dtype=np.int64), scores.device)
    both = torch.stack((scores[t], counts[t].to(scores.dtype))).cpu().numpy()
    return both[0], both[1].astype(np.int32)


def score_items_explicit(
    table: NeighborTable,
    target_nums: np.ndarray,
    rated_nums: np.ndarray,
    rated_vals: np.ndarray,
    item_means: np.ndarray,
    max_nbrs: int,
    min_nbrs: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Explicit item-kNN scoring (reference: item_score.rs:23
    ``score_explicit`` + accum.rs averaging): weighted average of centered
    ratings over the top-``max_nbrs`` rated neighbours, re-offset by the
    item mean.  Scores every item on the table's device, then subsets to
    ``target_nums``."""
    nbr_idx, nbr_sim, mask, Rp = _history(table, rated_nums)
    vals = np.zeros(Rp, dtype=np.float32)
    vals[: len(rated_nums)] = rated_vals.astype(np.float32) - item_means[rated_nums]
    scores, counts = _score_targets(
        nbr_idx, nbr_sim, _host_tensor(vals, nbr_idx.device), mask, max_nbrs, min_nbrs, True, table.n_items
    )
    s, c = target_values(scores, counts, target_nums)
    return s + item_means[target_nums], c


def score_items_implicit(
    table: NeighborTable,
    target_nums: np.ndarray,
    rated_nums: np.ndarray,
    max_nbrs: int,
    min_nbrs: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Implicit item-kNN scoring (reference: item_score.rs:72): sum of the
    top neighbour similarities."""
    nbr_idx, nbr_sim, mask, Rp = _history(table, rated_nums)
    zeros = torch.zeros(Rp, dtype=torch.float32, device=nbr_idx.device)
    scores, counts = _score_targets(nbr_idx, nbr_sim, zeros, mask, max_nbrs, min_nbrs, False, table.n_items)
    return target_values(scores, counts, target_nums)
