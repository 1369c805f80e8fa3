"""
Sharded item-item similarity build.

Port of ``lkpy_tpu/parallel/knn.py`` (reference: the rayon streaming CSR
row sweep of src/accel/knn/item_train.rs:95): the rows of the similarity
matrix S shard over the mesh's ``model`` slots.  For every dense user chunk
U (scattered on each device from the user-major entries, which are
uploaded once a device), a slot adds ``U[:, its rows]ᵀ @ U`` to its block of
S.  Because sharding is by output row, each slot's threshold + top-k is
already global for its rows: no merge is needed, only a move of each
slot's rows of the table to the first slot.

The dense item × user matrix is never made: only (user_chunk, n_items)
chunks, sized by ``max_dense_bytes`` as the single-device build sizes them
(4 GiB by default where the JAX package's sharded build takes 1 GiB, so
the two builds sum the same user chunks).  Two accumulation modes:

- **dense**: each slot holds its whole (rows a slot, n_items) block of S,
  one threshold + top-k at the end; taken when that block fits
  ``sim_block_bytes``;
- **streaming** (the reference's truncation discipline, item_train.rs:95):
  S exists only one (sub_rows, n_items) row block at a time a slot; each
  block is accumulated over all user chunks, then thresholded, cut to its
  top-k and dropped, so no n_items² tensor exists at any point.

Both take the single-device build's ``bf16`` chunks (float32 sums) but
default to float32, as the JAX package does on its sharded path.
"""

from __future__ import annotations

import numpy as np
import torch

from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.ops.knn import (
    _SMALLEST_NORMAL,
    NeighborTable,
    _accumulate,
    _block_topk,
    _host_tensor,
    _user_chunk,
    _user_major,
)
from lkpy_tpu_torch.parallel.mesh import Mesh, get_mesh

__all__ = ["sharded_similarity_topk"]


class _Chunks:
    """The user-major entries of the normalized matrix on each device, and
    one dense (user_chunk, n_items) buffer a device, refilled per chunk."""

    def __init__(self, iu_csr: CSR, devices: list[torch.device], user_chunk: int, dtype: torch.dtype):
        self.n_items, self.n_users = iu_csr.shape
        self.user_chunk = user_chunk
        vals = iu_csr.values if iu_csr.values is not None else np.ones(iu_csr.nnz, dtype=np.float32)
        self.entries = {}
        for dev in devices:
            rowptr, users, items, perm = _user_major(iu_csr, None, dev)
            self.rowptr = rowptr
            um_vals = _host_tensor(vals, dev).float()[perm].to(dtype)
            buf = torch.empty((user_chunk, self.n_items), dtype=dtype, device=dev)
            self.entries[dev] = (users, items, um_vals, buf)

    def starts(self) -> range:
        return range(0, self.n_users, self.user_chunk)

    def dense(self, dev: torch.device, ulo: int) -> torch.Tensor:
        """Users ``ulo:ulo + user_chunk`` as a dense chunk on ``dev``
        (zero rows past the last user)."""
        users, items, vals, buf = self.entries[dev]
        s, e = int(self.rowptr[ulo]), int(self.rowptr[min(ulo + self.user_chunk, self.n_users)])
        buf.zero_()
        buf.view(-1)[(users[s:e] - ulo) * self.n_items + items[s:e]] = vals[s:e]
        return buf


def sharded_similarity_topk(
    iu_csr: CSR,
    k: int,
    min_sim: float = 1.0e-6,
    *,
    mesh: Mesh | None = None,
    axis: str = "model",
    max_dense_bytes: int = 4 << 30,
    sim_block_bytes: int = 1 << 30,
    bf16: bool | None = None,
) -> NeighborTable:
    """
    Top-K thresholded cosine similarity with the rows of S sharded over
    ``axis``; the table lies on the mesh's first slot.

    ``iu_csr`` must already be normalized (items × users).  Matches
    :func:`lkpy_tpu_torch.ops.knn.similarity_topk` (default float32 chunks;
    ``bf16=True`` is an explicit opt-in, as no recall check guards the
    sharded build).  ``max_dense_bytes`` bounds each device's dense user
    chunk; ``sim_block_bytes`` bounds each slot's resident block of S: when
    a slot's whole (rows a slot, n_items) share exceeds it, the build
    streams row blocks (accumulate → truncate → discard).
    """
    mesh = mesh or get_mesh()
    slots = mesh.axis_devices(axis)
    d = len(slots)
    n_items, n_users = iu_csr.shape
    k = min(k, max(n_items - 1, 1))
    min_sim = max(float(min_sim), _SMALLEST_NORMAL)
    dtype = torch.bfloat16 if bf16 else torch.float32

    # the single-device build's user chunks; the JAX package's rows a slot,
    # over the catalog padded to d
    user_chunk = _user_chunk(n_users, n_items, max_dense_bytes, 2 if bf16 else 4)
    chunks = _Chunks(iu_csr, list(dict.fromkeys(slots)), user_chunk, dtype)
    rows_needed = -(-n_items // d)
    Np = rows_needed * d

    if rows_needed * Np * 4 <= sim_block_bytes:
        sub, n_blocks = rows_needed, 1  # dense: one block holds a slot's rows
    else:
        sub = min(int(max(sim_block_bytes // (Np * 4), 8)), rows_needed)
        n_blocks = -(-rows_needed // sub)
    rows_per = n_blocks * sub

    out_idx = torch.zeros((n_items, k), dtype=torch.int32, device=mesh.first)
    out_sim = torch.zeros((n_items, k), dtype=torch.float32, device=mesh.first)
    for b in range(n_blocks):
        # slot s owns rows s·rows_per + b·sub .. + sub of S in this block
        spans = [(s * rows_per + b * sub, min(s * rows_per + (b + 1) * sub, n_items)) for s in range(d)]
        blocks = [
            torch.zeros((max(hi - lo, 0), n_items), dtype=torch.float32, device=dev)
            for (lo, hi), dev in zip(spans, slots)
        ]
        for ulo in chunks.starts():
            dense = {}
            for (lo, hi), dev, S in zip(spans, slots, blocks):
                if hi <= lo:
                    continue
                if dev not in dense:
                    dense[dev] = chunks.dense(dev, ulo)
                U = dense[dev]
                _accumulate(S, U[:, lo:hi], U)
        for (lo, hi), S in zip(spans, blocks):
            if hi <= lo:
                continue
            sims, idx = _block_topk(S, lo, min_sim, k)
            out_sim[lo:hi] = sims.to(mesh.first)
            out_idx[lo:hi] = idx.to(mesh.first)
        del blocks
    return NeighborTable(out_idx, out_sim)
