"""
Sharding helpers and distributed primitives.

Port of ``lkpy_tpu/parallel/ops.py`` (SURVEY.md §2.3): row-sharded tables,
sharded query batches, and the top-k merge of sharded retrieval.  A placed
array is a :class:`Sharded`: one tensor a slot along the axis, on that
slot's device, with the global row offsets.  The JAX package's all-gather
merge is a move of each slot's top-k to the first slot and one
``torch.topk`` there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lkpy_tpu_torch.ops.topk import retrieval_topk
from lkpy_tpu_torch.parallel.mesh import Mesh, get_mesh

__all__ = ["Sharded", "shard_rows", "shard_batch", "shard_replicated", "sharded_topk", "sharded_matmul_topk"]


class Sharded(NamedTuple):
    """An array placed over a mesh: ``parts[s]`` lies on slot ``s``'s device
    and holds global rows ``offsets[s]:offsets[s + 1]`` (for a replicated
    array every part is the whole array and ``axis`` is None)."""

    parts: tuple[torch.Tensor, ...]
    offsets: tuple[int, ...]
    axis: str | None


def _split(arr: torch.Tensor, devs: list[torch.device], axis: str) -> Sharded:
    """Split the leading dim into ``len(devs)`` blocks of ``ceil(n / d)``
    rows (the last may be shorter or empty), one a slot."""
    n, d = arr.shape[0], len(devs)
    per = -(-n // d)
    offsets = tuple(min(s * per, n) for s in range(d + 1))
    parts = tuple(arr[offsets[s] : offsets[s + 1]].to(dev).contiguous() for s, dev in enumerate(devs))
    return Sharded(parts, offsets, axis)


def shard_rows(arr: torch.Tensor, mesh: Mesh | None = None, axis: str = "model") -> Sharded:
    """Place a table with its leading dim sharded over the given mesh axis
    (row-sharded factor/embedding tables)."""
    mesh = mesh or get_mesh()
    return _split(arr, mesh.axis_devices(axis), axis)


def shard_batch(arr: torch.Tensor, mesh: Mesh | None = None, axis: str = "data") -> Sharded:
    """Shard the leading (batch) dimension over the data axis."""
    return shard_rows(arr, mesh, axis)


def shard_replicated(arr: torch.Tensor, mesh: Mesh | None = None) -> Sharded:
    """A copy of ``arr`` on every distinct device of the mesh."""
    mesh = mesh or get_mesh()
    return Sharded(tuple(arr.to(dev) for dev in mesh.distinct_devices()), (0, arr.shape[0]), None)


def _merge(vals: list[torch.Tensor], idx: list[torch.Tensor], k: int, dev: torch.device):
    """Each slot's top-k (indices already global) moved to ``dev`` and
    merged into one top-k there."""
    all_vals = torch.cat([v.to(dev) for v in vals], dim=-1)
    all_idx = torch.cat([i.to(dev) for i in idx], dim=-1)
    top, pos = torch.topk(all_vals, min(k, all_vals.shape[-1]), dim=-1)
    return top, torch.take_along_dim(all_idx, pos, dim=-1)


def sharded_topk(scores: torch.Tensor, k: int, mesh: Mesh | None = None, axis: str = "model"):
    """
    Top-k over an item axis sharded across the mesh: the last dim of
    ``scores`` (..., n_items) splits into one column block a slot of
    ``axis``; each slot takes its block's top-k, its indices made global,
    and the blocks merge on the first slot (the sharded-retrieval
    collective, SURVEY.md §5 "sharded top-k retrieval").

    Returns (values, int64 indices) on the first slot's device.
    """
    mesh = mesh or get_mesh()
    cols = _split(scores.movedim(-1, 0), mesh.axis_devices(axis), axis)
    vals, idx = [], []
    for part, lo in zip(cols.parts, cols.offsets):
        if part.shape[0] == 0:
            continue
        v, i = torch.topk(part.movedim(0, -1), min(k, part.shape[0]), dim=-1)
        vals.append(v)
        idx.append(i + lo)
    return _merge(vals, idx, k, mesh.first)


def sharded_matmul_topk(queries: torch.Tensor, table: torch.Tensor | Sharded, k: int, mesh: Mesh | None = None):
    """
    Sharded retrieval: the top-k of ``queries @ tableᵀ`` with the table
    row-sharded over 'model' (a :class:`Sharded` from :func:`shard_rows`,
    or a tensor that is sharded here).

    Each ``model`` slot scores its row block and takes its local top-k
    through :func:`lkpy_tpu_torch.ops.topk.retrieval_topk` (on the card the
    fused MIPS top-k kernel wherever ``fused_route`` takes the block), its
    indices made global; the shards merge on the first slot.  Returns
    (values, int32 indices) there.
    """
    mesh = mesh or get_mesh()
    if not isinstance(table, Sharded):
        table = shard_rows(table, mesh, "model")
    vals, idx = [], []
    for part, lo in zip(table.parts, table.offsets):
        if part.shape[0] == 0:
            continue
        v, i = retrieval_topk(queries.to(part.device), part, min(k, part.shape[0]))
        vals.append(v)
        idx.append(i + lo)
    return _merge(vals, idx, k, mesh.first)
