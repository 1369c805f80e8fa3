"""
Sharding for the gradient-family trainers (FlexMF, LightGCN).

Port of ``lkpy_tpu/parallel/gradient.py`` (SURVEY.md §2.3, BASELINE north
star): the embedding and bias tables row-sharded over the mesh's ``model``
slots, each batch split over its ``data`` slots.  The JAX package leaves
the moves to GSPMD inside one jitted step; here each one is explicit:

- a table is a :class:`~lkpy_tpu_torch.parallel.ops.Sharded` of per-slot
  leaf tensors (``requires_grad``) in ⌈n/m⌉-row blocks, as the other sharded
  paths split their arrays (:mod:`lkpy_tpu_torch.parallel.ops`), with
  no padding rows (:func:`place_tree`);
- a data slot gathers only the rows its block touches from the ``model``
  shards (:func:`take_rows`), and autograd carries the gradients back to
  the shard leaves across the ``.to()`` moves;
- each data slot's loss is its part of the batch's loss (sums over its
  block divided by the global batch size), and the parts are summed on the
  mesh's first slot for one backward pass (:func:`sharded_step_loss`).

The JAX package's ``jit_sharded_step`` and ``jit_sharded_epoch`` wrap a
step and a scanned epoch in ``jax.jit`` with pinned shardings.  Eager
PyTorch has no program to pin: their counterparts are
:func:`sharded_step_loss` and the trainers' ``train_epoch``, a Python loop
of steps, each one backward pass and one optimizer step over every shard
leaf.  ``epoch_batch_sharding`` has no counterpart either: the negatives
are drawn on the first slot each step, so each step's rows are split
there (:func:`batch_sharding`).
"""

from __future__ import annotations

from typing import Callable

import torch

from lkpy_tpu_torch.parallel.mesh import Mesh
from lkpy_tpu_torch.parallel.ops import Sharded

__all__ = [
    "batch_sharding",
    "leaf_sharding",
    "leaves",
    "place_tree",
    "sharded_step_loss",
    "table_rows",
    "take_rows",
    "whole",
]


def table_rows(n: int, mesh: Mesh | None) -> int:
    """The JAX package's row count of a table over ``mesh``: ``n`` rounded
    up to a multiple of the ``model`` slots.  The port pads nothing: it is
    ``model`` times the rows of a full shard (:func:`place_tree`)."""
    if mesh is None:
        return n
    m = mesh.shape["model"]
    return -(-n // m) * m


def leaf_sharding(mesh: Mesh, leaf: torch.Tensor, sharded_rows: set[int]) -> str | None:
    """The axis a leaf is row-sharded over: ``"model"`` for a table whose
    leading dim is a table size, None (whole, on the first slot) for
    anything else, such as a scalar."""
    if leaf.dim() >= 1 and leaf.shape[0] in sharded_rows:
        return "model"
    return None


def _leaf(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.detach().to(device, torch.float32).clone().requires_grad_()


def place_tree(mesh: Mesh | None, tree: dict, sharded_rows: set[int], device: torch.device | None = None) -> dict:
    """Place every leaf of a parameter dict as a trainable leaf: a table
    (see :func:`leaf_sharding`) as a :class:`Sharded` of ⌈n/m⌉-row blocks,
    one on each ``model`` slot, anything else whole on the first slot.
    Without a mesh every leaf goes whole to ``device``."""
    if mesh is None:
        return {k: _leaf(v, device) for k, v in tree.items()}
    out = {}
    for k, v in tree.items():
        if leaf_sharding(mesh, v, sharded_rows) is None:
            out[k] = _leaf(v, mesh.first)
            continue
        devs = mesh.axis_devices("model")
        n = v.shape[0]
        per = table_rows(n, mesh) // len(devs)
        offsets = tuple(min(s * per, n) for s in range(len(devs) + 1))
        parts = tuple(_leaf(v[offsets[s] : offsets[s + 1]], dev) for s, dev in enumerate(devs))
        out[k] = Sharded(parts, offsets, "model")
    return out


def leaves(tree: dict) -> list[torch.Tensor]:
    """The trainable tensors of a placed dict (empty shards left out)."""
    out = []
    for v in tree.values():
        if isinstance(v, Sharded):
            out.extend(p for p in v.parts if p.shape[0])
        else:
            out.append(v)
    return out


def whole(table: torch.Tensor | Sharded, device: torch.device) -> torch.Tensor:
    """The whole table on ``device``: a sharded one's blocks moved there
    and joined by one (differentiable) ``torch.cat``."""
    if isinstance(table, torch.Tensor):
        return table.to(device)
    return torch.cat([p.to(device) for p in table.parts])


def take_rows(table: torch.Tensor | Sharded, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` on ``idx``'s device, differentiable in the table.

    A sharded table gives each shard's rows without a host synchronization:
    each shard gathers at every index wrapped into its block and the rows
    outside it are masked to zero, so the gathers move ``idx``'s rows only,
    never a whole table, and exactly one shard contributes each row.  The
    wrap (not a clamp) keeps the masked indices as spread over the block as
    the real ones: the index backward serializes repeated indices, and a
    clamp would send every row outside the block to one of its ends."""
    if isinstance(table, torch.Tensor):
        return table[idx.to(table.device)].to(idx.device)
    dev = idx.device
    out = None
    for part, lo, hi in zip(table.parts, table.offsets, table.offsets[1:]):
        if hi == lo:
            continue
        loc = idx.to(part.device) - lo
        if len(table.parts) == 1:
            return part[loc].to(dev)
        rows = part[loc.remainder(hi - lo)].to(dev)
        hit = ((idx >= lo) & (idx < hi)).view(*idx.shape, *([1] * (part.dim() - 1)))
        rows = torch.where(hit, rows, 0.0)
        out = rows if out is None else out + rows
    return out


def batch_sharding(mesh: Mesh, *cols: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
    """Split a step's columns (leading dim the batch) into contiguous
    blocks, one for each ``data`` slot, each moved to its slot."""
    devs = mesh.axis_devices("data")
    n = cols[0].shape[0]
    per = -(-n // len(devs))
    return [tuple(c[s * per : (s + 1) * per].to(dev) for c in cols) for s, dev in enumerate(devs)]


def sharded_step_loss(mesh: Mesh, block_loss: Callable[..., torch.Tensor], cols: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """One step's loss over the mesh: ``block_loss(*block)`` on each ``data``
    slot's block of ``cols`` (its part of the batch's loss), the parts
    summed on the first slot, where one ``backward`` reaches every shard."""
    parts = [block_loss(*block) for block in batch_sharding(mesh, *cols)]
    return torch.stack([p.to(mesh.first) for p in parts]).sum()
