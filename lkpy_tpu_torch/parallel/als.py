"""
Sharded ALS training.

Port of ``lkpy_tpu/parallel/als.py`` (reference parallelism: rayon par_iter
over rows, src/accel/als/explicit.rs:62): each chunk's rows split over the
mesh's ``data`` slots, each slot solves its slab's normal equations on its
device (the gather-and-Gram kernel and the training solve), and the
solutions reach every device's copy of the table.  The kernels of
:mod:`lkpy_tpu_torch.ops.als` take the mesh themselves (``als_epoch(...,
mesh=...)``), and :class:`~lkpy_tpu_torch.models.als.ALSTrainerBase`
drives them through ``TrainingOptions.mesh``; this module keeps the
standalone sharded half-epoch entry point.
"""

from __future__ import annotations

import torch

from lkpy_tpu_torch.ops.als import als_half_epoch
from lkpy_tpu_torch.ops.sparse import PaddedRowMatrix
from lkpy_tpu_torch.parallel.mesh import Mesh, get_mesh

__all__ = ["sharded_half_epoch"]


def sharded_half_epoch(
    buckets: list[PaddedRowMatrix],
    left: torch.Tensor,
    right: torch.Tensor,
    reg: float,
    *,
    mode: str,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """One sharded ALS half-epoch: each ``data`` slot solves its slab of
    every chunk.  Returns the updated ``left`` on the mesh's first slot."""
    mesh = mesh or get_mesh()
    left, _delta = als_half_epoch(buckets, left.to(mesh.first), right.to(mesh.first), reg, mode=mode, mesh=mesh)
    return left
