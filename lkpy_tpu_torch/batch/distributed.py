"""
Multi-process batch inference.

Port of ``lkpy_tpu/batch/distributed.py`` (reference: src/lenskit/batch/
_ray.py — query batches shipped to Ray workers): the global query list is
split contiguously by process, each process serves its shard through
:func:`lkpy_tpu_torch.batch.device.device_recommend` (over the mesh's
``data`` slots), and the results gather on process 0.  The process group
is ``torch.distributed``'s (:func:`lkpy_tpu_torch.parallel.distributed.
init_distributed`, or one the caller started); the gather of the pickled
collections runs over gloo.  In one process the split is the identity and
the gather returns the local result.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from lkpy_tpu_torch.data import ItemListCollection
from lkpy_tpu_torch.logging import get_logger
from lkpy_tpu_torch.parallel.distributed import host_count, host_index, object_group

_log = get_logger(__name__)

__all__ = ["local_query_shard", "distributed_recommend", "gather_results"]


def local_query_shard(user_ids) -> np.ndarray:
    """This process's contiguous shard of the global query list
    (reference analog: batch/_ray.py query batching)."""
    user_ids = np.asarray(user_ids)
    p, n_proc = host_index(), host_count()
    bounds = np.linspace(0, len(user_ids), n_proc + 1).astype(int)
    return user_ids[bounds[p] : bounds[p + 1]]


def gather_results(ilc: ItemListCollection, key_fields) -> ItemListCollection | None:
    """Gather per-process result collections onto process 0.

    Returns the merged collection on process 0, None elsewhere.  Transport
    is ``all_gather_object`` of the collections (small: top-N IDs and
    scores per query) over a gloo group; unpickling reads only what the
    group's processes sent.
    """
    n_proc = host_count()
    if n_proc == 1:
        return ilc
    parts: list = [None] * n_proc
    dist.all_gather_object(parts, ilc, group=object_group())
    if host_index() != 0:
        return None
    merged = ItemListCollection(tuple(key_fields))
    for part in parts:
        for key, il in part.items():
            merged.add(il, *key)
    return merged


def distributed_recommend(
    scorer,
    user_ids,
    n: int,
    matrix,
    *,
    mesh=None,
    chunk: int = 1024,
) -> ItemListCollection | None:
    """
    Batch top-N recommendation across processes and the device mesh.

    Each process recommends for its :func:`local_query_shard` over ``mesh``
    (default: :func:`~lkpy_tpu_torch.parallel.mesh.get_mesh`, every card
    this process sees); results gather on process 0 (None is returned on
    the others).
    """
    from lkpy_tpu_torch.batch.device import device_recommend
    from lkpy_tpu_torch.parallel.mesh import get_mesh

    mesh = mesh or get_mesh()
    local = local_query_shard(user_ids)
    _log.debug("distributed recommend", local_queries=len(local))
    ilc = device_recommend(scorer, local, n, matrix, mesh=mesh, chunk=chunk)
    return gather_results(ilc, ("user_id",))
