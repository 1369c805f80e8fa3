"""
Distribution: device meshes, sharded training, distributed inference.

Port of ``lkpy_tpu/parallel`` (reference: SURVEY.md §2.3 — rayon pools
src/accel/parallel.rs, Ray batch fan-out src/lenskit/batch/_ray.py, ZMQ
log relay):

- intra-op row parallelism → a :class:`~lkpy_tpu_torch.parallel.mesh.Mesh`
  of device slots in one process: ALS chunks split over its ``data`` slots,
  similarity rows and retrieval tables over its ``model`` slots, every move
  between slots an explicit ``.to(device)``;
- batch-inference fan-out → query blocks split over the ``data`` slots;
- multi-process coordination → a gloo ``torch.distributed`` group for the
  query split and the gather of results, and the log relay of
  :mod:`lkpy_tpu_torch.logging.multiprocess`.
"""

from lkpy_tpu_torch.parallel.distributed import (
    host_count,
    host_index,
    init_distributed,
    is_coordinator,
    local_device_count,
)
from lkpy_tpu_torch.parallel.mesh import MeshSpec, get_mesh, make_mesh
from lkpy_tpu_torch.parallel.ops import (
    shard_batch,
    shard_replicated,
    shard_rows,
    sharded_topk,
)

__all__ = [
    "MeshSpec",
    "host_count",
    "host_index",
    "init_distributed",
    "is_coordinator",
    "local_device_count",
    "get_mesh",
    "make_mesh",
    "shard_batch",
    "shard_replicated",
    "shard_rows",
    "sharded_topk",
]
