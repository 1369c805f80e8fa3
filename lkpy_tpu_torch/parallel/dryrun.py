"""
Multi-slot dry run of the port's sharded paths.

Counterpart of ``__graft_entry__.py:44`` ``dryrun_multichip`` on its
synthetic set (512 users × 1,024 items from 60,000 skewed draws, seed 0):
implicit ALS trained sharded against single-device, the item-kNN build
sharded against single-device, batch inference over the mesh and across
the (single) process, FlexMF-BPR trained sharded against single-device, a
sharded LightGCN epoch, and sharded retrieval.  Each check raises on a
mismatch.

    python -m lkpy_tpu_torch.parallel.dryrun [n_devices] [device]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lkpy_tpu_torch._device import resolve_device

__all__ = ["dryrun_multichip"]


def _dataset():
    import pandas as pd

    from lkpy_tpu_torch.data import from_interactions_df

    # moderately ragged: zipf-ish item popularity and lognormal user
    # activity, so the ALS bucketing spans several widths and chunks
    rng = np.random.default_rng(0)
    n_users, n_items, n_draw = 512, 1024, 60_000
    u_w = rng.lognormal(0.0, 1.0, n_users)
    i_w = 1.0 / np.arange(1, n_items + 1) ** 0.8
    df = pd.DataFrame(
        {
            "user_id": rng.choice(n_users, n_draw, p=u_w / u_w.sum()),
            "item_id": rng.choice(n_items, n_draw, p=i_w / i_w.sum()),
            "rating": rng.integers(1, 6, n_draw).astype(np.float32),
        }
    ).drop_duplicates(["user_id", "item_id"])
    if len(df) < 30_000:
        raise AssertionError(f"the dry run's set is too small ({len(df)} interactions)")
    return from_interactions_df(df), rng


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> str:
    """Run the sharded paths on an ``n_devices``-slot ``(data, model)`` mesh
    (model = 2 from two slots) against their single-device runs.  The slots
    are distinct cards where ``device`` is the card (the default) and that
    many are visible, else ``n_devices`` slots of ``device``.  Returns the
    summary line."""
    from lkpy_tpu_torch import batch, topn_pipeline
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.models.flexmf import FlexMFImplicitScorer
    from lkpy_tpu_torch.models.knn import ItemKNNScorer
    from lkpy_tpu_torch.models.lightgcn import LightGCNScorer
    from lkpy_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from lkpy_tpu_torch.parallel.ops import shard_rows, sharded_matmul_topk
    from lkpy_tpu_torch.training import TrainingOptions

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= n_devices:
        devs = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devs = [dev] * n_devices
    model = 2 if n_devices >= 2 else 1
    mesh = make_mesh(MeshSpec(data=n_devices // model, model=model), devices=devs)
    ds, rng = _dataset()

    # implicit ALS: sharded epochs against single-device, from the same seed
    cfg = {"features": 16, "epochs": 2}
    single = ImplicitMFScorer(ImplicitMFScorer.validate_config(cfg))
    single.train(ds, TrainingOptions(rng=42, device=mesh.first))
    sharded = ImplicitMFScorer(ImplicitMFScorer.validate_config(cfg))
    sharded.train(ds, TrainingOptions(rng=42, mesh=mesh))
    torch.testing.assert_close(sharded.item_embeddings, single.item_embeddings, atol=1e-4, rtol=1e-4)

    # the item-kNN similarity build: sharded against single-device
    kcfg = ItemKNNScorer.validate_config({"feedback": "implicit", "save_nbrs": 8})
    knn_single = ItemKNNScorer(kcfg)
    knn_single.train(ds, TrainingOptions(rng=42, device=mesh.first))
    knn_sharded = ItemKNNScorer(kcfg)
    knn_sharded.train(ds, TrainingOptions(rng=42, mesh=mesh))
    torch.testing.assert_close(knn_sharded.sim_table.sims, knn_single.sim_table.sims, atol=1e-5, rtol=0)

    # batch inference over the mesh, through the distributed route
    pipe = topn_pipeline(single, n=10)
    pipe.train(ds, TrainingOptions(retrain=False, device=mesh.first))  # the scorer is already trained
    some_users = ds.users.ids[:32]
    plain = batch.recommend(pipe, some_users, n=10)
    dist = batch.recommend(pipe, some_users, n=10, mesh=mesh, distributed=True)
    if len(dist) != len(plain):
        raise AssertionError(f"distributed recommend gave {len(dist)} lists, not {len(plain)}")
    for (k1, il1), (k2, il2) in zip(plain.items(), dist.items()):
        if k1 != k2 or list(il1.ids()) != list(il2.ids()):
            raise AssertionError(f"user {k1}: distributed lists differ from the single-device lists")

    # the gradient family: FlexMF-BPR with row-sharded tables and
    # data-split batches against single-device, from the same seed
    fcfg = FlexMFImplicitScorer.validate_config({"features": 32, "epochs": 1, "loss": "pairwise", "batch_size": 8192})
    fm_single = FlexMFImplicitScorer(fcfg)
    fm_single.train(ds, TrainingOptions(rng=7, device=mesh.first))
    fm_sharded = FlexMFImplicitScorer(fcfg)
    fm_sharded.train(ds, TrainingOptions(rng=7, mesh=mesh))
    torch.testing.assert_close(fm_sharded.params["i_embed"], fm_single.params["i_embed"], atol=5e-4, rtol=5e-4)

    # LightGCN: the propagation over the tables gathered from their shards
    lcfg = LightGCNScorer.validate_config({"embedding_size": 16, "epochs": 1, "batch_size": 4096, "layer_count": 1})
    lgcn = LightGCNScorer(lcfg)
    lgcn.train(ds, TrainingOptions(rng=3, mesh=mesh))
    if not bool(torch.isfinite(lgcn.item_embeddings).all()):
        raise AssertionError("the sharded LightGCN epoch gave non-finite item embeddings")

    # sharded retrieval: a row-sharded item table and the top-k merge
    queries = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)).to(mesh.first)
    table = shard_rows(single.item_embeddings, mesh)
    vals, idx = sharded_matmul_topk(queries, table, 10, mesh)
    want = torch.topk(queries @ single.item_embeddings.T, 10, dim=1).values
    if vals.shape != (8, 10):
        raise AssertionError(f"sharded retrieval gave shape {tuple(vals.shape)}")
    torch.testing.assert_close(vals, want, atol=1e-5, rtol=1e-5)
    line = (
        f"dryrun_multichip({n_devices}, {mesh.shape} on {sorted({str(d) for d in devs})}): sharded ALS epoch == "
        "single-device, sharded kNN build == single-device, distributed recommend == single-device, "
        "sharded FlexMF-BPR == single-device, sharded LightGCN step ok, topk ok"
    )
    print(line)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8, sys.argv[2] if len(sys.argv) > 2 else None)
