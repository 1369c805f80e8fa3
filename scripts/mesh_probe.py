"""
``chip_smoke.py``'s mesh phase alone on one NVIDIA GPU.

    python3 scripts/mesh_probe.py

Builds the kernels (one ``nvcc`` per source, together), makes
``chip_smoke.py``'s data (bench.py's synthetic interactions and split,
138,000 users x 27,000 items, seed 42), trains the unsharded
``ImplicitMFScorer(features=64, epochs=10)`` it is held against, times its
epochs, builds the unsharded item-kNN table (k = 64), runs ``gradient_phase``
(whose first FlexMF-BPR and LightGCN epochs the mesh's are held against) and
then ``mesh_phase``: ALS training and fold-in serving at ``data = 2``,
retrieval and the kNN build at ``model = 2``, FlexMF-BPR at ``data = 2`` and
LightGCN at ``model = 2``, two processes of ``distributed_recommend`` over
gloo, and ``dryrun_multichip(8)``, with every check of that phase.  The
unsharded tables stand in for the pipeline phase's.  Prints the card's name
and power limit first and last.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 1
    import pandas as pd

    from lkpy_tpu_torch.batch.device import device_recommend
    from lkpy_tpu_torch.data import from_interactions_df
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.ops import _build
    from lkpy_tpu_torch.ops.knn import normalize_item_matrix, similarity_topk
    from lkpy_tpu_torch.training import TrainingOptions

    card = cs.card_line()
    cs.log(card)
    cs.log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t = time.perf_counter()
    with ThreadPoolExecutor(len(_build.sources())) as pool:
        list(pool.map(_build.load, _build.sources()))
    cs.log(f"build: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    rng = np.random.default_rng(42)
    users, items = cs.synth_interactions(rng)
    mask, test_u, test_i = cs.split_holdout(users, items, rng)
    ds = from_interactions_df(pd.DataFrame({"user_id": users[mask], "item_id": items[mask]}))
    cs.log(f"bench.py's split: {mask.sum()} training, {len(test_u)} held-out interactions ({time.perf_counter() - t:.1f}s)")
    t = time.perf_counter()
    scorer = ImplicitMFScorer(features=cs.FEATURES, epochs=cs.EPOCHS, user_embeddings="prefer")
    scorer.train(ds, TrainingOptions(rng=42))
    trainer = scorer.create_trainer(ds, TrainingOptions(rng=42))
    times = []
    for _ in range(4):
        ts = time.perf_counter()
        float(trainer.train_epoch())
        times.append(time.perf_counter() - ts)
    test_users = np.unique(test_u)
    recs = device_recommend(scorer, test_users, 10, ds.interaction_matrix())
    nd = cs.ndcg10(test_users, [list(recs.lookup(u).ids()) for u in test_users], test_u, test_i)
    folding = ImplicitMFScorer(features=cs.FEATURES, epochs=cs.EPOCHS, weight=40.0, regularization=0.1, user_embeddings=True)
    folding.load_parameters(scorer.get_parameters())
    folding._OtOr, folding.users, folding.items = scorer._OtOr, scorer.users, scorer.items
    iu = ds.interaction_matrix().csr(None).transpose()
    normed, _ = normalize_item_matrix(iu.with_values(np.ones(iu.nnz, dtype=np.float32)), explicit=False)
    table = similarity_topk(normed, cs.KNN_K)
    cs.log(f"unsharded: training, epochs {[round(x * 1e3, 3) for x in times]} ms, NDCG@10 {nd:.4f}, kNN table ({time.perf_counter() - t:.1f}s)")
    split = dict(ds=ds, scorer=scorer, test_u=test_u, test_i=test_i, ndcg=nd, epoch_ms=float(np.mean(times[1:])) * 1e3,
                 knn_table=table, pipeline_scorer=folding)  # fmt: skip
    t = time.perf_counter()
    cs.gradient_phase(dev, split)
    cs.log(f"phase gradient: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths = cs.mesh_phase(dev, split)
    cs.log(f"phase mesh: {time.perf_counter() - t:.1f}s")
    cs.log(f"launches by path: {paths}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
