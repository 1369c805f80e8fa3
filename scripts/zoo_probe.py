"""
``chip_smoke.py``'s zoo phase alone on one NVIDIA GPU.

    python3 scripts/zoo_probe.py

Makes ``chip_smoke.py``'s data (bench.py's synthetic interactions and split,
138,000 users x 27,000 items, seed 42, and bench.py's synthetic ratings over
the split) and runs its ``zoo_phase``: FunkSVD with a float64 replay of its
first batches and a profiled epoch, FA*IR over FunkSVD lists, BiasedSVD and
NMF over the dense matrix on the card, SLIM with its first block timed
alone, association rules, with every check of that phase.  The row gather's
kernel builds at its first launch.  Prints the card's name and power limit
first and last.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("zoo_probe: no CUDA device", file=sys.stderr)
        return 1
    import pandas as pd

    from lkpy_tpu_torch.data import from_interactions_df

    card = cs.card_line()
    cs.log(card)
    cs.log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    rng = np.random.default_rng(42)
    users, items = cs.synth_interactions(rng)
    mask, test_u, test_i = cs.split_holdout(users, items, rng)
    tr_u, tr_i = users[mask], items[mask]
    true_r = cs.explicit_ratings(rng, cs.N_USERS, cs.N_ITEMS)
    ratings, test_r = true_r(tr_u, tr_i), true_r(test_u, test_i)
    ds = from_interactions_df(pd.DataFrame({"user_id": tr_u, "item_id": tr_i}))
    eds = from_interactions_df(pd.DataFrame({"user_id": tr_u, "item_id": tr_i, "rating": ratings}))
    cs.log(f"bench.py's split and ratings: {len(tr_u)} training, {len(test_u)} held-out interactions ({time.perf_counter() - t:.1f}s)")
    split = dict(ds=ds, tr_u=tr_u, tr_i=tr_i, test_u=test_u, test_i=test_i, explicit_ds=eds, ratings=ratings, test_r=test_r)
    t = time.perf_counter()
    paths = cs.zoo_phase(torch.device("cuda"), split)
    cs.log(f"zoo phase: {time.perf_counter() - t:.1f}s")
    cs.log(f"launches by path: {paths}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
