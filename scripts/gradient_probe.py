"""
bench.py's section 6, the gradient family, alone on one NVIDIA GPU.

    python3 scripts/gradient_probe.py

Makes ``chip_smoke.py``'s data (bench.py's synthetic interactions and split,
138,000 users x 27,000 items, seed 42) and runs its ``gradient_phase``:
FlexMF-BPR (k = 64, batch 32,768, 5 epochs, NDCG@10 against the popularity
ranking, a profiled epoch, the host Bloom build timed alone), LightGCN (2
epochs, a profile of 5 steps, one propagation against float64, the CSR, the
dense bf16 and ``torch.sparse.mm``'s own backward routes timed) and the
WARP pipeline, with every check of that phase (``chip_smoke.PROFILES`` on).
LightGCN's propagation builds and launches the SpMM (``csrc/spmm.cu``),
each direction timed beside its bound; the other paths launch no kernel.
Prints the card's name and power limit first and last.
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
        print("gradient_probe: no CUDA device", file=sys.stderr)
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
    ds = from_interactions_df(pd.DataFrame({"user_id": users[mask], "item_id": items[mask]}))
    cs.log(f"bench.py's split: {int(mask.sum())} training, {len(test_u)} held-out interactions ({time.perf_counter() - t:.1f}s)")
    split = dict(ds=ds, tr_u=users[mask], tr_i=items[mask], test_u=test_u, test_i=test_i)
    cs.PROFILES = True
    paths = cs.gradient_phase(torch.device("cuda"), split)
    cs.log(f"launches by path: {paths}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
