"""
The item-item family's device work alone, on one NVIDIA GPU, at bench.py's
shape.

    python3 scripts/knn_probe.py

Makes ``chip_smoke.py``'s data (bench.py's synthetic interactions and split,
138,000 users x 27,000 items, seed 42) and bench.py's ``ui`` (confidence 40)
and ``iu``, then times on the card: ``normalize_item_matrix`` +
``similarity_topk(normed, 64, user_major=ui)`` twice (the first primes the
card), the same build at k = 512 and with bf16 Gram chunks
(``torch.mm(..., out_dtype=torch.float32)``), the binary co-occurrence Gram
and its float32 Cholesky factor (with the factor's smallest pivot), and
EASE's weights whole, with the peak device memory of each.  Checks nothing;
``chip_smoke.py`` holds the results.  Prints the card's name and power limit
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


def timed(label: str, fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    cs.log(f"{label}: {time.perf_counter() - t:.4f}s, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("knn_probe: no CUDA device", file=sys.stderr)
        return 1
    from lkpy_tpu_torch.data.matrix import CSR
    from lkpy_tpu_torch.models.ease import _ease_weights
    from lkpy_tpu_torch.ops import knn

    card = cs.card_line()
    cs.log(card)
    cs.log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(42)
    users, items = cs.synth_interactions(rng)
    mask, _, _ = cs.split_holdout(users, items, rng)
    ui = CSR.from_coo(users[mask], items[mask], np.full(int(mask.sum()), 40.0, np.float32), (cs.N_USERS, cs.N_ITEMS))
    iu = ui.transpose()
    for label, k, kw in [("build 1", 64, {}), ("build 2", 64, {}), ("k=512", 512, {}), ("bf16 Gram chunks", 64, {"bf16": True})]:
        tm: dict = {}
        timed(f"{label}: normalize + similarity_topk", lambda: knn.similarity_topk(knn.normalize_item_matrix(iu, explicit=False)[0], k, user_major=ui, timings=tm, **kw))
        cs.log(f"  {tm}")
    gram = timed("co-occurrence Gram", lambda: knn.cooccurrence_gram(ui))
    cs.log(f"  largest diagonal entry {float(gram.diagonal().max())}")
    gram.diagonal().add_(1.0)
    chol = timed("float32 Cholesky of G + I", lambda: torch.linalg.cholesky(gram))
    cs.log(f"  smallest pivot {float(chol.diagonal().min())}")
    del gram, chol
    torch.cuda.empty_cache()
    w = timed("EASE weights (Gram, Cholesky, solve)", lambda: _ease_weights(ui, 1.0, torch.device("cuda")))
    cs.log(f"  largest |weight| {float(w.abs().max())}, finite {bool(torch.isfinite(w).all())}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
