"""
Where the per-query runner of ``quick_measure_model`` spends its time, on
one NVIDIA GPU.

    python3 scripts/runner_breakdown.py

Makes ``chip_smoke.py``'s data (bench.py's synthetic interactions, 138,000
users x 27,000 items, seed 42), splits 5 % of the users as the port's
``quick_measure_model(..., user_frac=0.05, rng=42)`` does, and trains
``topn_pipeline(ImplicitMFScorer(features=64, epochs=10), n=20)`` on the
card.  Then ``BatchPipelineRunner().recommend(n=20)`` runs over the first
``QUERIES`` test lists with host-clock wrappers on the history lookup, the
candidate set, the scorer's fold-in (the history rows' gather and the solve,
launched on the card), the rest of the scorer (the candidates' row gather,
the product and the scores' readback) and the ranker; the rest is the
pipeline's and the runner's own Python.  Last, ``torch.profiler`` over
``PROFILED`` queries gives the card's busy time and idle share.  Prints the
card's name and power limit first and last.
"""

from __future__ import annotations

import functools
import sys
import time
from pathlib import Path

import numpy as np
import pandas as pd
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

#: queries of the host-clock breakdown, and of the profile on the card
QUERIES = 500
PROFILED = 50


def breakdown(pipe, test, n: int) -> None:
    from lkpy_tpu_torch.batch import BatchPipelineRunner
    from lkpy_tpu_torch.data import ItemListCollection
    from lkpy_tpu_torch.models import als, basic

    lists = list(test.items())
    some = ItemListCollection.from_dict({k.user_id: il for k, il in lists[:QUERIES]}, "user_id")
    few = ItemListCollection.from_dict({k.user_id: il for k, il in lists[:PROFILED]}, "user_id")
    runner = BatchPipelineRunner(progress=False)
    runner.recommend(n=n)
    runner.run(pipe, few)  # warm
    spent = dict.fromkeys(["history lookup", "candidate set", "fold-in", "scorer", "ranker"], 0.0)
    saved = []

    def clocked(owner, name, key):
        had = name in owner.__dict__
        orig = getattr(owner, name)
        saved.append((owner, name, orig, had))

        @functools.wraps(orig)  # the pipeline reads a component's inputs from its signature
        def f(*a, **kw):
            t = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t

        setattr(owner, name, f)

    clocked(basic.UserTrainingHistoryLookup, "__call__", "history lookup")
    clocked(basic.TrainingItemsCandidateSelector, "__call__", "candidate set")
    clocked(type(pipe.node("scorer").component), "new_user_embedding", "fold-in")
    clocked(als.ALSBase, "__call__", "scorer")
    clocked(basic.TopNRanker, "__call__", "ranker")
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner.run(pipe, some)
        total = time.perf_counter() - t
    finally:
        for owner, name, orig, had in reversed(saved):
            if had:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
    spent["scorer"] -= spent["fold-in"]
    spent["pipeline and runner"] = total - sum(spent.values())
    q = len(some)
    cs.log(
        f"runner breakdown over {q} queries ({total * 1e3 / q:.3f} ms a query, host clock): "
        + ", ".join(f"{k} {v * 1e3 / q:.3f} ms ({v / total:.3f})" for k, v in spent.items())
    )
    t = time.perf_counter()
    runner.run(pipe, few)
    wall_ms = (time.perf_counter() - t) * 1e3
    cs.profile_device(lambda: runner.run(pipe, few), wall_ms, f"the runner over {len(few)} queries")


def main() -> int:
    if not torch.cuda.is_available():
        print("runner_breakdown: no CUDA device", file=sys.stderr)
        return 1
    from lkpy_tpu_torch.data import from_interactions_df
    from lkpy_tpu_torch.models.als import ImplicitMFScorer
    from lkpy_tpu_torch.pipeline import topn_pipeline
    from lkpy_tpu_torch.splitting import SampleFrac, sample_users
    from lkpy_tpu_torch.training import TrainingOptions

    card = cs.card_line()
    cs.log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    users, items = cs.synth_interactions(np.random.default_rng(42))
    ds = from_interactions_df(pd.DataFrame({"user_id": users, "item_id": items}))
    split = sample_users(ds, max(int(ds.user_count * cs.EVAL_USER_FRAC), 1), SampleFrac(0.2, rng=42), rng=42)
    pipe = topn_pipeline(ImplicitMFScorer(features=cs.FEATURES, epochs=cs.EPOCHS, weight=40.0, regularization=0.1), n=cs.EVAL_N)
    t = time.perf_counter()
    pipe.train(split.train, TrainingOptions(rng=42))
    torch.cuda.synchronize()
    cs.log(f"{len(split.test)} test users; Pipeline.train {time.perf_counter() - t:.3f}s")
    breakdown(pipe, split.test, cs.EVAL_N)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
