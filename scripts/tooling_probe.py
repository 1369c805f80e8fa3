"""
``chip_smoke.py``'s tooling phase alone on one NVIDIA GPU.

    python3 scripts/tooling_probe.py

Builds the kernels, makes ``chip_smoke.py``'s data (bench.py's synthetic
interactions and split, 138,000 users x 27,000 items, seed 42), runs its
training phase (the split and the direct path's NDCG@10) and its pipeline
phase (the pipeline's NDCG@10, which the tooling phase is held to), then its
``tooling_phase``: the command line from ``pipelines/als-implicit.toml`` to a
pickled model and its lists, in this process and in a fresh interpreter, the
tuner over ``pipelines/als-implicit-search.toml``, and the profiled runner,
with every check of that phase.  Prints the card's name and power limit
first and last.
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
        print("tooling_probe: no CUDA device", file=sys.stderr)
        return 1
    from lkpy_tpu_torch.ops import _build

    card = cs.card_line()
    cs.log(card)
    cs.log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t = time.perf_counter()
    names = _build.sources()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))
    cs.log(f"build: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    rng = np.random.default_rng(42)
    users, items = cs.synth_interactions(rng)
    cs.log(f"interactions: {len(users)} ({time.perf_counter() - t:.1f}s)")
    _, _, split = cs.training_phase(dev, users, items, rng)
    cs.pipeline_phase(dev, split)
    t = time.perf_counter()
    paths = cs.tooling_phase(dev, split)
    cs.log(f"tooling phase: {time.perf_counter() - t:.1f}s")
    cs.log(f"launches by path: {paths}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
