"""
Record-based splitting (port of ``lkpy_tpu/splitting/records.py``;
reference: src/lenskit/splitting/_records.py:24,72).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from lkpy_tpu_torch.data import Dataset
from lkpy_tpu_torch.random import RNGInput, random_generator
from lkpy_tpu_torch.splitting.split import TTSplit, split_dataset_by_mask

__all__ = ["crossfold_records", "sample_records"]


def sample_records(data: Dataset, size: int, *, rng: RNGInput = None) -> TTSplit:
    """Hold out a random sample of interaction records (reference: _records.py:72)."""
    gen = random_generator(rng)
    n = data.interaction_count
    size = min(size, n)
    test_rows = gen.choice(n, size=size, replace=False)
    mask = np.zeros(n, dtype=bool)
    mask[test_rows] = True
    return split_dataset_by_mask(data, mask)


def crossfold_records(data: Dataset, partitions: int, *, rng: RNGInput = None) -> Iterator[TTSplit]:
    """Partition interaction records into k folds (reference: _records.py:24)."""
    gen = random_generator(rng)
    n = data.interaction_count
    rows = gen.permutation(n)
    for i, fold in enumerate(np.array_split(rows, partitions)):
        mask = np.zeros(n, dtype=bool)
        mask[fold] = True
        yield split_dataset_by_mask(data, mask, name=f"fold-{i}")
