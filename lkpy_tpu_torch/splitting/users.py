"""
User-based splitting (port of ``lkpy_tpu/splitting/users.py``; reference:
src/lenskit/splitting/_users.py:27,85).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from lkpy_tpu_torch.data import Dataset, ItemListCollection
from lkpy_tpu_torch.data.schema import num_col_name
from lkpy_tpu_torch.random import RNGInput, random_generator
from lkpy_tpu_torch.splitting.holdout import HoldoutMethod
from lkpy_tpu_torch.splitting.split import TTSplit, dataset_from_rows

__all__ = ["crossfold_users", "sample_users"]


def _user_split(data: Dataset, user_nums: np.ndarray, method: HoldoutMethod, name=None) -> TTSplit:
    """Hold out items for the given users; everything else trains."""
    matrix = data.interaction_matrix()
    tbl = data.interactions().pandas()
    # the relationship table's row order may differ from the matrix's, so
    # rows are matched by (user, item) and not by position
    test_mask = np.zeros(len(tbl), dtype=bool)
    ilc = ItemListCollection(["user_id"])
    ucol = tbl[num_col_name("user")].to_numpy()
    icol = tbl[num_col_name("item")].to_numpy()
    # sort table rows by user once; every user's range by one searchsorted,
    # in the column's own integer type (a wider needle makes NumPy convert
    # the whole column on each call)
    order = np.argsort(ucol, kind="stable")
    sorted_u = ucol[order]
    needles = np.asarray(user_nums).astype(sorted_u.dtype)
    starts = np.searchsorted(sorted_u, needles, side="left")
    ends = np.searchsorted(sorted_u, needles, side="right")
    for unum, lo, hi in zip(user_nums, starts, ends):
        row = matrix.row_items(number=int(unum))
        test_items = method(row)
        ilc.add(test_items, data.users.id(int(unum)))
        sel = order[lo:hi]
        tmask = np.isin(icol[sel], test_items.numbers())
        test_mask[sel[tmask]] = True
    train = dataset_from_rows(data, ~test_mask)
    return TTSplit(train, ilc, name)


def sample_users(
    data: Dataset,
    size: int,
    method: HoldoutMethod,
    *,
    rng: RNGInput = None,
    test_only: bool = False,
) -> TTSplit:
    """Sample ``size`` users and hold out items per ``method``
    (reference: _users.py:85)."""
    gen = random_generator(rng)
    size = min(size, data.user_count)
    users = gen.choice(data.user_count, size=size, replace=False)
    return _user_split(data, np.sort(users), method)


def crossfold_users(
    data: Dataset,
    partitions: int,
    method: HoldoutMethod,
    *,
    rng: RNGInput = None,
) -> Iterator[TTSplit]:
    """Partition users into k folds; each fold's users get held-out items
    (reference: _users.py:27)."""
    gen = random_generator(rng)
    users = gen.permutation(data.user_count)
    for i, fold in enumerate(np.array_split(users, partitions)):
        yield _user_split(data, np.sort(fold), method, name=f"fold-{i}")
