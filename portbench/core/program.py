"""
What the benchmark takes from the program under test (``lkpy_tpu_torch``):
its data layer, built here from the benchmark's own interactions, and its
kernels' names.  Imported only by code that runs the program.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from portbench.core.data import Interactions

__all__ = ["build_dataset", "kernel_kind"]


def build_dataset(inter: Interactions):
    """The program's ``Dataset`` of the interactions, through its
    ``DatasetBuilder``; checks that it numbers users and items by id, so
    that row ``i`` of every table is id ``i`` on both sides."""
    from lkpy_tpu_torch.data import from_interactions_df

    frame = pd.DataFrame({"user_id": inter.users.cpu().numpy(), "item_id": inter.items.cpu().numpy()})
    ds = from_interactions_df(frame)
    for vocab, n in ((ds.users, inter.n_users), (ds.items, inter.n_items)):
        if not np.array_equal(np.asarray(vocab.ids), np.arange(n)):
            raise RuntimeError("the program's vocabulary does not number the ids in order")
    return ds


def kernel_kind(name: str) -> str | None:
    """Which of the program's hand-written kernels a device activity is, by
    its kernel name: ``G`` (gather_gram), ``B1`` (spd_solve_chunked) or
    ``B2`` (spd_solve)."""
    if "gather_gram" in name:
        return "G"
    if "spd_solve_chunked" in name:
        return "B1"
    if "spd_solve" in name:
        return "B2"
    return None
