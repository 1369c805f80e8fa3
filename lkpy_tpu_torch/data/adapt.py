"""
Convenience adapters for standard data frames (port of ``lkpy_tpu/data/adapt.py``).

Capability parity with the reference ``from_interactions_df``
(reference: src/lenskit/data/_adapt.py:104).
"""

from __future__ import annotations

import pandas as pd

from lkpy_tpu_torch.data.builder import DatasetBuilder
from lkpy_tpu_torch.data.dataset import Dataset

__all__ = ["from_interactions_df", "normalize_interactions_df"]

_COL_ALIASES = {
    "user_id": ["user_id", "user", "userId", "UserId", "userID"],
    "item_id": ["item_id", "item", "movieId", "itemId", "ItemId", "itemID"],
    "rating": ["rating", "Rating"],
    "timestamp": ["timestamp", "Timestamp", "time"],
}


def normalize_interactions_df(df: pd.DataFrame) -> pd.DataFrame:
    """Rename common column aliases to canonical names."""
    renames = {}
    for canon, aliases in _COL_ALIASES.items():
        for a in aliases:
            if a in df.columns and canon not in df.columns:
                renames[a] = canon
                break
    return df.rename(columns=renames)


def from_interactions_df(df: pd.DataFrame, *, name: str | None = None) -> Dataset:
    """
    Build a dataset from a user-item interaction frame
    (reference: _adapt.py:104).  Columns: ``user_id``, ``item_id``, optional
    ``rating``/``timestamp`` (common aliases accepted).
    """
    df = normalize_interactions_df(df)
    # drop stale row numbers from a source dataset (e.g. interaction_table
    # output): numbers are only meaningful relative to THIS builder's
    # vocabularies, which are derived from the ID columns
    stale = [c for c in ("user_num", "item_num") if c in df.columns and c.replace("_num", "_id") in df.columns]
    if stale:
        df = df.drop(columns=stale)
    dsb = DatasetBuilder(name)
    dsb.add_interactions(
        "rating" if "rating" in df.columns else "interaction",
        df,
        entities=["user", "item"],
        missing="insert",
        default=True,
    )
    return dsb.build()
