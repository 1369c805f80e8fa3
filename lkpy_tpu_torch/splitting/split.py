"""
TTSplit and split-construction helpers (port of
``lkpy_tpu/splitting/split.py``; reference: src/lenskit/splitting/_split.py:23).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pandas as pd

from lkpy_tpu_torch.data import Dataset, DatasetBuilder, ItemList, ItemListCollection
from lkpy_tpu_torch.data.schema import num_col_name

__all__ = ["TTSplit", "dataset_from_rows", "split_dataset_by_mask"]


@dataclass
class TTSplit:
    """A train/test split: training dataset + per-user test item lists."""

    train: Dataset
    test: ItemListCollection
    name: str | None = None

    @property
    def test_size(self) -> int:
        return self.test.total_items()

    @property
    def train_df(self) -> pd.DataFrame:
        return self.train.interaction_table(ids=True)

    @property
    def test_df(self) -> pd.DataFrame:
        return self.test.to_df()

    @classmethod
    def from_src_and_test(cls, src: Dataset, test: ItemListCollection, name: str | None = None) -> "TTSplit":
        """Build a split where train = src minus the test items."""
        rm = test.to_df()[["user_id", "item_id"]]
        mask = _pair_mask(src, rm)
        train = dataset_from_rows(src, ~mask)
        return cls(train, test, name)


def _pair_mask(data: Dataset, pairs: pd.DataFrame) -> np.ndarray:
    """Boolean mask over interaction rows matching the given (user, item) ID pairs."""
    tbl = data.interactions().pandas()
    unums = data.users.numbers(pairs["user_id"].to_numpy())
    inums = data.items.numbers(pairs["item_id"].to_numpy())
    key = tbl[num_col_name("user")].to_numpy().astype(np.int64) * data.item_count + tbl[
        num_col_name("item")
    ].to_numpy().astype(np.int64)
    rm_key = unums.astype(np.int64) * data.item_count + inums.astype(np.int64)
    return np.isin(key, rm_key)


def dataset_from_rows(src: Dataset, mask: np.ndarray, *, name: str | None = None) -> Dataset:
    """
    Build a training dataset from a row mask over the interaction table,
    keeping the *full* entity vocabularies (so item/user numbers stay
    comparable across train/test, like the reference's splits).  The port's
    entity sets carry no attributes yet, so there are none to copy over.
    """
    rel_name = src.default_interaction_class
    tbl = src.interactions().pandas()
    sub = tbl[mask].reset_index(drop=True)

    dsb = DatasetBuilder(name or src.name)
    for ent in src.schema.relationships[rel_name].entity_classes.values():
        dsb.add_entities(ent, src.entities(ent).vocabulary.ids)
    dsb.add_interactions(rel_name, sub, entities=list(src.schema.relationships[rel_name].entities), default=True)
    return dsb.build()


def _test_lists(src: Dataset, test_mask: np.ndarray) -> ItemListCollection:
    """The masked interaction rows as per-user test lists, users in number
    order, each row's attribute columns as fields."""
    tbl = src.interactions().pandas()
    test_rows = tbl[test_mask]
    ilc = ItemListCollection(["user_id"])
    for unum, grp in test_rows.groupby(num_col_name("user"), sort=True):
        fields = {
            c: grp[c].to_numpy()
            for c in grp.columns
            if c not in (num_col_name("user"), num_col_name("item"))
        }
        il = ItemList(item_nums=grp[num_col_name("item")].to_numpy(), vocabulary=src.items, **fields)
        ilc.add(il, src.users.id(int(unum)))
    return ilc


def split_dataset_by_mask(src: Dataset, test_mask: np.ndarray, *, name: str | None = None) -> TTSplit:
    """Split on a boolean test-row mask over the interaction table."""
    train = dataset_from_rows(src, ~test_mask, name=name)
    return TTSplit(train, _test_lists(src, test_mask), name)
