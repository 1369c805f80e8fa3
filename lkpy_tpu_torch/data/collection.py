"""
ItemListCollection: keyed collections of item lists.

Port of ``lkpy_tpu/data/collection.py`` (reference:
src/lenskit/data/_collection/_base.py:48): collections keyed by tuples of
IDs (e.g. ``user_id``) with lookup, projected lookup and long-frame import
and export, and :class:`ArrayTopNILC`, the array-backed form the batch
serving path returns.
"""

from __future__ import annotations

from os import PathLike
from typing import Any, Iterator, Mapping, Protocol, Sequence, runtime_checkable

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq

from lkpy_tpu_torch.data.items import ItemList
from lkpy_tpu_torch.data.keys import create_key_type, project_key

#: the schema metadata key holding the key fields of a saved collection
#: (the JAX package's, so that either package reads the other's files)
_KEY_META = b"lkpy_tpu_key"

__all__ = [
    "ItemListCollection",
    "ItemListCollector",
    "MutableItemListCollection",
    "ListILC",
    "ArrayTopNILC",
]


@runtime_checkable
class ItemListCollector(Protocol):
    """Anything item lists can be added to (reference: _collection/_base.py:594)."""

    def add(self, items: ItemList, *fields: Any, **kwfields: Any) -> None: ...  # pragma: no cover


class ItemListCollection:
    """
    A collection of item lists, keyed by tuples of field values.

    Args:
        key: the key field names (e.g. ``["user_id"]``), or a NamedTuple
            class whose fields they are.
        index: keep a key index for :meth:`lookup` (a collection built
            without one can still be iterated).
    """

    def __init__(self, key: Sequence[str] | type | None = None, *, index: bool = True):
        if key is None:
            key = ["user_id"]
        self._fields = tuple(key._fields if isinstance(key, type) else key)  # type: ignore[attr-defined]
        self._key_type = create_key_type(*self._fields)
        self._keys: list[tuple] = []
        self._lists: list[ItemList | None] = []
        self._index: dict[tuple, int] | None = {} if index else None

    @classmethod
    def empty(cls, key: Sequence[str] = ("user_id",)) -> "ItemListCollection":
        return cls(key)

    @classmethod
    def from_dict(cls, data: Mapping[Any, ItemList], key: Sequence[str] | str | None = None) -> "ItemListCollection":
        """Create from a mapping of keys to item lists (reference: _base.py:146)."""
        if key is None:
            key = ("user_id",)
        if isinstance(key, str):
            key = (key,)
        ilc = cls(key)
        for k, il in data.items():
            if not isinstance(k, tuple):
                k = (k,)
            ilc.add(il, *k)
        return ilc

    @classmethod
    def from_df(cls, df: pd.DataFrame, key: Sequence[str] | str | None = None) -> "ItemListCollection":
        """Create from a long DataFrame keyed by e.g. ``user_id`` (reference: _base.py:161)."""
        if key is None:
            key = [c for c in ("user_id",) if c in df.columns]
            if not key:
                raise ValueError("cannot infer key columns")
        if isinstance(key, str):
            key = (key,)
        key = list(key)
        ilc = cls(key)
        for kvals, grp in df.groupby(key, sort=False):
            if not isinstance(kvals, tuple):
                kvals = (kvals,)
            ilc.add(ItemList.from_df(grp.drop(columns=key)), *kvals)
        return ilc

    def add(self, items: ItemList, *key: Any, **kwkey: Any) -> None:
        if kwkey:
            key = tuple(kwkey[f] for f in self._fields)
        if len(key) != len(self._fields):
            raise ValueError(f"expected {len(self._fields)} key fields, got {len(key)}")
        k = tuple(key)
        self._keys.append(k)
        self._lists.append(items)
        if self._index is not None:
            self._index[k] = len(self._keys) - 1

    def add_from(self, other: "ItemListCollection", **fields: Any) -> None:
        """Add every list of ``other``, with fixed values for key fields
        ``other`` lacks."""
        for k, il in other.items():
            kd = dict(zip(other.key_fields, k))
            kd.update(fields)
            self.add(il, *(kd[f] for f in self._fields))

    @property
    def key_fields(self) -> tuple[str, ...]:
        return self._fields

    @property
    def key_type(self):
        return self._key_type

    def _list(self, i: int) -> ItemList:
        """Access hook for list storage — array-backed subclasses override
        this to materialize lazily."""
        return self._lists[i]

    def _empty_keys(self) -> list[tuple]:
        """Keys of the empty lists (array-backed subclasses answer this
        from their length vector without materializing lists)."""
        return [k for k, il in self.items() if len(il) == 0]

    def lookup(self, *key: Any, **kwkey: Any) -> ItemList | None:
        if kwkey:
            key = tuple(kwkey[f] for f in self._fields)
        elif len(key) == 1 and isinstance(key[0], tuple):
            key = key[0]
        if self._index is None:
            raise RuntimeError("collection is not indexed")
        idx = self._index.get(tuple(key))
        return self._list(idx) if idx is not None else None

    def lookup_projected(self, key: tuple) -> ItemList | None:
        """Lookup by a key that may have extra fields (reference: _base.py:528)."""
        if hasattr(key, "_fields"):
            try:
                key = project_key(key, self._key_type)
            except TypeError:
                return None
        return self.lookup(*key)

    def keys(self) -> Iterator[tuple]:
        for k in self._keys:
            yield self._key_type(*k)

    def lists(self) -> Iterator[ItemList]:
        for i in range(len(self._keys)):
            yield self._list(i)

    def items(self) -> Iterator[tuple[tuple, ItemList]]:
        for i, k in enumerate(self._keys):
            yield self._key_type(*k), self._list(i)

    def __len__(self) -> int:
        return len(self._keys)

    def __iter__(self):
        return self.items()

    def __getitem__(self, pos: int) -> tuple[tuple, ItemList]:
        return self._key_type(*self._keys[pos]), self._list(pos)

    def total_items(self) -> int:
        return sum(len(il) for il in self.lists())

    def to_df(self) -> pd.DataFrame:
        """Long DataFrame with key columns."""
        frames = []
        for k, il in self.items():
            df = il.to_df(numbers=False)
            for f, v in reversed(list(zip(self._fields, k))):
                df.insert(0, f, v)
            frames.append(df)
        if not frames:
            return pd.DataFrame(columns=[*self._fields, "item_id"])
        return pd.concat(frames, ignore_index=True)

    def to_arrow(self) -> pa.Table:
        return pa.Table.from_pandas(self.to_df(), preserve_index=False)

    def save_parquet(self, path: str | PathLike) -> None:
        """Save as Parquet in the long layout with key columns, the JAX
        package's file format: an empty list is one row with a null
        ``item_id``, and the key fields are in the schema's metadata."""
        df = self.to_df()
        empties = self._empty_keys()
        if empties:
            marks = pd.DataFrame(empties, columns=list(self._fields))
            marks["item_id"] = None
            df = pd.concat([df, marks], ignore_index=True)
        tbl = pa.Table.from_pandas(df, preserve_index=False)
        meta = dict(tbl.schema.metadata or {})
        meta[_KEY_META] = ",".join(self._fields).encode()
        pq.write_table(tbl.replace_schema_metadata(meta), path)

    @classmethod
    def load_parquet(cls, path: str | PathLike, key: Sequence[str] | None = None) -> "ItemListCollection":
        """Load a collection written by :meth:`save_parquet` (of either
        package); the key fields come from the file unless given."""
        tbl = pq.read_table(path)
        if key is None:
            meta = tbl.schema.metadata or {}
            if _KEY_META in meta:
                key = meta[_KEY_META].decode().split(",")
        df = tbl.to_pandas()
        null_items = df["item_id"].isna() if "item_id" in df.columns else None
        if null_items is not None and null_items.any():
            ilc = cls.from_df(df[~null_items], key)
            for _, row in df[null_items].iterrows():
                ilc.add(ItemList(), *(row[f] for f in ilc.key_fields))
            return ilc
        return cls.from_df(df, key)

    def __repr__(self) -> str:
        return f"<ItemListCollection {self._fields} [{len(self)} lists]>"


class ArrayTopNILC(ItemListCollection):
    """Array-backed top-N collection: one (N, n) block of item numbers /
    scores plus per-list lengths, with :class:`ItemList` objects
    materialized lazily on access.  ``to_df`` and ``total_items`` run
    vectorized off the arrays."""

    def __init__(
        self,
        key: Sequence[str],
        keys: Sequence,
        item_nums: np.ndarray,  # (N, n) int32
        scores: np.ndarray,  # (N, n) f32
        lengths: np.ndarray,  # (N,) int — valid prefix of each row
        vocabulary,
    ):
        super().__init__(key)
        self._keys = [k if isinstance(k, tuple) else (k,) for k in keys]
        self._index = {k: i for i, k in enumerate(self._keys)}
        self._lists = [None] * len(self._keys)
        self._nums = item_nums
        self._scores = scores
        self._lengths = np.asarray(lengths)
        self._vocab = vocabulary

    def _list(self, i: int) -> ItemList:
        il = self._lists[i]
        if il is None:
            n = int(self._lengths[i])
            il = ItemList(
                item_nums=self._nums[i, :n],
                vocabulary=self._vocab,
                scores=self._scores[i, :n],
                ordered=True,
                rank=np.arange(1, n + 1, dtype=np.int32),
            )
            self._lists[i] = il
        return il

    def add(self, items: ItemList, *key: Any, **kwkey: Any) -> None:
        raise TypeError("ArrayTopNILC is immutable")

    def _empty_keys(self) -> list[tuple]:
        return [self._keys[i] for i in np.nonzero(self._lengths == 0)[0]]

    def total_items(self) -> int:
        return int(self._lengths.sum())

    def to_df(self) -> pd.DataFrame:
        if not len(self._keys):
            return pd.DataFrame(columns=[*self._fields, "item_id"])
        lens = self._lengths.astype(np.int64)
        rows = np.repeat(np.arange(len(self._keys)), lens)
        pos = np.arange(len(rows)) - np.repeat(np.cumsum(lens) - lens, lens)
        nums = self._nums[rows, pos]
        data = {}
        key_arr = np.array([list(k) for k in self._keys], dtype=object)
        for j, f in enumerate(self._fields):
            data[f] = key_arr[rows, j]
        data["item_id"] = self._vocab.id_array(nums)
        data["score"] = self._scores[rows, pos]
        data["rank"] = (pos + 1).astype(np.int32)
        return pd.DataFrame(data)


#: the reference's names for the list-backed collection, the mutable one
#: (reference: _collection/_list.py:27)
MutableItemListCollection = ItemListCollection
ListILC = ItemListCollection
