"""
ItemList: a list of items with attached data.

Port of ``lkpy_tpu/data/items.py`` (reference: src/lenskit/data/_items.py:46)
with the accessors the serving path, the pipeline and its components use:
IDs and numbers under a vocabulary, scores, ranks and per-item fields,
membership, removal, selection and the top-N.  Payloads are NumPy arrays on
the host; ``format="torch"`` exports a tensor.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import pandas as pd
import pyarrow as pa
import torch

from lkpy_tpu_torch.data.vocab import Vocabulary

__all__ = ["ItemList"]


def _np_field(data) -> np.ndarray:
    if isinstance(data, pa.ChunkedArray):
        data = data.combine_chunks()
    if isinstance(data, pa.Array):
        data = data.to_numpy(zero_copy_only=False)
    if isinstance(data, (pd.Series, pd.Index)):
        data = data.to_numpy()
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.asarray(data)


class ItemList:
    """
    An immutable list of items with optional attached data.

    Args:
        source: another item list to copy and extend.
        item_ids: item IDs.
        item_nums: item numbers (requires ``vocabulary`` to resolve to IDs).
        vocabulary: the item vocabulary.
        ordered: whether this list is a ranking (ordered by preference).
        scores: item scores (float; NaN = unscored).
        rank: 1-based ranks (implies ``ordered``).
        fields: additional per-item arrays (e.g. ``rating``, ``timestamp``).
    """

    def __init__(
        self,
        source: "ItemList | None" = None,
        *,
        item_ids=None,
        item_nums=None,
        vocabulary: Vocabulary | None = None,
        ordered: bool | None = None,
        scores=None,
        rank=None,
        **fields,
    ):
        if source is not None:
            self._ids = source._ids
            self._nums = source._nums
            self._vocab = source._vocab
            self._fields = dict(source._fields)
            self.ordered = source.ordered
        else:
            self._ids = None
            self._nums = None
            self._vocab = None
            self._fields: dict[str, np.ndarray] = {}
            self.ordered = False
        if vocabulary is not None:
            self._vocab = vocabulary
        if item_ids is not None:
            ids = _np_field(item_ids)
            if ids.ndim != 1:
                raise TypeError(f"item_ids must be 1-D (got {ids.ndim}-D)")
            self._ids = ids.astype(str) if ids.dtype == object else ids
            # inherited numbers no longer belong to these IDs
            self._nums = None
        if item_nums is not None:
            nums = _np_field(item_nums)
            if nums.ndim != 1:
                raise TypeError(f"item_nums must be 1-D (got {nums.ndim}-D)")
            if nums.dtype.kind not in "iu":
                raise TypeError(f"item_nums must be integers (got {nums.dtype})")
            if self._ids is not None and len(nums) != len(self._ids):
                raise ValueError(
                    f"item_ids and item_nums have mismatched sizes ({len(self._ids)} != {len(nums)})"
                )
            self._nums = nums.astype(np.int32)
        if self._ids is None and self._nums is None:
            self._ids = np.array([], dtype=np.int64)
        self._len = len(self._ids) if self._ids is not None else len(self._nums)

        if scores is not None:
            self._fields["score"] = _np_field(scores).astype(np.float32)
        if rank is not None:
            self._fields["rank"] = _np_field(rank).astype(np.int32)
            ordered = True if ordered is None else ordered
        if ordered is not None:
            self.ordered = bool(ordered)
        for name, data in fields.items():
            if data is not None:
                self._fields[name] = _np_field(data)
        for name, arr in self._fields.items():
            if len(arr) != self._len:
                raise ValueError(f"field {name!r} length {len(arr)} != item count {self._len}")

    @classmethod
    def from_df(cls, df: pd.DataFrame, *, vocabulary: Vocabulary | None = None) -> "ItemList":
        """Create from a DataFrame with ``item_id`` (or ``item_num``) and
        optional score, rank and other columns (reference: _items.py:438).
        ``user_*`` columns are dropped."""
        ids = df["item_id"].to_numpy() if "item_id" in df.columns else None
        nums = df["item_num"].to_numpy() if "item_num" in df.columns else None
        fields = {}
        ordered = None
        scores = None
        rank = None
        for col in df.columns:
            if col in ("item_id", "item_num") or col.startswith("user_"):
                continue
            if col == "score":
                scores = df[col].to_numpy()
            elif col == "rank":
                rank = df[col].to_numpy()
                if rank.dtype.kind == "f" and np.isnan(rank).any():
                    # long frames mixing ordered and unordered lists carry
                    # NaN ranks for the unordered ones — treat as unranked
                    rank = None
                else:
                    ordered = True
            else:
                fields[col] = df[col].to_numpy()
        return cls(
            item_ids=ids, item_nums=nums, vocabulary=vocabulary, scores=scores, rank=rank, ordered=ordered, **fields
        )

    @classmethod
    def from_vocabulary(cls, vocab: Vocabulary) -> "ItemList":
        """All items in a vocabulary, in number order (reference: _items.py:518)."""
        return cls(item_nums=np.arange(len(vocab), dtype=np.int32), vocabulary=vocab)

    @property
    def vocabulary(self) -> Vocabulary | None:
        return self._vocab

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def ids(self) -> np.ndarray:
        """Item IDs (resolving through the vocabulary if needed)."""
        if self._ids is None:
            if self._vocab is None:
                raise RuntimeError("item list has no IDs and no vocabulary")
            self._ids = self._vocab.id_array(self._nums)
        return self._ids

    def numbers(
        self,
        format: str = "numpy",
        *,
        vocabulary: Vocabulary | None = None,
        missing: Literal["error", "negative"] = "error",
    ):
        """Item numbers under the list's vocabulary, or under ``vocabulary``."""
        vocab = vocabulary if vocabulary is not None else self._vocab
        if vocab is None:
            raise RuntimeError("item list has no vocabulary")
        # numbers are stored only for the list's own vocabulary; a
        # numbers-only list with no vocabulary of its own is taken to be
        # numbered in the caller's
        if vocabulary is not None and vocabulary is not self._vocab and not (self._vocab is None and self._ids is None):
            nums = vocab.numbers(self.ids(), missing=missing)
        elif self._nums is None:
            nums = vocab.numbers(self._ids, missing=missing)
            self._nums = nums if missing == "error" else None
        else:
            nums = self._nums
        return self._export(nums, format)

    def scores(self, format: str = "numpy"):
        """Item scores, or None if unscored."""
        return self._export(self._fields.get("score"), format)

    def ranks(self, format: str = "numpy"):
        """1-based ranks if this list is ordered."""
        r = self._fields.get("rank")
        if r is None and self.ordered:
            r = np.arange(1, self._len + 1, dtype=np.int32)
        return self._export(r, format)

    def field(self, name: str, format: str = "numpy"):
        if name == "rank":
            return self.ranks(format)
        return self._export(self._fields.get(name), format)

    @property
    def field_names(self) -> list[str]:
        return list(self._fields.keys())

    @staticmethod
    def _export(arr, format: str):
        if arr is None or format == "numpy":
            return arr
        if format == "torch":
            return torch.from_numpy(np.ascontiguousarray(arr))
        raise ValueError(f"unknown format {format!r}")

    # ---- set / ranking operations ---------------------------------------
    def isin(self, other: "ItemList") -> np.ndarray:
        """Boolean membership mask of this list's items in ``other`` (reference: _items.py:756)."""
        if self._vocab is not None and other._vocab is not None and self._vocab == other._vocab:
            return np.isin(self.numbers(), other.numbers())
        return np.isin(self.ids(), other.ids())

    def top_n(self, n: int | None = None, *, scores=None) -> "ItemList":
        """
        The top-N items by score, as an ordered (ranked) list
        (reference: _items.py:942).  NaN scores sort last and are dropped.
        """
        if scores is None:
            svals = self.scores()
        elif isinstance(scores, str):
            svals = self.field(scores)
        else:
            svals = _np_field(scores).astype(np.float32)
        if svals is None:
            raise ValueError("top_n requires scores")
        valid = ~np.isnan(svals)
        k = int(np.sum(valid))
        if n is not None:
            k = min(k, n)
        # argsort descending on negated scores; stable for ties
        order = np.argsort(-np.where(valid, svals, -np.inf), kind="stable")[:k]
        out = self._take(order)
        return ItemList(out, ordered=True, rank=np.arange(1, k + 1, dtype=np.int32), scores=svals[order])

    def remove(self, items: "ItemList") -> "ItemList":
        """A copy of this list with the given items removed (reference: _items.py:1072)."""
        mask = ~self.isin(items)
        return self._take(np.nonzero(mask)[0])

    def _take(self, idx: np.ndarray, *, ordered: bool | None = None) -> "ItemList":
        fields = {n: v[idx] for n, v in self._fields.items() if n != "rank"}
        scores = fields.pop("score", None)
        return ItemList(
            item_ids=self._ids[idx] if self._ids is not None else None,
            item_nums=self._nums[idx] if self._nums is not None else None,
            vocabulary=self._vocab,
            scores=scores,
            ordered=self.ordered if ordered is None else ordered,
            **fields,
        )

    def __getitem__(self, sel) -> "ItemList":
        if isinstance(sel, (int, np.integer)):
            sel = np.asarray([sel])
        elif isinstance(sel, slice):
            sel = np.arange(self._len)[sel]
        else:
            sel = np.asarray(sel)
            if sel.dtype == bool:
                sel = np.nonzero(sel)[0]
        return self._take(sel)

    # ---- export ----------------------------------------------------------
    def to_df(self, *, ids: bool = True, numbers: bool = True) -> pd.DataFrame:
        cols = {}
        if ids and (self._ids is not None or self._vocab is not None):
            cols["item_id"] = self.ids()
        if numbers and (self._nums is not None or self._vocab is not None):
            try:
                cols["item_num"] = self.numbers()
            except (RuntimeError, KeyError):
                pass
        for name in self._fields:
            cols[name] = self.field(name)
        if self.ordered and "rank" not in cols:
            cols["rank"] = self.ranks()
        return pd.DataFrame(cols)

    def __repr__(self) -> str:
        return f"<ItemList of {self._len} items{' (ordered)' if self.ordered else ''}>"
