"""
ItemList: a list of items with attached data.

Port of ``lkpy_tpu/data/items.py`` (reference: src/lenskit/data/_items.py:46)
with the accessors the serving path and its results use: IDs and numbers
under a vocabulary, scores, ranks and per-item fields.  Payloads are NumPy
arrays on the host; ``format="torch"`` exports a tensor.
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
        *,
        item_ids=None,
        item_nums=None,
        vocabulary: Vocabulary | None = None,
        ordered: bool | None = None,
        scores=None,
        rank=None,
        **fields,
    ):
        self._vocab = vocabulary
        self._ids = None
        self._nums = None
        self._fields: dict[str, np.ndarray] = {}
        if item_ids is not None:
            ids = _np_field(item_ids)
            if ids.ndim != 1:
                raise TypeError(f"item_ids must be 1-D (got {ids.ndim}-D)")
            self._ids = ids.astype(str) if ids.dtype == object else ids
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
        self.ordered = bool(ordered)
        for name, data in fields.items():
            if data is not None:
                self._fields[name] = _np_field(data)
        for name, arr in self._fields.items():
            if len(arr) != self._len:
                raise ValueError(f"field {name!r} length {len(arr)} != item count {self._len}")

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

    def to_df(self) -> pd.DataFrame:
        cols = {}
        if self._ids is not None or self._vocab is not None:
            cols["item_id"] = self.ids()
        for name in self._fields:
            cols[name] = self.field(name)
        if self.ordered and "rank" not in cols:
            cols["rank"] = self.ranks()
        return pd.DataFrame(cols)

    def __repr__(self) -> str:
        return f"<ItemList of {self._len} items{' (ordered)' if self.ordered else ''}>"
