"""
Vocabularies: bidirectional ID ↔ contiguous-index maps.

Port of ``lkpy_tpu/data/vocab.py`` (reference: src/lenskit/data/_vocab.py:32).
The vocabulary is a sorted NumPy array and lookups are vectorized
``searchsorted``; numbering is the JAX package's, so the two packages give
every ID the same number.
"""

from __future__ import annotations

import hashlib
from typing import Any, Iterator, Literal

import numpy as np
import pandas as pd
import pyarrow as pa

__all__ = ["Vocabulary"]


def _as_id_array(keys) -> np.ndarray:
    if isinstance(keys, pa.ChunkedArray):
        keys = keys.combine_chunks()
    if isinstance(keys, pa.Array):
        keys = keys.to_numpy(zero_copy_only=False)
    if isinstance(keys, (pd.Index, pd.Series)):
        keys = keys.to_numpy()
    arr = np.asarray(keys)
    if arr.dtype == object:
        # normalize object arrays of strings to str dtype for sortability
        arr = arr.astype(str)
    return arr


class Vocabulary:
    """
    A vocabulary mapping entity IDs to contiguous nonnegative integers.

    Args:
        keys: IDs to place in the vocabulary (ints or strings).
        name: entity-class name (e.g. ``"user"``, ``"item"``).
        reorder: if True (default), sort and deduplicate; if False, preserve
            input order (IDs must already be unique).
    """

    name: str | None

    def __init__(self, keys=None, name: str | None = None, *, reorder: bool = True):
        self.name = name
        arr = np.array([], dtype=np.int64) if keys is None else _as_id_array(keys)
        if reorder:
            arr = np.unique(arr)  # sorted + dedup
            self._ids = arr
            self._sorted_ids = arr
            self._order = None  # identity
        else:
            if arr.size != np.unique(arr).size:
                raise ValueError("IDs in a vocabulary must be unique")
            self._ids = arr
            order = np.argsort(arr, kind="stable")
            self._sorted_ids = arr[order]
            self._order = order.astype(np.int64)
        self._hash: str | None = None

    @property
    def ids(self) -> np.ndarray:
        """All IDs, in vocabulary order (index i holds the ID of number i)."""
        return self._ids

    @property
    def size(self) -> int:
        return len(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __iter__(self) -> Iterator:
        return iter(self._ids)

    def __eq__(self, other: object) -> bool:
        if self is other:
            return True
        if not isinstance(other, Vocabulary):
            return NotImplemented
        return self.checksum() == other.checksum()

    def __hash__(self) -> int:
        return hash(self.checksum())

    def checksum(self) -> str:
        """Content hash for fast equivalence tests."""
        if self._hash is None:
            h = hashlib.sha1()
            h.update(str(self._ids.dtype).encode())
            h.update(np.ascontiguousarray(self._ids).tobytes())
            self._hash = h.hexdigest()
        return self._hash

    def number(self, key: Any, missing: Literal["error", "negative"] = "error") -> int:
        """Look up the number for a single ID."""
        n = int(self.numbers(np.asarray([key]), missing="negative")[0])
        if n < 0 and missing == "error":
            raise KeyError(f"ID {key!r} not in vocabulary {self.name!r}")
        return n

    def numbers(self, keys, missing: Literal["error", "negative"] = "error") -> np.ndarray:
        """
        Vectorized ID → number lookup.

        Returns int32 numbers; missing IDs are −1 (``missing="negative"``) or
        raise ``KeyError``.
        """
        arr = _as_id_array(keys)
        if self._sorted_ids.size == 0:
            nums = np.full(arr.shape, -1, dtype=np.int32)
        else:
            try:
                pos = np.searchsorted(self._sorted_ids, arr)
            except TypeError as e:  # mixed/incomparable types
                raise KeyError(f"IDs not comparable with vocabulary: {e}") from e
            pos = np.clip(pos, 0, self._sorted_ids.size - 1)
            found = self._sorted_ids[pos] == arr
            src = pos if self._order is None else self._order[pos]
            nums = np.where(found, src, -1).astype(np.int32)
        if missing == "error" and np.any(nums < 0):
            bad = arr[nums < 0]
            raise KeyError(f"{bad.size} IDs not in vocabulary {self.name!r} (first: {bad[:5]!r})")
        return nums

    def id(self, num: int):
        """Look up the ID for a number."""
        n = int(num)
        if n < 0 or n >= len(self._ids):
            raise IndexError(f"number {n} out of range for vocabulary of size {len(self._ids)}")
        return self._ids[n]

    def id_array(self, nums=None) -> np.ndarray:
        """Vectorized number → ID lookup (all IDs if ``nums`` is None)."""
        if nums is None:
            return self._ids
        return self._ids[np.asarray(nums)]

    def __repr__(self) -> str:
        return f"<Vocabulary {self.name or '?'} [{len(self)} IDs]>"
