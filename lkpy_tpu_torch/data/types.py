"""
Core ID / feedback type aliases (reference: src/lenskit/data/types.py:25-56).
"""

from __future__ import annotations

from typing import Any, Literal, Sequence, TypeAlias

import numpy as np
import pandas as pd

__all__ = ["ID", "CoreID", "NPID", "IDArray", "IDSequence", "FeedbackType"]

CoreID: TypeAlias = "int | str | bytes"
"""Python-native entity identifier types."""

NPID: TypeAlias = "np.integer[Any] | np.str_ | np.bytes_ | np.object_"
"""NumPy scalar entity identifier types."""

ID: TypeAlias = "CoreID | NPID"
"""Any valid entity identifier."""

IDArray: TypeAlias = "np.ndarray[tuple[int], np.dtype[Any]]"
"""A 1-D array of entity identifiers."""

IDSequence: TypeAlias = "Sequence[ID] | IDArray | pd.Series"
"""Any sequence of entity identifiers."""

FeedbackType = Literal["explicit", "implicit"]
"""Types of feedback data supported in interactions."""
