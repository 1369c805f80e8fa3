"""
Temporal (global-time) splitting (port of ``lkpy_tpu/splitting/temporal.py``;
reference: src/lenskit/splitting/_temporal.py:20,124).
"""

from __future__ import annotations

from datetime import datetime

import numpy as np

from lkpy_tpu_torch.data import Dataset
from lkpy_tpu_torch.splitting.split import TTSplit, _test_lists, dataset_from_rows, split_dataset_by_mask

__all__ = ["split_global_time", "split_temporal_fraction"]


def _as_ts(t) -> float:
    if isinstance(t, datetime):
        return t.timestamp()
    return float(t)


def split_global_time(data: Dataset, time, end=None) -> TTSplit | list[TTSplit]:
    """
    Split at global time point(s): test = interactions in [time, end)
    (reference: _temporal.py:20).  A list of times yields a list of splits.
    """
    if isinstance(time, (list, tuple)):
        points = [_as_ts(t) for t in time] + [None if end is None else _as_ts(end)]
        return [_time_split(data, points[i], points[i + 1]) for i in range(len(points) - 1)]
    return _time_split(data, _as_ts(time), None if end is None else _as_ts(end))


def _time_split(data: Dataset, start: float, end: float | None) -> TTSplit:
    tbl = data.interactions().pandas()
    if "timestamp" not in tbl.columns:
        raise ValueError("dataset has no timestamps")
    ts = tbl["timestamp"].to_numpy().astype(np.float64)
    mask = ts >= start
    if end is None:
        return split_dataset_by_mask(data, mask)
    # a bounded window: train excludes the interactions after it too
    test_mask = mask & (ts < end)
    return TTSplit(dataset_from_rows(data, ts < start), _test_lists(data, test_mask))


def split_temporal_fraction(data: Dataset, test_fraction: float) -> TTSplit:
    """Hold out the most recent fraction of interactions
    (reference: _temporal.py:124)."""
    tbl = data.interactions().pandas()
    ts = tbl["timestamp"].to_numpy().astype(np.float64)
    cut = np.quantile(ts, 1.0 - test_fraction)
    return split_global_time(data, cut)
