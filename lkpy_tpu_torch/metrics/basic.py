"""
Basic list statistics (port of ``lkpy_tpu/metrics/basic.py``; reference:
src/lenskit/metrics/basic.py:21,35,49).

These are bookkeeping metrics rather than quality metrics: list lengths,
test-set sizes, and run-level unique-item counts (a cheap catalog-coverage
signal).  They run entirely on the host: the values are O(list) counters.
"""

from __future__ import annotations

from lkpy_tpu_torch.data import ItemList, ItemListCollection
from lkpy_tpu_torch.metrics._base import GlobalMetric, ListMetric

__all__ = ["ListLength", "TestItemCount", "UniqueItemCount"]


class ListLength(ListMetric):
    """Length of each output list (reference: metrics/basic.py:21, label ``N``)."""

    @property
    def label(self) -> str:
        return "N"

    def measure_list(self, output: ItemList, test: ItemList, /) -> float:
        return float(len(output))


class TestItemCount(ListMetric):
    """Number of test items per list (reference: metrics/basic.py:35)."""

    def measure_list(self, output: ItemList, test: ItemList, /) -> float:
        return float(len(test))


class UniqueItemCount(GlobalMetric):
    """Number of distinct items recommended across the whole run
    (reference: metrics/basic.py:49 — there an accumulator over id sets;
    here a run-level reduction, which is the same number)."""

    def measure_run(self, outputs: ItemListCollection, test: ItemListCollection, /) -> float:
        seen: set = set()
        for _key, il in outputs:
            seen.update(il.ids().tolist())
        return float(len(seen))
