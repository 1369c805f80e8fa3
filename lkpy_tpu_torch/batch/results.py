"""Batch run results (port of ``lkpy_tpu/batch/results.py``; reference:
src/lenskit/batch/_results.py)."""

from __future__ import annotations

from lkpy_tpu_torch.data import ItemListCollection

__all__ = ["BatchResults"]


class BatchResults:
    """Results of a batch pipeline run, keyed by output name."""

    def __init__(self, key_fields: tuple[str, ...] = ("user_id",)):
        self.key_fields = key_fields
        self._outputs: dict[str, ItemListCollection] = {}

    @property
    def outputs(self) -> list[str]:
        return list(self._outputs.keys())

    def output(self, name: str) -> ItemListCollection:
        return self._outputs[name]

    def add_result(self, name: str, key: tuple, items):
        if name not in self._outputs:
            self._outputs[name] = ItemListCollection(self.key_fields)
        self._outputs[name].add(items, *key)
