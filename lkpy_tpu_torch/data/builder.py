"""
DatasetBuilder: incremental dataset construction.

Port of the entity and relationship parts of ``lkpy_tpu/data/builder.py``
(reference: src/lenskit/data/_builder.py:65): ``add_entities``,
``add_relationships``, ``add_interactions`` and ``build``.  Built
vocabularies are sorted, so both packages number the same IDs alike.
"""

from __future__ import annotations

from typing import Iterable, Literal

import numpy as np
import pandas as pd

from lkpy_tpu_torch.data.dataset import Dataset, EntitySet
from lkpy_tpu_torch.data.schema import (
    AttrLayout,
    ColumnSpec,
    DataSchema,
    EntitySchema,
    RelationshipSchema,
    id_col_name,
    num_col_name,
)
from lkpy_tpu_torch.data.vocab import Vocabulary
from lkpy_tpu_torch.diagnostics import DataError

__all__ = ["DatasetBuilder"]


class DatasetBuilder:
    """
    Incrementally build a :class:`Dataset`.

    Args:
        name: dataset name.
    """

    def __init__(self, name: str | None = None):
        self.schema = DataSchema(name=name)
        self._ids: dict[str, np.ndarray] = {}  # entity -> id array (insertion order)
        self._tables: dict[str, pd.DataFrame] = {}  # relationship -> table with *_num cols

    @property
    def name(self) -> str | None:
        return self.schema.name

    def add_entities(
        self,
        cls: str,
        ids: Iterable | np.ndarray | pd.Series,
        *,
        duplicates: Literal["error", "overwrite"] = "error",
    ) -> None:
        """Add entities of a class."""
        ids = np.asarray(pd.unique(pd.Series(list(ids) if not isinstance(ids, (np.ndarray, pd.Series)) else ids)))
        if ids.dtype == object:
            ids = ids.astype(str)
        if cls in self._ids:
            existing = self._ids[cls]
            fresh_mask = Vocabulary(existing, cls, reorder=False).numbers(ids, missing="negative") < 0
            if np.any(~fresh_mask) and duplicates == "error":
                raise DataError(f"duplicate {cls} IDs (use duplicates='overwrite')")
            ids = np.concatenate([existing, ids[fresh_mask]])
        else:
            self.schema.entities[cls] = EntitySchema(id_type="str" if ids.dtype.kind in "UO" else "int")
        self._ids[cls] = ids

    def _vocab(self, cls: str) -> Vocabulary:
        return Vocabulary(self._ids.get(cls, np.array([], dtype=np.int64)), cls, reorder=False)

    def add_relationships(
        self,
        cls: str,
        data: pd.DataFrame,
        *,
        entities: Iterable[str] | None = None,
        missing: Literal["error", "insert", "filter"] = "error",
        allow_repeats: bool = True,
        interaction: bool | Literal["default"] = False,
    ) -> None:
        """Add relationship records.

        ``data`` must have ``<entity>_id`` (or ``<entity>_num``) columns for
        each entity class, plus attribute columns.
        """
        data = data.reset_index(drop=True)
        if entities is None:
            entities = [c[:-3] for c in data.columns if c.endswith("_id")]
        entities = list(entities)
        if len(entities) < 2:
            raise DataError(f"relationship {cls!r} needs ≥2 entity classes, got {entities}")

        nums = {}
        keep = np.ones(len(data), dtype=bool)
        for ent in entities:
            idc, numc = id_col_name(ent), num_col_name(ent)
            if numc in data.columns:
                if ent not in self._ids:
                    raise DataError(
                        f"{numc} given but entity class {ent!r} has no vocabulary — "
                        f"add_entities({ent!r}, ...) first, or pass {idc} instead"
                    )
                nums[ent] = data[numc].to_numpy().astype(np.int32)
                continue
            if idc not in data.columns:
                raise DataError(f"data has neither {idc} nor {numc}")
            ids = data[idc].to_numpy()
            if ids.dtype == object:
                ids = ids.astype(str)
            if ent not in self._ids:
                if missing == "error":
                    raise DataError(f"unknown entity class {ent!r} (use missing='insert')")
                self.add_entities(ent, pd.unique(ids))
            n = self._vocab(ent).numbers(ids, missing="negative")
            if np.any(n < 0):
                if missing == "insert":
                    self.add_entities(ent, pd.unique(ids[n < 0]))
                    n = self._vocab(ent).numbers(ids)
                elif missing == "filter":
                    keep &= n >= 0
                else:
                    raise DataError(f"{int(np.sum(n < 0))} unknown {ent} IDs")
            nums[ent] = n.astype(np.int32)

        attr_cols = [c for c in data.columns if not c.endswith("_id") and not c.endswith("_num")]
        tbl = pd.DataFrame({num_col_name(e): nums[e][keep] for e in entities})
        for c in attr_cols:
            tbl[c] = data[c].to_numpy()[keep]

        if not allow_repeats and tbl.duplicated(subset=[num_col_name(e) for e in entities]).any():
            raise DataError(f"repeated {cls} records but allow_repeats=False")

        if cls in self._tables:
            self._tables[cls] = pd.concat([self._tables[cls], tbl], ignore_index=True)
        else:
            self._tables[cls] = tbl
            self.schema.relationships[cls] = RelationshipSchema(
                entities={e: None for e in entities},
                interaction=bool(interaction),
                repeats=allow_repeats,
                attributes={c: ColumnSpec(layout=AttrLayout.SCALAR) for c in attr_cols},
            )
        if interaction == "default":
            self.schema.default_interaction = cls

    def add_interactions(
        self,
        cls: str,
        data: pd.DataFrame,
        *,
        entities: Iterable[str] | None = None,
        missing: Literal["error", "insert", "filter"] = "error",
        allow_repeats: bool = True,
        default: bool = False,
    ) -> None:
        """Add interaction records."""
        self.add_relationships(
            cls,
            data,
            entities=entities,
            missing=missing,
            allow_repeats=allow_repeats,
            interaction="default" if default or not self.schema.default_interaction else True,
        )
        self.schema.relationships[cls].interaction = True
        if default or not self.schema.default_interaction:
            self.schema.default_interaction = cls

    def build(self) -> Dataset:
        entities = {cls: EntitySet(cls, Vocabulary(ids, cls, reorder=True)) for cls, ids in self._ids.items()}
        tables = {}
        for cls, tbl in self._tables.items():
            out = tbl.copy()
            for ent in self.schema.relationships[cls].entity_classes.values():
                old_ids = self._vocab(ent).id_array(out[num_col_name(ent)].to_numpy())
                out[num_col_name(ent)] = entities[ent].vocabulary.numbers(old_ids)
            tables[cls] = out
        return Dataset(self.schema.model_copy(deep=True), entities, tables)
