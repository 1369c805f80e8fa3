"""
DatasetBuilder: incremental dataset construction.

Port of ``lkpy_tpu/data/builder.py`` (reference:
src/lenskit/data/_builder.py:65): entities, relationships and interactions,
scalar, list and vector attributes, ``filter_interactions``,
``binarize_ratings``, ``build`` and ``save``.  Built vocabularies are
sorted, so both packages number the same IDs alike.
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
        self._attrs: dict[str, dict[str, pd.Series]] = {}  # entity -> name -> values by number
        self._tables: dict[str, pd.DataFrame] = {}  # relationship -> table with *_num cols

    @property
    def name(self) -> str | None:
        return self.schema.name

    def entity_classes(self) -> dict[str, EntitySchema]:
        return self.schema.entities

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
        self._attrs.setdefault(cls, {})

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

    def add_scalar_attribute(self, cls: str, name: str, entities, values=None) -> None:
        """Attach a scalar attribute to entities."""
        if values is None and isinstance(entities, pd.Series):
            values = entities.to_numpy()
            entities = entities.index.to_numpy()
        vocab = self._vocab(cls)
        nums = vocab.numbers(entities)
        col = pd.Series(index=range(len(vocab)), dtype=pd.Series(np.asarray(values)).dtype)
        col.iloc[nums] = np.asarray(values)
        self._attrs[cls][name] = col
        self.schema.entities[cls].attributes[name] = ColumnSpec(layout=AttrLayout.SCALAR)

    def add_list_attribute(self, cls: str, name: str, entities, values) -> None:
        vocab = self._vocab(cls)
        nums = vocab.numbers(entities)
        col = pd.Series([None] * len(vocab), dtype=object)
        for n, v in zip(nums, values):
            col.iloc[n] = list(v)
        self._attrs[cls][name] = col
        self.schema.entities[cls].attributes[name] = ColumnSpec(layout=AttrLayout.LIST)

    def add_vector_attribute(self, cls: str, name: str, entities, values) -> None:
        values = np.asarray(values)
        vocab = self._vocab(cls)
        nums = vocab.numbers(entities)
        mat = np.full((len(vocab), values.shape[1]), np.nan, dtype=values.dtype if values.dtype.kind == "f" else np.float64)
        mat[nums] = values
        col = pd.Series(list(mat), dtype=object)
        self._attrs[cls][name] = col
        self.schema.entities[cls].attributes[name] = ColumnSpec(layout=AttrLayout.VECTOR, vector_size=values.shape[1])

    def filter_interactions(self, cls: str | None = None, *, min_time=None, max_time=None, remove: pd.DataFrame | None = None):
        """Filter interactions by time window or explicit pairs."""
        cls = cls or self.schema.default_interaction
        tbl = self._tables[cls]
        keep = np.ones(len(tbl), dtype=bool)
        if min_time is not None:
            keep &= tbl["timestamp"].to_numpy() >= min_time
        if max_time is not None:
            keep &= tbl["timestamp"].to_numpy() < max_time
        if remove is not None:
            ent_cols = [num_col_name(e) for e in self.schema.relationships[cls].entities]
            rm = remove.copy()
            for e in self.schema.relationships[cls].entities:
                if id_col_name(e) in rm.columns and num_col_name(e) not in rm.columns:
                    rm[num_col_name(e)] = self._vocab(e).numbers(rm[id_col_name(e)].to_numpy())
            merged = tbl[ent_cols].merge(rm[ent_cols].drop_duplicates(), on=ent_cols, how="left", indicator=True)
            keep &= (merged["_merge"] == "left_only").to_numpy()
        self._tables[cls] = tbl[keep].reset_index(drop=True)

    def binarize_ratings(self, cls: str | None = None, *, min_rating: float = 0.0, method: Literal["zero", "remove"] = "remove"):
        """Convert ratings to implicit feedback."""
        cls = cls or self.schema.default_interaction
        tbl = self._tables[cls]
        r = tbl["rating"].to_numpy()
        if method == "remove":
            self._tables[cls] = tbl[r >= min_rating].drop(columns=["rating"]).reset_index(drop=True)
            self.schema.relationships[cls].attributes.pop("rating", None)
        else:
            tbl = tbl.copy()
            tbl["rating"] = (r >= min_rating).astype(np.float32)
            self._tables[cls] = tbl

    def build(self) -> Dataset:
        entities = {}
        for cls, ids in self._ids.items():
            vocab = Vocabulary(ids, cls, reorder=True)
            # attributes from insertion order to the sorted numbers
            remap = vocab.numbers(ids)
            attrs = pd.DataFrame(index=range(len(vocab)))
            for name, col in self._attrs.get(cls, {}).items():
                out = pd.Series([None] * len(vocab), dtype=col.dtype if col.dtype != object else object)
                out.iloc[remap] = col.to_numpy()
                attrs[name] = out
            entities[cls] = EntitySet(cls, vocab, attrs)
        tables = {}
        for cls, tbl in self._tables.items():
            out = tbl.copy()
            for ent in self.schema.relationships[cls].entity_classes.values():
                old_ids = self._vocab(ent).id_array(out[num_col_name(ent)].to_numpy())
                out[num_col_name(ent)] = entities[ent].vocabulary.numbers(old_ids)
            tables[cls] = out
        return Dataset(self.schema.model_copy(deep=True), entities, tables)

    def save(self, path) -> None:
        self.build().save(path)
