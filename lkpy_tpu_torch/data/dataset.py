"""
Dataset: entities, relationships, and interaction matrices.

Port of the parts of ``lkpy_tpu/data/dataset.py`` that serving and the
pipeline need (reference: src/lenskit/data/_dataset.py:63,
_relationships.py:40,410): entity vocabularies, relationship tables, and the
de-duplicated :class:`MatrixRelationshipSet` with its CSR, vocabularies, row
access and per-user and per-item statistics, the interaction table that
splitting and evaluation read, and the SciPy export.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import pandas as pd
import scipy.sparse as sps

from lkpy_tpu_torch.data.items import ItemList
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.data.schema import AttrLayout, ColumnSpec, DataSchema, RelationshipSchema, num_col_name
from lkpy_tpu_torch.data.vocab import Vocabulary
from lkpy_tpu_torch.diagnostics import DataError

__all__ = ["Dataset", "EntitySet", "RelationshipSet", "MatrixRelationshipSet"]


class EntitySet:
    """A class of entities with its vocabulary."""

    def __init__(self, name: str, vocabulary: Vocabulary):
        self.name = name
        self.vocabulary = vocabulary

    def __len__(self) -> int:
        return len(self.vocabulary)

    def ids(self) -> np.ndarray:
        return self.vocabulary.ids


class RelationshipSet:
    """A set of relationship records between entity classes, stored as a
    table with ``<alias>_num`` columns plus attribute columns."""

    def __init__(self, dataset: "Dataset", name: str, schema: RelationshipSchema, table: pd.DataFrame):
        self._ds = dataset
        self.name = name
        self.schema = schema
        self._table = table

    @property
    def entities(self) -> list[str]:
        return list(self.schema.entities.keys())

    def count(self) -> int:
        return len(self._table)

    def pandas(self, *, attributes=None, ids: bool = False) -> pd.DataFrame:
        """The records as a frame of ``<alias>_num`` and attribute columns,
        with ``<alias>_id`` columns added when ``ids``."""
        df = self._table
        if attributes is not None:
            if isinstance(attributes, str):
                attributes = [attributes]
            cols = [num_col_name(e) for e in self.entities] + list(attributes)
            df = df[cols]
        if ids:
            df = df.copy()
            for alias, cls in self.schema.entity_classes.items():
                vocab = self._ds.entities(cls).vocabulary
                df[f"{alias}_id"] = vocab.id_array(df[num_col_name(alias)].to_numpy())
        return df

    def matrix(self, *, combine: str | None = None) -> "MatrixRelationshipSet":
        """De-duplicated two-entity matrix view."""
        if len(self.entities) != 2:
            raise DataError(f"relationship {self.name!r} has {len(self.entities)} entities; matrix needs 2")
        return MatrixRelationshipSet(self._ds, self.name, self.schema, self._table, combine=combine)


class MatrixRelationshipSet(RelationshipSet):
    """
    A two-entity relationship materialized as a CSR matrix.  Rows are the
    first entity (usually user), columns the second (item).  Repeated pairs
    are combined (count / sum / mean / first / last).
    """

    def __init__(self, dataset, name, schema, table, *, combine: str | None = None):
        row_alias, col_alias = list(schema.entities.keys())
        classes = schema.entity_classes
        self.row_entity = row_alias
        self.col_entity = col_alias
        self.row_vocabulary = dataset.entities(classes[row_alias]).vocabulary
        self.col_vocabulary = dataset.entities(classes[col_alias]).vocabulary

        rows = table[num_col_name(row_alias)].to_numpy()
        cols = table[num_col_name(col_alias)].to_numpy()
        attrs = {
            n: table[n].to_numpy()
            for n in schema.attributes
            if n in table.columns and table[n].dtype.kind in "ifub"
        }
        if schema.repeats and len(table):
            rows, cols, attrs, counts = _combine_repeats(rows, cols, attrs, combine)
            attrs["count"] = counts
        shape = (len(self.row_vocabulary), len(self.col_vocabulary))
        self._csr = CSR.from_coo(rows, cols, attrs.get("rating"), shape, fields=attrs)
        data = {num_col_name(row_alias): self._csr.to_coo().row, num_col_name(col_alias): self._csr.colind}
        data.update(self._csr.fields)
        new_schema = schema.model_copy(deep=True)
        new_schema.repeats = False
        for extra in set(attrs) - set(schema.attributes):
            new_schema.attributes[extra] = ColumnSpec(layout=AttrLayout.SCALAR)
        super().__init__(dataset, name, new_schema, pd.DataFrame(data))

    def matrix(self, *, combine=None) -> "MatrixRelationshipSet":
        return self

    def csr(self, attribute: str | None = "rating") -> CSR:
        """The CSR structure; values are the given attribute (None → structural)."""
        if attribute is None:
            return self._csr.drop_values()
        if attribute == "rating":
            return self._csr
        f = self._csr.fields.get(attribute)
        if f is None:
            raise KeyError(f"no attribute {attribute!r} on relationship {self.name!r}")
        return self._csr.with_values(f.astype(np.float32))

    def scipy(
        self,
        attribute: str | None = None,
        *,
        layout: Literal["csr", "coo"] = "csr",
        legacy: bool = False,
    ) -> sps.csr_array | sps.coo_array:
        """SciPy export (reference: _relationships.py:576); ``legacy`` is
        accepted and changes nothing, as in the JAX package."""
        if attribute is None and self._csr.values is not None:
            attribute = "rating"
        if attribute is None or (attribute == "rating" and self._csr.values is None):
            mat = self._csr.to_scipy(structural=True)
        else:
            mat = self.csr(attribute).to_scipy()
        if layout == "coo":
            return mat.tocoo()
        return mat

    def row_items(self, id=None, *, number: int | None = None) -> ItemList | None:
        """One row as an ItemList."""
        if number is None:
            number = self.row_vocabulary.number(id, missing="negative")
            if number < 0:
                return None
        s, e = self._csr.row_extent(number)
        fields = {n: v[s:e] for n, v in self._csr.fields.items()}
        return ItemList(item_nums=self._csr.colind[s:e], vocabulary=self.col_vocabulary, **fields)

    def row_stats(self) -> pd.DataFrame:
        return self._axis_stats(self._csr, self.row_vocabulary)

    def col_stats(self) -> pd.DataFrame:
        return self._axis_stats(self._csr.transpose(), self.col_vocabulary)

    @staticmethod
    def _axis_stats(csr: CSR, vocab: Vocabulary) -> pd.DataFrame:
        """Per-row counts and mean ratings, and first and last times where
        the relationship has them (reference: _matrix.py ``col_stats``)."""
        lens = csr.row_lengths()
        data = {"count": lens}
        if csr.values is not None:
            sums = np.zeros(csr.nrows)
            np.add.at(sums, np.repeat(np.arange(csr.nrows), lens), csr.values)
            data["rating_count"] = lens
            data["mean_rating"] = np.where(lens > 0, sums / np.maximum(lens, 1), np.nan)
        ts = csr.fields.get("timestamp")
        if ts is not None and csr.nnz:
            rows = np.repeat(np.arange(csr.nrows), lens)
            first = np.full(csr.nrows, np.inf)
            last = np.full(csr.nrows, -np.inf)
            np.minimum.at(first, rows, ts)
            np.maximum.at(last, rows, ts)
            data["first_time"] = np.where(lens > 0, first, np.nan)
            data["last_time"] = np.where(lens > 0, last, np.nan)
        return pd.DataFrame(data, index=pd.Index(vocab.ids, name=vocab.name))


def _combine_repeats(rows, cols, attrs, combine):
    keys = rows.astype(np.int64) * (np.max(cols) + 1 if len(cols) else 1) + cols
    uniq, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    n = len(uniq)
    urows = np.zeros(n, dtype=np.int64)
    ucols = np.zeros(n, dtype=np.int64)
    urows[inv] = rows
    ucols[inv] = cols
    out_attrs = {}
    for name, vals in attrs.items():
        mode = combine
        if mode is None:
            mode = "last" if name == "timestamp" else ("sum" if name == "count" else "mean")
        if mode in ("mean", "sum"):
            acc = np.zeros(n, dtype=np.float64)
            np.add.at(acc, inv, vals.astype(np.float64))
            out = acc / counts if mode == "mean" else acc
        elif mode == "first":
            out = np.full(n, np.nan)
            # reverse so first occurrence wins
            out[inv[::-1]] = vals[::-1]
        else:  # last
            out = np.full(n, np.nan)
            out[inv] = vals
        out_attrs[name] = out.astype(vals.dtype if vals.dtype.kind == "f" else np.float64)
    return urows, ucols, out_attrs, counts.astype(np.int32)


class Dataset:
    """
    The LensKit-style dataset.  Construct with
    :class:`~lkpy_tpu_torch.data.builder.DatasetBuilder` or
    :func:`~lkpy_tpu_torch.data.adapt.from_interactions_df`.
    """

    def __init__(self, schema: DataSchema, entities: dict[str, EntitySet], tables: dict[str, pd.DataFrame]):
        self.schema = schema
        self._entities = entities
        self._tables = tables
        self._rel_cache: dict[str, RelationshipSet] = {}
        self._matrix_cache: dict[str, MatrixRelationshipSet] = {}

    @property
    def name(self) -> str | None:
        return self.schema.name

    def entities(self, name: str) -> EntitySet:
        if name not in self._entities:
            raise KeyError(f"no entity class {name!r}")
        return self._entities[name]

    @property
    def items(self) -> Vocabulary:
        return self.entities("item").vocabulary

    @property
    def users(self) -> Vocabulary:
        return self.entities("user").vocabulary

    @property
    def item_count(self) -> int:
        return len(self.items)

    @property
    def user_count(self) -> int:
        return len(self.users)

    def relationships(self, name: str) -> RelationshipSet:
        if name not in self._rel_cache:
            if name not in self.schema.relationships:
                raise KeyError(f"no relationship class {name!r}")
            self._rel_cache[name] = RelationshipSet(self, name, self.schema.relationships[name], self._tables[name])
        return self._rel_cache[name]

    @property
    def default_interaction_class(self) -> str:
        if self.schema.default_interaction:
            return self.schema.default_interaction
        inter = [n for n, r in self.schema.relationships.items() if r.interaction]
        if not inter:
            raise DataError("dataset has no interaction relationships")
        return inter[0]

    def interactions(self, name: str | None = None) -> RelationshipSet:
        return self.relationships(name or self.default_interaction_class)

    @property
    def interaction_count(self) -> int:
        return self.interactions().count()

    def interaction_matrix(self, name: str | None = None) -> MatrixRelationshipSet:
        key = name or self.default_interaction_class
        if key not in self._matrix_cache:
            self._matrix_cache[key] = self.relationships(key).matrix()
        return self._matrix_cache[key]

    def interaction_table(self, *, ids: bool = False) -> pd.DataFrame:
        """The default interaction records as a frame (reference:
        _dataset.py ``interaction_table``, its default pandas form)."""
        return self.interactions().pandas(ids=ids)

    def item_stats(self) -> pd.DataFrame:
        return self.interaction_matrix().col_stats()

    def user_stats(self) -> pd.DataFrame:
        return self.interaction_matrix().row_stats()

    def user_row(self, user_id=None, *, user_num: int | None = None) -> ItemList | None:
        """A user's interaction history as an ItemList."""
        return self.interaction_matrix().row_items(user_id, number=user_num)

    def __str__(self):
        return f"<Dataset {self.name or '?'} ({self.user_count} users, {self.item_count} items)>"

    __repr__ = __str__
