"""
Dataset: entities, relationships, and interaction matrices.

Port of ``lkpy_tpu/data/dataset.py`` (reference: src/lenskit/data/_dataset.py:63,
_entities.py:29, _relationships.py:40,410, _container.py:28): entity
vocabularies with their attributes, relationship tables, the de-duplicated
:class:`MatrixRelationshipSet` with its CSR, row access, statistics, SciPy
and Torch exports and host-side negative sampling, the lazy ``Dataset(thunk)``,
and ``save``/``load`` as a directory of Parquet tables and ``schema.json`` in
the JAX package's layout, so that either package reads the other's files.
"""

from __future__ import annotations

import threading
from os import PathLike
from pathlib import Path
from typing import Literal

import numpy as np
import pandas as pd
import pyarrow as pa
import scipy.sparse as sps
import torch

from lkpy_tpu_torch.data.items import ItemList
from lkpy_tpu_torch.data.matrix import COO, CSR
from lkpy_tpu_torch.data.schema import AttrLayout, ColumnSpec, DataSchema, RelationshipSchema, num_col_name
from lkpy_tpu_torch.data.vocab import Vocabulary
from lkpy_tpu_torch.diagnostics import DataError, FieldError

__all__ = ["Dataset", "DataContainer", "EntityAttribute", "EntitySet", "RelationshipSet", "MatrixRelationshipSet"]


class EntityAttribute:
    """One attribute column of an entity class: the IDs and numbers of the
    entities with its values (reference: data/_attributes.py:50)."""

    def __init__(self, name: str, vocabulary: Vocabulary, values: pd.Series):
        self.name = name
        self._vocab = vocabulary
        self._values = values

    @property
    def entity_class(self) -> str:
        return self._vocab.name or "entity"

    def ids(self) -> np.ndarray:
        return self._vocab.ids

    def numbers(self) -> np.ndarray:
        return np.arange(len(self._vocab), dtype=np.int32)

    def pandas(self) -> pd.Series:
        return self._values

    def numpy(self) -> np.ndarray:
        return self._values.to_numpy()

    def __len__(self) -> int:
        return len(self._values)

    def __repr__(self) -> str:
        return f"<EntityAttribute {self.entity_class}.{self.name} [{len(self)}]>"


class EntitySet:
    """A class of entities with its vocabulary and attributes (a frame
    indexed by entity number)."""

    def __init__(self, name: str, vocabulary: Vocabulary, attributes: pd.DataFrame | None = None):
        self.name = name
        self.vocabulary = vocabulary
        self._attributes = attributes if attributes is not None else pd.DataFrame(index=range(len(vocabulary)))

    @property
    def count(self) -> int:
        return len(self.vocabulary)

    def __len__(self) -> int:
        return len(self.vocabulary)

    def ids(self) -> np.ndarray:
        return self.vocabulary.ids

    def numbers(self) -> np.ndarray:
        return np.arange(len(self.vocabulary), dtype=np.int32)

    @property
    def attribute_names(self) -> list[str]:
        return list(self._attributes.columns)

    def attribute(self, name: str) -> pd.Series:
        if name not in self._attributes.columns:
            raise FieldError(self.name, name)
        return self._attributes[name]

    def attribute_set(self, name: str) -> EntityAttribute:
        """The attribute as an :class:`EntityAttribute` (IDs and values)."""
        return EntityAttribute(name, self.vocabulary, self.attribute(name))

    def pandas(self) -> pd.DataFrame:
        """The attributes with an ``<entity>_id`` column first."""
        df = self._attributes.copy()
        df.insert(0, f"{self.name}_id", self.vocabulary.ids)
        return df

    def select(self, *, ids=None, numbers=None) -> "EntitySet":
        if ids is not None:
            numbers = self.vocabulary.numbers(ids)
        numbers = np.asarray(numbers)
        sub_vocab = Vocabulary(self.vocabulary.id_array(numbers), self.name)
        return EntitySet(self.name, sub_vocab, self._attributes.iloc[numbers].reset_index(drop=True))


class RelationshipSet:
    """A set of relationship records between entity classes, stored as a
    table with ``<alias>_num`` columns plus attribute columns."""

    def __init__(self, dataset: "Dataset", name: str, schema: RelationshipSchema, table: pd.DataFrame):
        self._ds = dataset
        self.name = name
        self.schema = schema
        self._table = table

    @property
    def is_interaction(self) -> bool:
        return self.schema.interaction

    @property
    def entities(self) -> list[str]:
        return list(self.schema.entities.keys())

    @property
    def attribute_names(self) -> list[str]:
        return list(self.schema.attributes.keys())

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

    def arrow(self, **kwargs) -> pa.Table:
        return pa.Table.from_pandas(self.pandas(**kwargs), preserve_index=False)

    def matrix(self, *, combine: str | None = None) -> "MatrixRelationshipSet":
        """De-duplicated two-entity matrix view."""
        if len(self.entities) != 2:
            raise DataError(f"relationship {self.name!r} has {len(self.entities)} entities; matrix needs 2")
        return MatrixRelationshipSet(self._ds, self.name, self.schema, self._table, combine=combine)

    def co_occurrences(self, entity: str = "item", *, include_self: bool = False, dense: bool = False):
        """Co-occurrence counts of ``entity`` over the other entity's groups
        (reference: _relationships.py:144-163), e.g. item-by-item counts of
        the users who interacted with both: a SciPy COO array, or a dense
        NumPy matrix with ``dense=True``."""
        m = self.matrix()
        if entity == m.col_entity:
            sp = m.scipy(None)
        elif entity == m.row_entity:
            sp = m.scipy(None).T.tocsr()
        else:
            raise KeyError(f"relationship has no entity {entity!r}")
        sp = sp.astype(np.float32)
        sp.data[:] = 1.0
        cooc = (sp.T @ sp).tocoo()
        if not include_self:
            keep = cooc.row != cooc.col
            cooc = sps.coo_array((cooc.data[keep], (cooc.row[keep], cooc.col[keep])), shape=cooc.shape)
        if dense:
            return np.asarray(cooc.todense())
        return cooc

    def item_lists(self):
        return self.matrix().item_lists()


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

    @property
    def n_rows(self) -> int:
        return self._csr.nrows

    @property
    def n_cols(self) -> int:
        return self._csr.ncols

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

    def csr_structure(self) -> CSR:
        return self._csr.drop_values()

    def coo_structure(self) -> COO:
        return self._csr.drop_values().to_coo()

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

    def torch(self, attribute: str | None = None) -> torch.Tensor:
        """A CPU sparse CSR tensor with int64 indices, as the JAX package's."""
        m = self.scipy(attribute)
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)),
            torch.from_numpy(m.indices.astype(np.int64)),
            torch.from_numpy(m.data),
            size=m.shape,
        )

    def transpose(self) -> CSR:
        return self._csr.transpose()

    def row_items(self, id=None, *, number: int | None = None) -> ItemList | None:
        """One row as an ItemList."""
        if number is None:
            number = self.row_vocabulary.number(id, missing="negative")
            if number < 0:
                return None
        s, e = self._csr.row_extent(number)
        fields = {n: v[s:e] for n, v in self._csr.fields.items()}
        return ItemList(item_nums=self._csr.colind[s:e], vocabulary=self.col_vocabulary, **fields)

    def item_lists(self):
        from lkpy_tpu_torch.data.collection import ItemListCollection

        ilc = ItemListCollection([f"{self.row_entity}_id"])
        for rn in range(self.n_rows):
            ilc.add(self.row_items(number=rn), self.row_vocabulary.id(rn))
        return ilc

    def to_ilc(self):
        return self.item_lists()

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

    def sample_negatives(
        self,
        rows: np.ndarray,
        *,
        n: int = 1,
        weighting: Literal["uniform", "popularity"] = "uniform",
        verify: bool = True,
        rng: np.random.Generator | None = None,
        max_attempts: int = 50,
    ) -> np.ndarray:
        """
        Sample negative columns (items) for the given row (user) numbers on
        the host (reference: _relationships.py:725): uniform draws, or draws
        of a random entry's column (``"popularity"``), with every draw that
        is a positive of its row drawn again, up to ``max_attempts`` rounds
        (``verify``).  Returns (len(rows),) int32, or (len(rows), n) for
        n > 1.  The JAX package's NumPy path, draw for draw; its optional C++
        path is not ported.  The training samplers on the card are
        :mod:`lkpy_tpu_torch.ops.sampling`.
        """
        rng = rng if rng is not None else np.random.default_rng()
        rows = np.asarray(rows, dtype=np.int64)
        shape = (len(rows), n)
        if weighting == "popularity":
            def draw(size):
                return self._csr.colind[rng.integers(0, self._csr.nnz, size=size)].astype(np.int32)
        else:
            def draw(size):
                return rng.integers(0, self.n_cols, size=size, dtype=np.int32)
        out = draw(shape)
        if verify:
            for _ in range(max_attempts):
                bad = self._is_positive(rows[:, None], out)
                if not bad.any():
                    break
                out[bad] = draw(int(bad.sum()))
        return out if n > 1 else out[:, 0]

    def _is_positive(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Membership by a binary search of each sorted CSR row."""
        rows_b, cols_b = np.broadcast_arrays(rows, cols)
        starts = self._csr.rowptr[rows_b]
        ends = self._csr.rowptr[rows_b + 1]
        pos = starts + _searchsorted_rows(self._csr.colind, starts, ends, cols_b)
        pos_ok = pos < ends
        found = np.zeros(rows_b.shape, dtype=bool)
        found[pos_ok] = self._csr.colind[pos[pos_ok]] == cols_b[pos_ok]
        return found


def _searchsorted_rows(colind, starts, ends, targets):
    """Per-row binary search over CSR column indices (vectorized)."""
    lo = np.zeros_like(starts)
    hi = ends - starts
    while np.any(lo < hi):
        mid = (lo + hi) // 2
        active = lo < hi
        vals = colind[np.minimum(starts + mid, len(colind) - 1)]
        go_right = active & (vals < targets)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)
    return lo


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
    :class:`~lkpy_tpu_torch.data.builder.DatasetBuilder`,
    :func:`~lkpy_tpu_torch.data.adapt.from_interactions_df` or
    :meth:`load`.

    ``Dataset(thunk)`` is a lazy dataset: ``thunk()`` returns the real one,
    and runs once, under a lock, on the first access to the dataset's data.
    Pickling materializes it.
    """

    #: the data attributes of an eager dataset: only these materialize a
    #: lazy one, so probes of other names (``hasattr``, IPython's
    #: ``_repr_html_``) raise AttributeError without running the thunk
    _LAZY_DATA_ATTRS = frozenset({"schema", "_entities", "_tables", "_rel_cache", "_matrix_cache"})

    def __init__(self, schema, entities: dict[str, EntitySet] | None = None, tables: dict[str, pd.DataFrame] | None = None):
        if callable(schema) and entities is None and tables is None:
            object.__setattr__(self, "_lazy_thunk", schema)
            object.__setattr__(self, "_lazy_lock", threading.Lock())
            return
        if entities is None or tables is None:
            raise TypeError("Dataset needs (schema, entities, tables), or a single loader thunk")
        self.schema = schema
        self._entities = entities
        self._tables = tables
        self._rel_cache: dict[str, RelationshipSet] = {}
        self._matrix_cache: dict[str, MatrixRelationshipSet] = {}

    def __getstate__(self):
        # the thunk (often a closure) and its lock do not pickle, and the
        # receiver wants the data anyway
        if "_lazy_thunk" in self.__dict__:
            self.item_count
        return self.__dict__

    def __getattr__(self, name: str):
        # reached only for missing attributes, so only before a lazy
        # dataset materializes
        thunk = self.__dict__.get("_lazy_thunk")
        if thunk is None or name not in Dataset._LAZY_DATA_ATTRS:
            raise AttributeError(name)
        with self.__dict__["_lazy_lock"]:
            if "_lazy_thunk" in self.__dict__:  # not materialized by another thread meanwhile
                real = thunk()
                if not isinstance(real, Dataset):
                    raise TypeError(f"lazy dataset thunk returned {type(real)}, expected Dataset")
                # the data first, then the markers: a concurrent reader never
                # sees a half-cleared dict
                self.__dict__.update(real.__dict__)
                del self.__dict__["_lazy_thunk"]
                del self.__dict__["_lazy_lock"]
        return getattr(self, name)

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

    def interaction_table(self, *, format: Literal["pandas", "numpy", "arrow"] = "pandas", ids: bool = False):
        """The default interaction records: a frame, an Arrow table, or a
        dict of NumPy columns (``format="numpy"``)."""
        df = self.interactions().pandas(ids=ids)
        if format == "pandas":
            return df
        if format == "arrow":
            return pa.Table.from_pandas(df, preserve_index=False)
        return {c: df[c].to_numpy() for c in df.columns}

    def item_stats(self) -> pd.DataFrame:
        return self.interaction_matrix().col_stats()

    def user_stats(self) -> pd.DataFrame:
        return self.interaction_matrix().row_stats()

    def user_row(self, user_id=None, *, user_num: int | None = None) -> ItemList | None:
        """A user's interaction history as an ItemList."""
        return self.interaction_matrix().row_items(user_id, number=user_num)

    def save(self, path: str | PathLike) -> None:
        """Save as a directory of Parquet tables (one an entity class and
        one a relationship) and ``schema.json`` (reference: _container.py:72)."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "schema.json").write_text(self.schema.model_dump_json(indent=2))
        for name, es in self._entities.items():
            es.pandas().to_parquet(path / f"{name}.parquet", index=False)
        for name, tbl in self._tables.items():
            tbl.to_parquet(path / f"{name}.parquet", index=False)

    @classmethod
    def load(cls, path: str | PathLike) -> "Dataset":
        """Load a dataset saved by :meth:`save` (of either package)."""
        return DataContainer.load(path).dataset()

    def __str__(self):
        return f"<Dataset {self.name or '?'} ({self.user_count} users, {self.item_count} items)>"

    __repr__ = __str__


class DataContainer:
    """
    The stored form of a dataset: its schema and one table an entity class
    and a relationship (reference: data/_container.py:28).  :class:`Dataset`
    is the indexed view over a container.
    """

    def __init__(self, schema: DataSchema, tables: dict[str, pd.DataFrame]):
        self.schema = schema
        self.tables = tables

    @classmethod
    def from_dataset(cls, ds: Dataset) -> "DataContainer":
        tables = {name: es.pandas() for name, es in ds._entities.items()}
        tables.update(ds._tables)
        return cls(ds.schema, tables)

    def dataset(self) -> Dataset:
        """Index this container into a :class:`Dataset`."""
        entities = {}
        for name in self.schema.entities:
            df = self.tables[name]
            vocab = Vocabulary(df[f"{name}_id"].to_numpy(), name, reorder=False)
            entities[name] = EntitySet(name, vocab, df.drop(columns=[f"{name}_id"]))
        rels = {name: self.tables[name] for name in self.schema.relationships}
        return Dataset(self.schema, entities, rels)

    def save(self, path: str | PathLike) -> None:
        self.dataset().save(path)

    @classmethod
    def load(cls, path: str | PathLike) -> "DataContainer":
        path = Path(path)
        schema = DataSchema.model_validate_json((path / "schema.json").read_text())
        names = [*schema.entities, *schema.relationships]
        return cls(schema, {name: pd.read_parquet(path / f"{name}.parquet") for name in names})
