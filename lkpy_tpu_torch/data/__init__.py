"""
The port's data layer: vocabularies, item lists and collections, CSR
matrices, datasets with entity attributes, their builder and their Parquet
storage (port of ``lkpy_tpu.data``).
"""

from lkpy_tpu_torch.data.adapt import from_interactions_df, normalize_interactions_df
from lkpy_tpu_torch.data.builder import DatasetBuilder
from lkpy_tpu_torch.data.collection import (
    ArrayTopNILC,
    ItemListCollection,
    ItemListCollector,
    ListILC,
    MutableItemListCollection,
)
from lkpy_tpu_torch.data.dataset import (
    DataContainer,
    Dataset,
    EntityAttribute,
    EntitySet,
    MatrixRelationshipSet,
    RelationshipSet,
)
from lkpy_tpu_torch.data.items import ItemList
from lkpy_tpu_torch.data.keys import GenericKey, QueryIDKey, UserIDKey, create_key_type, key_dict, project_key
from lkpy_tpu_torch.data.matrix import COO, CSR
from lkpy_tpu_torch.data.query import QueryInput, QueryItemSource, RecQuery
from lkpy_tpu_torch.data.schema import AttrLayout, ColumnSpec, DataSchema, EntitySchema, RelationshipSchema
from lkpy_tpu_torch.data.types import ID, NPID, FeedbackType
from lkpy_tpu_torch.data.vocab import Vocabulary
from lkpy_tpu_torch.diagnostics import FieldError

__all__ = [
    "ArrayTopNILC",
    "AttrLayout",
    "COO",
    "CSR",
    "ColumnSpec",
    "DataContainer",
    "DataSchema",
    "Dataset",
    "DatasetBuilder",
    "EntityAttribute",
    "EntitySchema",
    "EntitySet",
    "FeedbackType",
    "FieldError",
    "GenericKey",
    "ID",
    "ItemList",
    "ItemListCollection",
    "ItemListCollector",
    "ListILC",
    "MatrixRelationshipSet",
    "MutableItemListCollection",
    "NPID",
    "QueryIDKey",
    "QueryInput",
    "QueryItemSource",
    "RecQuery",
    "RelationshipSchema",
    "RelationshipSet",
    "UserIDKey",
    "Vocabulary",
    "create_key_type",
    "from_interactions_df",
    "key_dict",
    "normalize_interactions_df",
    "project_key",
]
