"""
The port's data layer: vocabularies, item lists and collections, CSR
matrices and datasets (port of ``lkpy_tpu.data``).
"""

from lkpy_tpu_torch.data.adapt import from_interactions_df, normalize_interactions_df
from lkpy_tpu_torch.data.builder import DatasetBuilder
from lkpy_tpu_torch.data.collection import ArrayTopNILC, ItemListCollection
from lkpy_tpu_torch.data.dataset import Dataset, EntitySet, MatrixRelationshipSet, RelationshipSet
from lkpy_tpu_torch.data.items import ItemList
from lkpy_tpu_torch.data.matrix import COO, CSR
from lkpy_tpu_torch.data.vocab import Vocabulary

__all__ = [
    "ArrayTopNILC",
    "COO",
    "CSR",
    "Dataset",
    "DatasetBuilder",
    "EntitySet",
    "ItemList",
    "ItemListCollection",
    "MatrixRelationshipSet",
    "RelationshipSet",
    "Vocabulary",
    "from_interactions_df",
    "normalize_interactions_df",
]
