"""
Dataset schema models.

Copy of ``lkpy_tpu/data/schema.py`` (reference:
src/lenskit/data/schema.py:138 ``DataSchema``): the same pydantic models, so
a schema means the same thing in both packages.
"""

from __future__ import annotations

from enum import Enum

from pydantic import BaseModel, Field

__all__ = ["AttrLayout", "ColumnSpec", "EntitySchema", "RelationshipSchema", "DataSchema", "id_col_name", "num_col_name"]

SCHEMA_VERSION = "2026.1"


def id_col_name(entity: str) -> str:
    return f"{entity}_id"


def num_col_name(entity: str) -> str:
    return f"{entity}_num"


class AttrLayout(str, Enum):
    SCALAR = "scalar"
    LIST = "list"
    VECTOR = "vector"
    SPARSE = "sparse"


class ColumnSpec(BaseModel):
    layout: AttrLayout = AttrLayout.SCALAR
    vector_size: int | None = None


class EntitySchema(BaseModel):
    id_type: str | None = None  # "int" | "str"
    attributes: dict[str, ColumnSpec] = Field(default_factory=dict)


class RelationshipSchema(BaseModel):
    entities: dict[str, str | None] = Field(default_factory=dict)  # alias -> entity class (None = same name)
    interaction: bool = False
    repeats: bool = False
    attributes: dict[str, ColumnSpec] = Field(default_factory=dict)

    @property
    def entity_classes(self) -> dict[str, str]:
        return {alias: cls if cls is not None else alias for alias, cls in self.entities.items()}


class DataSchema(BaseModel):
    version: str = SCHEMA_VERSION
    name: str | None = None
    default_interaction: str | None = None
    entities: dict[str, EntitySchema] = Field(default_factory=dict)
    relationships: dict[str, RelationshipSchema] = Field(default_factory=dict)
