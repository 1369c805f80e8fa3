"""
RecQuery: recommendation request data.

Port of ``lkpy_tpu/data/query.py`` (reference: src/lenskit/data/_query.py:34).
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime
from typing import Any, TypeAlias

from lkpy_tpu_torch.data.items import ItemList

__all__ = ["RecQuery", "QueryInput", "QueryItemSource"]

QueryInput: TypeAlias = "RecQuery | int | str | ItemList | None"

QueryItemSource: TypeAlias = "str"
"""Valid sources for query items: ``"history" | "session" | "context"``
(reference: _query.py:23)."""


@dataclass(kw_only=True)
class RecQuery:
    """The inputs available for a recommendation request (except candidates)."""

    query_id: Any = None
    query_time: datetime | None = None
    user_id: Any = None
    user_items: ItemList | None = None
    "The user's interaction history, if known."

    @property
    def query_items(self) -> ItemList | None:
        """Alias for :attr:`user_items` (reference 2026.1 renamed the field)."""
        return self.user_items

    @classmethod
    def create(cls, data: QueryInput) -> "RecQuery":
        """Coerce an input (user ID, history ItemList, or query) to a query
        (reference: _query.py ``create``)."""
        if data is None:
            return cls()
        if isinstance(data, RecQuery):
            return data
        if isinstance(data, ItemList):
            return cls(user_items=data)
        return cls(user_id=data, query_id=data)
