"""
Key types for :class:`~lkpy_tpu_torch.data.ItemListCollection`
(reference: src/lenskit/data/_collection/_keys.py:19-120).

Collection keys are *named tuples* of entity IDs; key types for the same
field list are cached so equal field sets share a type, and generic key
types pickle by reconstruction.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any, NamedTuple, Sequence, TypeAlias

from lkpy_tpu_torch.data.types import ID

__all__ = [
    "GenericKey",
    "UserIDKey",
    "QueryIDKey",
    "KeySchema",
    "key_fields",
    "key_dict",
    "create_key",
    "create_key_type",
    "project_key",
]

GenericKey: TypeAlias = "tuple[ID, ...]"
"""A generic collection key: a (named) tuple of IDs."""


class UserIDKey(NamedTuple):
    """Key for collections keyed by user ID (recommendation runs, test data)."""

    user_id: ID


class QueryIDKey(NamedTuple):
    """Key for collections keyed by query ID."""

    query_id: ID


KeySchema: TypeAlias = "type[tuple] | tuple[str, ...]"

_KEY_CACHE: dict[tuple[str, ...], type[tuple]] = {
    ("user_id",): UserIDKey,
    ("query_id",): QueryIDKey,
}


def key_fields(kt: type[tuple]) -> tuple[str, ...]:
    """The field names of a key type."""
    return kt._fields  # type: ignore[attr-defined]


def key_dict(key: tuple) -> dict[str, Any]:
    """A key as a field→value dict."""
    return key._asdict()  # type: ignore[attr-defined]


def create_key(kt: type[tuple] | Sequence[str], *values: ID) -> tuple:
    """Instantiate a key of the given type (or field list)."""
    if isinstance(kt, type):
        return kt(*values)
    return create_key_type(*kt)(*values)


def create_key_type(*fields: str) -> type[tuple]:
    """Get (or create) the canonical named-tuple key type for these fields."""
    kt = _KEY_CACHE.get(fields)
    if kt is None:
        kt = namedtuple(f"LKKeyType{len(_KEY_CACHE) + 1}", fields)
        kt.__reduce__ = _reduce_generic_key  # type: ignore[method-assign]
        _KEY_CACHE[fields] = kt
    return kt


def _reduce_generic_key(key):
    return create_key, (key._fields, *key)


def project_key(key: tuple, target: type[tuple]) -> tuple:
    """
    Project a key onto a (subset) key type — e.g. look up test data keyed by
    user ID with a (user ID, sequence) run key.
    """
    if isinstance(key, target):
        return key
    try:
        return target._make(getattr(key, f) for f in target._fields)  # type: ignore[attr-defined]
    except AttributeError as e:
        raise TypeError(f"cannot project key {key!r} onto {target.__name__}: missing {e}") from None
