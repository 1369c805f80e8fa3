"""
Nested-dict flatten/unflatten helpers (port of ``lkpy_tpu/data/flatten.py``;
reference: src/lenskit/data/_flatten.py:14).  The tuner turns dotted search
keys such as ``regularization.user`` into nested configs with them.
"""

from __future__ import annotations

from typing import Any

__all__ = ["flatten_dict", "unflatten_dict"]


def flatten_dict(data: dict[str, Any]) -> dict[str, Any]:
    """Flatten nested dicts into dotted keys: ``{"a": {"b": 1}} → {"a.b": 1}``."""
    out: dict[str, Any] = {}
    stack = [("", data)]
    while stack:
        prefix, d = stack.pop()
        for key, value in d.items():
            fk = prefix + key
            if isinstance(value, dict):
                stack.append((fk + ".", value))
            else:
                out[fk] = value
    return out


def unflatten_dict(data: dict[str, Any], *, sep: str = ".") -> dict[str, Any]:
    """Inverse of :func:`flatten_dict`."""
    out: dict[str, Any] = {}
    for key, value in data.items():
        parts = key.split(sep)
        tgt = out
        for k in parts[:-1]:
            tgt = tgt.setdefault(k, {})
        tgt[parts[-1]] = value
    return out
