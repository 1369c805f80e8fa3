"""
Configuration helpers shared by the port's component configs (port of
``lkpy_tpu/config/__init__.py``; reference: src/lenskit/config/common.py).

Only :class:`EmbeddingSizeMixin` is ported so far.
"""

from __future__ import annotations

from pydantic import model_validator

__all__ = ["EmbeddingSizeMixin"]


class EmbeddingSizeMixin:
    """Power-of-two embedding-size sugar (reference: config/common.py:16
    ``EmbeddingSizeMixin``): configs accept ``embedding_size_exp`` to set
    ``embedding_size = 2**exp`` for hyperparameter sweeps."""

    @model_validator(mode="before")
    @classmethod
    def _apply_embedding_exp(cls, data):
        if isinstance(data, dict) and "embedding_size_exp" in data:
            data = dict(data)
            exp = data.pop("embedding_size_exp")
            data.setdefault("embedding_size", 2 ** int(exp))
        return data
