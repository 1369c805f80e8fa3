"""
Alternating least squares matrix factorization: implicit-feedback serving.

Port of the serving part of ``lkpy_tpu/models/als.py`` (reference:
src/lenskit/als/_common.py:36,113, _implicit.py:35,133): the ALS configs,
``ImplicitMFScorer`` with batched fold-in of user histories and
``user_embeddings="prefer"``, and ``_fold_implicit_kernel``, the fold-in the
batch serving engine runs on each block of users.

The scorer is an ``nn.Module`` whose factor tables are buffers, so
``scorer.to(device)`` moves them.  It is built from trained parameters with
:meth:`ImplicitMFScorer.from_numpy`.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
from pydantic import AliasChoices, BaseModel, Field
from torch import nn

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data import Vocabulary
from lkpy_tpu_torch.ops import als as als_ops

__all__ = ["ALSConfig", "ImplicitMFConfig", "ImplicitMFScorer", "UIPair"]


class UIPair(BaseModel):
    """Separate user/item values."""

    user: float
    item: float


def _fold_implicit_kernel(cols, vals, mask, i_emb, OtOr, weight: float):
    """Vectorized implicit fold-in (reference: als/_implicit.py:133).

    Args:
        cols: (B, H) int64 padded history item numbers.
        vals: (B, H) f32 ratings, or None for flat confidence.
        mask: (B, H) bool validity.

    Returns:
        (user embeddings (B, k), None): implicit MF has no user bias, so the
        serving engine adds none (the JAX kernel returns zeros here).
    """
    m = mask.to(torch.float32)
    conf = (weight * m) if vals is None else (vals * weight * m)
    u = als_ops.solve_implicit_bucket(cols, conf, mask, i_emb, OtOr)
    return u, None


class ALSConfig(BaseModel):
    """ALS configuration (reference: als/_common.py:36)."""

    embedding_size: int = Field(default=64, validation_alias=AliasChoices("embedding_size", "features"))
    epochs: int = 10
    regularization: float | UIPair = 0.1
    user_embeddings: bool | Literal["prefer"] = True

    @property
    def user_reg(self) -> float:
        if isinstance(self.regularization, UIPair):
            return self.regularization.user
        return self.regularization

    @property
    def item_reg(self) -> float:
        if isinstance(self.regularization, UIPair):
            return self.regularization.item
        return self.regularization


class ImplicitMFConfig(ALSConfig):
    weight: float = 40.0
    use_ratings: bool = False


class ImplicitMFScorer(nn.Module):
    """Implicit-feedback MF, Hu et al. (reference: als/_implicit.py:35), for
    batch serving.  Buffers: ``user_embeddings`` (n_users, k) or None,
    ``item_embeddings`` (n_items, k) and ``_OtOr`` (k, k) = YᵀY + λI."""

    config: ImplicitMFConfig
    users: Vocabulary | None
    items: Vocabulary | None

    def __init__(self, config: ImplicitMFConfig | dict | None = None, **kwargs):
        super().__init__()
        if config is not None and kwargs:
            raise TypeError("pass a config object or keyword args, not both")
        if config is None:
            config = ImplicitMFConfig.model_validate(kwargs)
        elif isinstance(config, dict):
            config = ImplicitMFConfig.model_validate(config)
        elif not isinstance(config, ImplicitMFConfig):
            raise TypeError(f"invalid config of type {type(config)}, expected ImplicitMFConfig")
        self.config = config
        self.users = None
        self.items = None
        self.register_buffer("user_embeddings", None)
        self.register_buffer("item_embeddings", None)
        self.register_buffer("_OtOr", None)

    @classmethod
    def from_numpy(
        cls,
        params: dict[str, np.ndarray | None],
        config: ImplicitMFConfig | dict,
        users: Vocabulary | None,
        items: Vocabulary,
        device: str | torch.device | None = None,
    ) -> "ImplicitMFScorer":
        """A scorer from trained parameters held as NumPy arrays, as the JAX
        package's ``ImplicitMFScorer`` holds them: ``user_embeddings`` (None
        for a model trained with ``user_embeddings=False``, which batch
        serving refuses, as the JAX package does), ``item_embeddings`` and
        ``_OtOr``.  The tables go to ``device`` (the card unless
        ``device="cpu"``) as float32."""
        dev = resolve_device(device)
        scorer = cls(config)
        scorer.users = users
        scorer.items = items
        for name in ("user_embeddings", "item_embeddings", "_OtOr"):
            arr = params.get(name)
            if arr is not None:
                setattr(scorer, name, torch.tensor(np.asarray(arr, dtype=np.float32), device=dev))
        if scorer.item_embeddings is None or scorer._OtOr is None:
            raise ValueError("from_numpy needs item_embeddings and _OtOr")
        return scorer

    @property
    def fold_in_needs_ratings(self) -> bool:
        """Batch fold-in only needs rating values when confidences use them."""
        return self.config.use_ratings

    def device_fold_kernel(self):
        """``(kernel_fn, args)`` for the batch serving engine: ``kernel_fn``
        takes a block's (cols, vals, mask) followed by ``args``."""
        return _fold_implicit_kernel, (self.item_embeddings, self._OtOr, float(self.config.weight))
