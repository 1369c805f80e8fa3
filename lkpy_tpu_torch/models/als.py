"""
Alternating least squares matrix factorization.

Port of ``lkpy_tpu/models/als.py`` (reference: src/lenskit/als/_common.py:
36,113,195, _explicit.py:32,94, _implicit.py:35,133): the ALS configs,
``BiasedMFScorer`` (explicit, bias-normalized) and ``ImplicitMFScorer`` (Hu
et al. confidence weighting) with their trainers, per-query scoring with
fold-in of a user's history (``user_embeddings`` ``True``/``False``/
``"prefer"``), and ``_fold_explicit_kernel``/``_fold_implicit_kernel``, the
fold-ins the batch serving engine runs on each block of users.

A scorer is a pipeline component (``topn_pipeline(ImplicitMFScorer())``)
and an ``nn.Module`` whose factor tables are buffers, so
``scorer.to(device)`` moves them.  ``scorer.train(data, options)`` trains it
on the card (unless ``TrainingOptions(device="cpu")``) and leaves its tables
there; each scorer's ``from_numpy`` builds one from parameters trained
elsewhere.  ``scorer.train(True)``/``scorer.eval()`` keep their
``nn.Module`` meaning.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
from pydantic import AliasChoices, BaseModel, Field
from torch import nn

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.config import EmbeddingSizeMixin, lkpy_tpu_config
from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.models.bias import BiasModel, entity_damping
from lkpy_tpu_torch.ops import als as als_ops
from lkpy_tpu_torch.ops.gather_rows import gather_rows
from lkpy_tpu_torch.ops.sparse import bucket_rows
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import ModelTrainer, TrainingOptions, UsesTrainer

__all__ = [
    "ALSBase",
    "ALSConfig",
    "ALSTrainerBase",
    "BiasedMFConfig",
    "BiasedMFScorer",
    "BiasedMFTrainer",
    "ImplicitMFConfig",
    "ImplicitMFScorer",
    "ImplicitMFTrainer",
    "UIPair",
]


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


def _fold_explicit_kernel(cols, vals, mask, i_emb, i_bias, gbias: float, damping: float, reg: float):
    """Vectorized explicit fold-in with bias removal
    (reference: als/_explicit.py:94 + _train_bias_row_cholesky:121).

    Args:
        cols: (B, H) int64 padded history item numbers.
        vals: (B, H) f32 ratings.
        mask: (B, H) bool validity.

    Returns:
        (user embeddings (B, k), damped user biases (B,)).  A row without
        history has a singular system (A = 0) and gets a non-finite
        embedding, as in the JAX package; the serving engine gives such a
        user an empty list.
    """
    m = mask.to(torch.float32)
    resid = (vals - gbias - i_bias[cols]) * m
    n_u = m.sum(dim=1)
    ub = resid.sum(dim=1) / (n_u + damping)
    resid = (resid - ub[:, None]) * m
    u = als_ops.solve_explicit_bucket(cols, resid, mask, i_emb, reg)
    return u, ub


class ALSConfig(EmbeddingSizeMixin, BaseModel):
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


def _f32(value, device: torch.device) -> torch.Tensor:
    """A float32 tensor of ``value`` on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(value, dtype=np.float32), device=device)


def _nums(table: torch.Tensor, nums: np.ndarray) -> torch.Tensor:
    """Row numbers of ``table`` as an int32 tensor on the table's device."""
    return torch.as_tensor(np.asarray(nums, dtype=np.int32), device=table.device)


class ALSBase(UsesTrainer, Component, nn.Module):
    """Base ALS scorer (reference: als/_common.py:113): a pipeline
    :class:`~lkpy_tpu_torch.pipeline.Component` and an ``nn.Module`` whose
    ``user_embeddings`` and ``item_embeddings`` are buffers.  Its
    ``__call__`` is the component's (one query), not ``nn.Module``'s."""

    config: ALSConfig
    users: Vocabulary | None
    items: Vocabulary | None

    def train(self, data=True, options: TrainingOptions | None = None):
        """Train on ``data`` with ``options`` (the JAX package's entry point,
        ``UsesTrainer.train``).  Called with a bool, as ``nn.Module.train``
        and ``eval()`` call it, it sets the module's training mode instead
        and returns the module."""
        if isinstance(data, bool):
            return nn.Module.train(self, data)
        UsesTrainer.train(self, data, options)

    @property
    def is_trained(self) -> bool:
        return self.item_embeddings is not None

    @is_trained.setter
    def is_trained(self, v):
        pass

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        """Score ``items`` for one query where the tables lie: the user's row
        of the table, or a fold-in of the query's history (``user_items``)
        unless ``user_embeddings="prefer"``; on the card the fold-in forms
        its normal equations from the history rows in one launch
        (``gather_gram``, in ``ops/als.py::solve_row_*``) and solves them
        (B2), the candidates' rows alone are gathered (P) and scored there,
        and only the scores come to the host.
        Unknown items, and every item for a user without row and history,
        score NaN."""
        query = RecQuery.create(query)
        user_num = None
        if query.user_id is not None and self.users is not None:
            user_num = self.users.number(query.user_id, missing="negative")
            if user_num < 0:
                user_num = None

        u_offset = None
        u_feat = None
        if query.user_items is not None and len(query.user_items) > 0 and self.config.user_embeddings != "prefer":
            u_feat, u_offset = self.new_user_embedding(user_num, query.user_items)

        if u_feat is None:
            if user_num is None or self.user_embeddings is None:
                return ItemList(items, scores=np.full(len(items), np.nan, dtype=np.float32))
            u_feat = self.user_embeddings[user_num]

        item_nums = items.numbers(vocabulary=self.items, missing="negative")
        mask = item_nums >= 0
        scores = np.full(len(items), np.nan, dtype=np.float32)
        rows = gather_rows(self.item_embeddings, _nums(self.item_embeddings, item_nums[mask]))
        scores[mask] = (rows @ u_feat).cpu().numpy()
        return self.finalize_scores(user_num, ItemList(items, scores=scores), u_offset)

    def new_user_embedding(self, user_num, items: ItemList) -> tuple[torch.Tensor | None, float | None]:
        """The fold-in of one query's history: ``(k,)`` embedding on the
        device of the tables (or None) and the user's bias offset (or None)."""
        raise NotImplementedError

    def finalize_scores(self, user_num, items: ItemList, user_bias: float | None) -> ItemList:
        return items

    def device_fold_in(self, cols, vals, mask):
        """
        Batched fold-in user embeddings for device batch scoring (the
        vectorized form of ``new_user_embedding``).

        Args:
            cols: (B, H) int64 padded history item numbers.
            vals: (B, H) f32 ratings (may be None for implicit data).
            mask: (B, H) bool validity.

        Returns:
            (user embeddings (B, k), per-user bias offsets (B,) or None).
        """
        kern, args = self.device_fold_kernel()
        args = tuple(torch.as_tensor(a, device=cols.device) if isinstance(a, np.ndarray) else a for a in args)
        return kern(cols, vals, mask, *args)

    def device_fold_kernel(self):
        """``(kernel_fn, args)`` for the batch serving engine: ``kernel_fn``
        takes a block's (cols, vals, mask) followed by ``args``, with any
        NumPy array among them brought to the block's device first."""
        raise NotImplementedError

    # ---- parameter container (reference: state/_container.py:14) ---------
    def get_parameters(self) -> dict[str, torch.Tensor | None]:
        return {"user_embeddings": self.user_embeddings, "item_embeddings": self.item_embeddings}

    def load_parameters(self, state: dict[str, object], *, device: str | torch.device | None = None) -> None:
        """Install ``user_embeddings`` (may be None) and ``item_embeddings``.
        Tensors keep their device; arrays go to ``device`` (the card unless
        ``device="cpu"``)."""
        for name in ("user_embeddings", "item_embeddings"):
            v = state[name]
            if v is not None:
                v = _f32(v, v.device if isinstance(v, torch.Tensor) else resolve_device(device))
            setattr(self, name, v)


class ALSTrainerBase(ModelTrainer):
    """Half-epoch ALS driver (reference: als/_common.py:195, train_epoch :241).

    The rows are bucketed and chunked once, on the ladder of the settings'
    ``training_perf.ladder_ratio``, and stay on the training device across
    epochs, with the factor tables.  ``epochs_trained`` counts the epochs
    and ``last_delta`` is the last epoch's update delta, a device scalar."""

    mode = "explicit"

    def __init__(self, scorer: ALSBase, data: Dataset, options: TrainingOptions):
        self.scorer = scorer
        self.config = scorer.config
        scorer.users = data.users
        scorer.items = data.items
        self.rng = options.random_generator()
        self.device = options.configured_device()
        self.epochs_trained = 0
        self.last_delta: torch.Tensor | None = None

        ui_csr = self.prepare_matrix(data)
        iu_csr = ui_csr.transpose()
        ratio = lkpy_tpu_config().training_perf.ladder_ratio
        self.u_buckets = als_ops.chunk_buckets(bucket_rows(ui_csr, field="rating", ratio=ratio), device=self.device)
        self.i_buckets = als_ops.chunk_buckets(bucket_rows(iu_csr, field="rating", ratio=ratio), device=self.device)

        # users first, then items: the JAX package draws them in this order
        k = self.config.embedding_size
        self.u_factors = _f32(self.initial_params(ui_csr.nrows, k), self.device)
        self.i_factors = _f32(self.initial_params(ui_csr.ncols, k), self.device)

    # subclass API ---------------------------------------------------------
    def prepare_matrix(self, data: Dataset):
        raise NotImplementedError

    def initial_params(self, nrows: int, ncols: int) -> np.ndarray:
        raise NotImplementedError

    # epoch loop -----------------------------------------------------------
    def train_epoch(self) -> torch.Tensor:
        """Both halves of one epoch; returns the update delta as a device
        scalar (also kept as ``last_delta``), so the host can queue the next
        epoch while this one runs."""
        self.u_factors, self.i_factors, du, di = als_ops.als_epoch(
            self.u_buckets,
            self.i_buckets,
            self.u_factors,
            self.i_factors,
            self.config.user_reg,
            self.config.item_reg,
            mode=self.mode,
        )
        self.epochs_trained += 1
        self.last_delta = du + di
        return self.last_delta

    def _half_epoch(self, side: str) -> float:
        if side == "user":
            self.u_factors, delta = als_ops.als_half_epoch(
                self.u_buckets, self.u_factors, self.i_factors, self.config.user_reg, mode=self.mode
            )
        else:
            self.i_factors, delta = als_ops.als_half_epoch(
                self.i_buckets, self.i_factors, self.u_factors, self.config.item_reg, mode=self.mode
            )
        return delta

    def finalize(self):
        self.scorer.item_embeddings = self.i_factors
        self.scorer.user_embeddings = self.u_factors if self.config.user_embeddings else None

    def get_parameters(self) -> dict[str, torch.Tensor]:
        return {"user_factors": self.u_factors.clone(), "item_factors": self.i_factors.clone()}

    def load_parameters(self, state: dict[str, object]) -> None:
        """Factor tables as tensors or arrays (the JAX trainer's
        ``get_parameters()`` too); they go to the training device."""
        self.u_factors = _f32(state["user_factors"], self.device)
        self.i_factors = _f32(state["item_factors"], self.device)


# ---------------------------------------------------------------------------
# explicit
class BiasedMFConfig(ALSConfig):
    damping: float | dict[str, float] = 5.0


class BiasedMFScorer(ALSBase):
    """Explicit-feedback biased MF (reference: als/_explicit.py:32).
    Buffers: ``user_embeddings`` (n_users, k) or None and ``item_embeddings``
    (n_items, k); ``bias`` is the :class:`BiasModel` the ratings were
    normalized with (NumPy arrays on the host)."""

    config: BiasedMFConfig
    bias: BiasModel

    def __init__(self, config: BiasedMFConfig | dict | None = None, **kwargs):
        nn.Module.__init__(self)
        Component.__init__(self, config, **kwargs)
        self.users = None
        self.items = None
        self.register_buffer("user_embeddings", None)
        self.register_buffer("item_embeddings", None)

    @classmethod
    def from_numpy(
        cls,
        params: dict[str, object],
        config: BiasedMFConfig | dict,
        users: Vocabulary,
        items: Vocabulary,
        device: str | torch.device | None = None,
    ) -> "BiasedMFScorer":
        """A scorer from trained parameters held as NumPy arrays, as the JAX
        package's ``BiasedMFScorer`` and its ``BiasModel`` hold them:
        ``user_embeddings`` (may be None), ``item_embeddings``,
        ``global_bias``, ``item_biases`` and ``user_biases``; the bias
        damping is the config's.  The tables go to ``device`` (the card
        unless ``device="cpu"``) as float32."""
        dev = resolve_device(device)
        scorer = cls(config)
        scorer.users = users
        scorer.items = items
        if params.get("item_embeddings") is None:
            raise ValueError("from_numpy needs item_embeddings")
        scorer.load_parameters(
            {"user_embeddings": params.get("user_embeddings"), "item_embeddings": params["item_embeddings"]}, device=dev
        )
        scorer.bias = BiasModel.from_numpy(params, scorer.config.damping, users, items)
        return scorer

    def create_trainer(self, data: Dataset, options: TrainingOptions) -> "BiasedMFTrainer":
        return BiasedMFTrainer(self, data, options)

    def new_user_embedding(self, user_num, items: ItemList):
        ratings = items.field("rating")
        if ratings is None:
            return None, None
        inums = items.numbers(vocabulary=self.items, missing="negative")
        mask = (inums >= 0) & np.isfinite(ratings)
        biases, u_bias = self.bias.compute_for_items(items, None, items)
        resid = torch.as_tensor(np.asarray((ratings - biases)[mask], dtype=np.float32), device=self.item_embeddings.device)
        u_feat = als_ops.solve_row_explicit(
            _nums(self.item_embeddings, inums[mask]), resid, self.item_embeddings, self.config.user_reg
        )
        return u_feat, u_bias

    def finalize_scores(self, user_num, items: ItemList, user_bias: float | None) -> ItemList:
        scores = items.scores()
        if user_bias is None:
            if user_num is not None and self.bias.user_biases is not None:
                user_bias = float(self.bias.user_biases[user_num])
            else:
                user_bias = 0.0
        biases = self.bias.compute_for_items(items, bias=user_bias)
        return ItemList(items, scores=scores + biases)

    def device_fold_in(self, cols, vals, mask):
        if vals is None:
            raise ValueError("explicit ALS fold-in requires ratings")
        return super().device_fold_in(cols, vals, mask)

    def device_fold_kernel(self):
        return _fold_explicit_kernel, (
            self.item_embeddings,
            self.bias.item_biases,
            float(self.bias.global_bias),
            entity_damping(self.bias.damping, "user"),
            float(self.config.user_reg),
        )


class BiasedMFTrainer(ALSTrainerBase):
    mode = "explicit"

    def prepare_matrix(self, data: Dataset):
        matrix = data.interaction_matrix()
        csr = matrix.csr("rating")
        if csr.values is None:
            raise ValueError("explicit ALS requires rating values")
        self.scorer.bias = BiasModel.learn(data, damping=self.config.damping, device=self.device)
        return self.scorer.bias.transform_matrix(csr)

    def initial_params(self, nrows: int, ncols: int) -> np.ndarray:
        mat = self.rng.standard_normal((nrows, ncols)).astype(np.float32)
        mat /= np.linalg.norm(mat, axis=1, keepdims=True)
        return mat


# ---------------------------------------------------------------------------
# implicit
class ImplicitMFConfig(ALSConfig):
    weight: float = 40.0
    use_ratings: bool = False


class ImplicitMFScorer(ALSBase):
    """Implicit-feedback MF, Hu et al. (reference: als/_implicit.py:35).
    Buffers: ``user_embeddings`` (n_users, k) or None, ``item_embeddings``
    (n_items, k) and ``_OtOr`` (k, k) = YᵀY + λI."""

    config: ImplicitMFConfig

    def __init__(self, config: ImplicitMFConfig | dict | None = None, **kwargs):
        nn.Module.__init__(self)
        Component.__init__(self, config, **kwargs)
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
                setattr(scorer, name, _f32(arr, dev))
        if scorer.item_embeddings is None or scorer._OtOr is None:
            raise ValueError("from_numpy needs item_embeddings and _OtOr")
        return scorer

    def create_trainer(self, data: Dataset, options: TrainingOptions) -> "ImplicitMFTrainer":
        return ImplicitMFTrainer(self, data, options)

    @property
    def fold_in_needs_ratings(self) -> bool:
        """Batch fold-in only needs rating values when confidences use them."""
        return self.config.use_ratings

    def new_user_embedding(self, user_num, user_items: ItemList):
        inums = user_items.numbers(vocabulary=self.items, missing="negative")
        good = inums >= 0
        if self.config.use_ratings:
            ratings = user_items.field("rating")
            if ratings is None:
                raise ValueError("no ratings in user items")
            conf = ratings[good] * self.config.weight
        else:
            conf = np.full(int(np.sum(good)), self.config.weight)
        dev = self.item_embeddings.device
        u_feat = als_ops.solve_row_implicit(
            _nums(self.item_embeddings, inums[good]),
            torch.as_tensor(np.asarray(conf, dtype=np.float32), device=dev),
            self.item_embeddings,
            self._OtOr,
        )
        return u_feat, None

    def device_fold_in(self, cols, vals, mask):
        if self.config.use_ratings and vals is None:
            raise ValueError("use_ratings=True requires rating values")
        if not self.config.use_ratings:
            vals = None  # flat confidence ignores any supplied ratings
        return super().device_fold_in(cols, vals, mask)

    def device_fold_kernel(self):
        return _fold_implicit_kernel, (self.item_embeddings, self._OtOr, float(self.config.weight))


class ImplicitMFTrainer(ALSTrainerBase):
    mode = "implicit"

    def prepare_matrix(self, data: Dataset):
        matrix = data.interaction_matrix()
        if self.config.use_ratings:
            csr = matrix.csr("rating")
            if csr.values is None:
                raise ValueError("use_ratings=True but no ratings present")
        else:
            csr = matrix.csr(None)
            csr = csr.with_values(np.ones(csr.nnz, dtype=np.float32))
        return csr.with_values(csr.values * self.config.weight)

    def initial_params(self, nrows: int, ncols: int) -> np.ndarray:
        mat = self.rng.standard_normal((nrows, ncols)).astype(np.float32) * 0.01
        return mat * mat

    def finalize(self):
        # OtOr is only needed for fold-in scoring, so it is computed here and
        # not every epoch
        super().finalize()
        self.scorer._OtOr = als_ops.implicit_otor(self.i_factors, self.config.user_reg)
