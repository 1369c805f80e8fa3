"""
FlexMF: the flexible embedding-model family (explicit / logistic / BPR / WARP).

Port of ``lkpy_tpu/models/flexmf.py`` (reference: src/lenskit/flexmf/_base.py:34,
_model.py:18, _training.py:39, _explicit.py:38, _implicit.py:49,141,164,293;
losses :399-415): biased MF models trained by minibatch gradient descent
with configurable losses, negative-sampling strategies (uniform / popular /
misranked), presets (bpr / warp / lightgcn), and AdamW / L2 / no
regularization.

The parameters are a dict of float32 tensors on the training device (the
card unless ``TrainingOptions(device="cpu")``), as the JAX package's pytree
is; gradients come from autograd and ``optax.adam``/``adamw`` become
``torch.optim.Adam``/``AdamW`` with the same rate, decay, betas and eps,
updating the whole tables each step.  An epoch is a loop over its
steps (``train_step``, no host synchronization) and one readback of the
summed loss at the end.  The example order comes from the NumPy generator of
``TrainingOptions``, the same permutation as the JAX package's; initial
tables and negatives come from a ``torch.Generator`` on the training
device, whose stream differs from ``jax.random``'s (``load_parameters``
takes another trainer's tables).  Negatives and the WARP misranked search
run on the device (:mod:`lkpy_tpu_torch.ops.sampling`); convolution layers
go through :mod:`lkpy_tpu_torch.ops.graph`.

With ``TrainingOptions(mesh=)`` the tables are row-sharded over the mesh's
``model`` slots and each batch is split over its ``data`` slots
(:mod:`lkpy_tpu_torch.parallel.gradient`): the initial tables and each
step's negatives are drawn on the first slot exactly as without a mesh, so
a sharded run equals the unsharded one up to the order of its sums.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F
from pydantic import AliasChoices, BaseModel, Field, model_validator

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.config import EmbeddingSizeMixin
from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.logging.tracing import count, span
from lkpy_tpu_torch.ops.graph import propagate, sorted_conv
from lkpy_tpu_torch.ops.sampling import DeviceCSRIndex, sample_negatives
from lkpy_tpu_torch.ops.sparse import DeviceCOO
from lkpy_tpu_torch.parallel.gradient import leaves, place_tree, sharded_step_loss, take_rows, whole
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.random import int_seed
from lkpy_tpu_torch.training import ModelTrainer, TrainingOptions, UsesTrainer

__all__ = [
    "FlexMFConfigBase",
    "FlexMFExplicitConfig",
    "FlexMFExplicitScorer",
    "FlexMFImplicitConfig",
    "FlexMFImplicitScorer",
    "FlexMFScorerBase",
    "PRESETS",
    "init_params",
    "lightgcn_propagate",
    "model_scores",
]

ImplicitLoss = Literal["logistic", "pairwise", "warp"]
NegativeStrategy = Literal["uniform", "popular", "misranked"]

PRESETS = {
    "bpr": {"loss": "pairwise"},
    "warp": {"loss": "warp"},
    "lightgcn": {"loss": "pairwise", "convolution_layers": 2},
}


class FlexMFConfigBase(EmbeddingSizeMixin, BaseModel):
    """Common FlexMF configuration (reference: _base.py:34)."""

    embedding_size: int = Field(default=64, validation_alias=AliasChoices("embedding_size", "features"))
    batch_size: int = 8 * 1024
    learning_rate: float = 0.01
    epochs: int = 10
    regularization: float = 0.01
    reg_method: Literal["AdamW", "L2"] | None = "AdamW"


class FlexMFExplicitConfig(FlexMFConfigBase):
    """Explicit-feedback configuration (reference: _explicit.py:24)."""

    regularization: float = 0.1
    reg_method: Literal["AdamW", "L2"] | None = "L2"


class FlexMFImplicitConfig(FlexMFConfigBase):
    """Implicit-feedback configuration (reference: _implicit.py:49)."""

    preset: Literal["bpr", "warp", "lightgcn"] | None = None
    loss: ImplicitLoss = "logistic"
    negative_strategy: NegativeStrategy | None = None
    negative_count: int = 1
    positive_weight: float = 1.0
    user_bias: bool | None = None
    item_bias: bool = True
    convolution_layers: int = 0
    warp_candidates: int = 64
    "WARP misrank-search candidate budget per positive (the reference loops\n    up to MAX_TRIES=200 on the host; the search here is batched)."

    def selected_negative_strategy(self) -> NegativeStrategy:
        if self.negative_strategy is not None:
            return self.negative_strategy
        return "misranked" if self.loss == "warp" else "uniform"

    @model_validator(mode="before")
    @classmethod
    def apply_preset(cls, data):
        if isinstance(data, dict) and (preset := data.get("preset")):
            if preset not in PRESETS:
                raise ValueError(f"unknown preset {preset!r}")
            return PRESETS[preset] | data
        return data

    @model_validator(mode="after")
    def check_strategies(self):
        if self.loss == "warp" and self.negative_strategy not in (None, "misranked"):
            raise ValueError("WARP loss requires 'misranked' negative strategy")
        if self.selected_negative_strategy() == "misranked" and self.negative_count > 1:
            raise ValueError("misranked negatives only work with single negatives")
        return self


# ---------------------------------------------------------------------------
# model functions (a dict of tables; reference _model.py:18 FlexMFModel)
def init_params(
    generator: torch.Generator, n_users: int, n_items: int, k: int, user_bias: bool, item_bias: bool, scale=0.1
) -> dict[str, torch.Tensor]:
    """Normal initial tables ×``scale`` from ``generator``, on its device."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=generator.device) * scale

    params = {"u_embed": normal(n_users, k), "i_embed": normal(n_items, k)}
    if user_bias:
        params["u_bias"] = normal(n_users)
    if item_bias:
        params["i_bias"] = normal(n_items)
    return params


def model_scores(params, users, items, *, embeds=None):
    """Score user/item pairs: ``users`` (B,), ``items`` (B,) or (B, N).
    Returns the scores and the squared norms of the rows that made them.
    The tables may be row-sharded (:func:`~lkpy_tpu_torch.parallel.
    gradient.take_rows`); the rows come to ``users``' device."""
    u_embed = embeds[0] if embeds is not None else params["u_embed"]
    i_embed = embeds[1] if embeds is not None else params["i_embed"]
    ue = take_rows(u_embed, users)  # (B, k)
    ie = take_rows(i_embed, items)  # (B, k) or (B, N, k)
    wide = ie.dim() == 3
    if wide:
        score = torch.einsum("bk,bnk->bn", ue, ie)
        norm = torch.sum(ue * ue, dim=-1)[:, None] + torch.sum(ie * ie, dim=-1)
    else:
        score = torch.sum(ue * ie, dim=-1)
        norm = torch.sum(ue * ue, dim=-1) + torch.sum(ie * ie, dim=-1)
    if "u_bias" in params:
        ub = take_rows(params["u_bias"], users)
        if wide:
            ub = ub[:, None]
        score = score + ub
        norm = norm + ub**2
    if "i_bias" in params:
        ib = take_rows(params["i_bias"], items)
        score = score + ib
        norm = norm + ib**2
    return score, norm


def lightgcn_propagate(params, conv, layers: int):
    """LightGCN propagation: the mean of ``layers + 1`` normalized-adjacency
    convolutions (reference: _model.py layers / graphs/lightgcn.py)."""
    blend = np.full(layers + 1, 1.0 / (layers + 1), dtype=np.float32)
    return propagate(params["u_embed"], params["i_embed"], conv, blend)


def warp_negatives(cand_scores, cand_norms, pos_pred, n_items: int):
    """WARP's choice among ``C`` candidates a positive (reference:
    _implicit.py:293): the first candidate scored above the positive, else
    the best one; the rank estimated from the attempts it took gives the
    example's harmonic weight.  Returns the chosen score, its norm and the
    weight (outside the gradient)."""
    C = cand_scores.shape[1]
    better = cand_scores > pos_pred[:, None]
    any_better = better.any(dim=1)
    first = torch.where(better, torch.arange(C, device=better.device), C - 1).amin(dim=1)
    best = torch.argmax(cand_scores, dim=1)  # its first maximum
    chosen = torch.where(any_better, first, best)
    tries = torch.where(any_better, chosen + 1, C).to(torch.float32)
    neg_pred = cand_scores.gather(1, chosen[:, None])[:, 0]
    neg_norm = cand_norms.gather(1, chosen[:, None])[:, 0]
    ranks = (n_items - 1) / tries
    weights = torch.log(ranks) + np.euler_gamma + 1 / (2 * ranks) - 1 / (12 * ranks**2) + 1 / (120 * ranks**4)
    return neg_pred, neg_norm, weights.detach()


# ---------------------------------------------------------------------------
# scorers
def _f32(value, device) -> torch.Tensor:
    """A float32 table: a tensor stays where it is, an array goes to
    ``device`` (the card unless ``"cpu"``)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(torch.float32)
    return torch.tensor(np.asarray(value, dtype=np.float32), device=resolve_device(device))


class FlexMFScorerBase(UsesTrainer, Component):
    """Base scorer (reference: _base.py:98).  ``params`` holds the trained
    tables as float32 tensors where training left them."""

    config: FlexMFConfigBase

    users: Vocabulary
    items: Vocabulary
    params: dict[str, torch.Tensor]

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "params")

    @is_trained.setter
    def is_trained(self, v):
        pass

    @classmethod
    def from_numpy(
        cls,
        params: dict[str, np.ndarray],
        users: Vocabulary,
        items: Vocabulary,
        config: FlexMFConfigBase | dict | None = None,
        device: str | torch.device | None = None,
    ) -> "FlexMFScorerBase":
        """A scorer from the tables of the JAX package's ``get_parameters()``
        (``u_embed``, ``i_embed`` and any ``u_bias``/``i_bias``), on
        ``device`` (the card unless ``"cpu"``)."""
        scorer = cls(config)
        scorer.users = users
        scorer.items = items
        scorer.load_parameters(params, device=device)
        return scorer

    def score_offset(self) -> float:
        return 0.0

    def __call__(self, query: QueryInput, items: ItemList) -> ItemList:
        """Score ``items`` for one query where the tables lie and read the
        scores back once; unknown users and items score NaN."""
        query = RecQuery.create(query)
        user_num = None
        if query.user_id is not None:
            user_num = self.users.number(query.user_id, missing="negative")
        scores = np.full(len(items), np.nan, dtype=np.float32)
        if user_num is None or user_num < 0:
            return ItemList(items, scores=scores)
        item_nums = items.numbers(vocabulary=self.items, missing="negative")
        mask = item_nums >= 0
        p = self.params
        nums = torch.as_tensor(item_nums[mask].astype(np.int64), device=p["i_embed"].device)
        s = p["i_embed"][nums] @ p["u_embed"][user_num]
        if "u_bias" in p:
            s = s + p["u_bias"][user_num]
        if "i_bias" in p:
            s = s + p["i_bias"][nums]
        scores[mask] = (s + self.score_offset()).cpu().numpy()
        return ItemList(items, scores=scores)

    def get_parameters(self) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in self.params.items()}

    def load_parameters(self, state: dict[str, object], *, device: str | torch.device | None = None) -> None:
        """Install the tables: tensors keep their device, arrays go to
        ``device`` (the card unless ``"cpu"``)."""
        self.params = {k: _f32(v, device) for k, v in state.items()}


class FlexMFExplicitScorer(FlexMFScorerBase):
    """Biased-MF regression (reference: _explicit.py:38)."""

    config: FlexMFExplicitConfig
    global_bias: float

    @classmethod
    def from_numpy(cls, params, users, items, config=None, global_bias: float = 0.0, device=None):
        """As :meth:`FlexMFScorerBase.from_numpy`, with the JAX scorer's
        ``global_bias``."""
        scorer = super().from_numpy(params, users, items, config, device)
        scorer.global_bias = float(global_bias)
        return scorer

    def score_offset(self) -> float:
        return self.global_bias

    def create_trainer(self, data, options):
        return FlexMFExplicitTrainer(self, data, options)


class FlexMFImplicitScorer(FlexMFScorerBase):
    """Implicit-feedback scorer with logistic/BPR/WARP losses
    (reference: _implicit.py:141)."""

    config: FlexMFImplicitConfig

    def create_trainer(self, data, options):
        return FlexMFImplicitTrainer(self, data, options)


# ---------------------------------------------------------------------------
# trainers
def part_mean(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x``'s share of a mean over a batch of ``rows`` examples: its sum
    over the batch's count (``torch.mean(x)`` when ``x`` is the whole
    batch, a data slot's part of it when ``x`` is the slot's block)."""
    return x.sum() / (rows * math.prod(x.shape[1:]))


class FlexMFTrainerBase(ModelTrainer):
    """The batching and optimizer loop (reference: _training.py:39), which
    LightGCN's trainer shares.

    A step (:meth:`train_step`) takes the open epoch's next batch, draws its
    negatives (:meth:`draw_negatives`) and any propagated tables
    (:meth:`step_embeds`) once, then takes the loss of the batch
    (:meth:`block_loss`): whole, or with a mesh as the sum of each ``data``
    slot's part (:func:`~lkpy_tpu_torch.parallel.gradient.
    sharded_step_loss`), for one backward pass and one optimizer step.  The
    step is the span ``lkt.grad.step``, around ``lkt.grad.negatives``,
    ``lkt.grad.backward`` and ``lkt.grad.update``; the counter
    ``grad.examples`` adds the batch's rows
    (:mod:`lkpy_tpu_torch.logging.tracing`)."""

    def __init__(self, component: FlexMFScorerBase, data: Dataset, options: TrainingOptions):
        self.component = component
        self.config = component.config
        # the JAX package's order: the generator, then the integer seed
        # (drawn from it when the options hold a generator)
        self.rng = options.random_generator()
        self.mesh = options.mesh
        self.device = options.configured_device()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int_seed(options.rng))
        component.users = data.users
        component.items = data.items
        self.n_users = data.user_count
        self.n_items = data.item_count
        self.epochs_trained = 0
        self._batches = None  # the open epoch's batches, (steps, batch) a column
        self._cursor = 0  # the next batch of the open epoch
        self.last_batch: tuple[torch.Tensor, ...] = ()  # the last step's columns and negatives
        self.prepare_data(data)
        # drawn whole on the first slot, then split: the same tables with
        # a mesh and without
        self.load_parameters(self.init_model())

    def make_optimizer(self) -> torch.optim.Optimizer:
        cfg = self.config
        params = leaves(self.params)
        if cfg.reg_method == "AdamW":
            return torch.optim.AdamW(params, lr=cfg.learning_rate, weight_decay=cfg.regularization, fused=True)
        return torch.optim.Adam(params, lr=cfg.learning_rate, fused=True)

    @property
    def explicit_norm(self) -> bool:
        return self.config.reg_method == "L2"

    def prepare_data(self, data: Dataset):
        """Set :attr:`examples`, the :class:`DeviceCOO` the batches are
        drawn from, and whatever else the loss needs."""
        raise NotImplementedError

    def init_model(self) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def draw_negatives(self, users: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The batch's negatives, drawn once for the whole batch."""
        return ()

    def step_embeds(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The step's propagated tables on the first slot, or None."""
        return None

    def block_loss(self, embeds, rows: int, *block) -> torch.Tensor:
        """A block's part of the loss of a batch of ``rows`` examples: the
        block's columns, its negatives after them."""
        raise NotImplementedError

    def batch_loss(self, *cols) -> torch.Tensor:
        """The loss of one batch of examples, its negatives drawn here; the
        columns and negatives stay in :attr:`last_batch`."""
        with span("lkt.grad.negatives"):
            cols = cols + self.draw_negatives(cols[0])
        self.last_batch = cols
        loss = partial(self.block_loss, self.step_embeds(), cols[0].shape[0])
        if self.mesh is None:
            return loss(*cols)
        return sharded_step_loss(self.mesh, loss, cols)

    def batch_columns(self) -> tuple[torch.Tensor, ...]:
        """The example columns a batch takes its rows of."""
        return (self.examples.row, self.examples.col)

    def _epoch_perm(self):
        """The epoch's shuffled (and tail-padded) example order, the JAX
        package's call sequence on the same generator; with a mesh the
        batch rounds down to a multiple of the ``data`` slots, as there."""
        n = self.examples.nnz
        perm = self.rng.permutation(n)
        bs = min(self.config.batch_size, n)
        if self.mesh is not None:
            d = self.mesh.shape["data"]
            bs = max(d, bs - bs % d)
        tail = n % bs
        if tail:
            perm = np.concatenate([perm, self.rng.choice(n, size=bs - tail)])
        return perm, bs

    def _open_epoch(self) -> None:
        """Draw the next epoch's order and cut its batches on the device."""
        perm, bs = self._epoch_perm()
        perm_dev = torch.as_tensor(perm, device=self.device)
        self._batches = [col[perm_dev].view(-1, bs) for col in self.batch_columns()]
        self._cursor = 0

    def train_step(self) -> torch.Tensor:
        """One mini-batch step: the next batch of the open epoch (a new
        epoch's order drawn first when none is open), its loss, one backward
        pass and one optimizer step.  Returns the batch's loss as a device
        scalar, read by nothing here; the epoch counts as trained when its
        last batch is taken."""
        with span("lkt.grad.step"):
            if self._batches is None:
                self._open_epoch()
            cols = tuple(b[self._cursor] for b in self._batches)
            self._cursor += 1
            if self._cursor == self._batches[0].shape[0]:
                self._batches = None
                self.epochs_trained += 1
            count("grad.examples", cols[0].shape[0])
            self.opt.zero_grad()
            loss = self.batch_loss(*cols)
            with span("lkt.grad.backward"):
                loss.backward()
            with span("lkt.grad.update"):
                self.opt.step()
            return loss.detach()

    def train_epoch(self) -> float:
        """The steps left in the open epoch, or a whole new epoch; returns
        their mean batch loss, the only value read back."""
        if self._batches is None:
            self._open_epoch()
        n_steps = self._batches[0].shape[0] - self._cursor
        total = torch.zeros((), device=self.device)
        for _ in range(n_steps):
            total += self.train_step()
        return float(total) / n_steps if n_steps else 0.0

    def whole_params(self) -> dict[str, torch.Tensor]:
        """The tables, each whole on the first slot (differentiable)."""
        return {k: whole(v, self.device) for k, v in self.params.items()}

    def finalize(self):
        with torch.no_grad():
            self.component.params = {k: v.detach().clone() for k, v in self.final_params().items()}

    def final_params(self) -> dict[str, torch.Tensor]:
        return self.whole_params()

    def get_parameters(self) -> dict[str, np.ndarray]:
        """The tables as whole NumPy arrays, sharded or not: copies, which
        later steps leave as they are (the JAX package's are immutable)."""
        with torch.no_grad():
            return {k: v.to("cpu", copy=True).numpy() for k, v in self.whole_params().items()}

    def load_parameters(self, state: dict[str, object]) -> None:
        """Install tables (arrays, such as the JAX trainer's
        ``get_parameters()``, or tensors) on the training device, or on the
        mesh's shards, and start the optimizer afresh."""
        tables = {
            k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.array(v, dtype=np.float32)) for k, v in state.items()
        }
        self.params = place_tree(self.mesh, tables, {self.n_users, self.n_items}, self.device)
        self.opt = self.make_optimizer()


class FlexMFExplicitTrainer(FlexMFTrainerBase):
    def prepare_data(self, data: Dataset):
        csr = data.interaction_matrix().csr("rating")
        if csr.values is None:
            raise ValueError("explicit FlexMF requires ratings")
        mean = float(np.mean(csr.values))
        self.component.global_bias = mean
        self.examples = DeviceCOO.from_csr(csr.with_values(csr.values - mean), device=self.device)

    def init_model(self):
        return init_params(self.generator, self.n_users, self.n_items, self.config.embedding_size, True, True)

    def batch_columns(self):
        return (self.examples.row, self.examples.col, self.examples.values)

    def block_loss(self, embeds, rows, users, items, ratings):
        pred, norm = model_scores(self.params, users, items)
        loss = part_mean((pred - ratings) ** 2, rows)
        if self.explicit_norm:
            loss = loss + self.config.regularization * part_mean(norm, rows)
        return loss


class FlexMFImplicitTrainer(FlexMFTrainerBase):
    def prepare_data(self, data: Dataset):
        csr = data.interaction_matrix().csr(None)
        self.examples = DeviceCOO.from_csr(csr, None, device=self.device)
        self.neg_index = DeviceCSRIndex.from_csr(csr, device=self.device)
        self.conv = None
        if self.config.convolution_layers:
            coo = csr.to_coo()
            deg_u = np.maximum(np.diff(csr.rowptr), 1).astype(np.float32)
            deg_i = np.maximum(np.bincount(coo.col, minlength=self.n_items), 1).astype(np.float32)
            vals = (1.0 / np.sqrt(deg_u[coo.row] * deg_i[coo.col])).astype(np.float32)
            self.conv = sorted_conv(coo.row, coo.col, vals, self.n_users, self.n_items, device=self.device)

    def init_model(self):
        cfg = self.config
        user_bias = cfg.user_bias
        if user_bias is None:
            user_bias = cfg.loss == "logistic"
        return init_params(self.generator, self.n_users, self.n_items, cfg.embedding_size, user_bias, cfg.item_bias)

    def step_embeds(self):
        """The convolution layers' tables, propagated on the first slot over
        the whole tables (gathered from their shards with a mesh)."""
        if self.conv is None:
            return None
        return lightgcn_propagate(self.whole_params(), self.conv, self.config.convolution_layers)

    def final_params(self):
        params = self.whole_params()
        if self.conv is None:
            return params
        u_eff, i_eff = lightgcn_propagate(params, self.conv, self.config.convolution_layers)
        return params | {"u_embed": u_eff, "i_embed": i_eff}

    def draw_negatives(self, users):
        cfg = self.config
        strategy = cfg.selected_negative_strategy()
        if strategy == "misranked":
            return (sample_negatives(self.generator, self.neg_index, users, n=cfg.warp_candidates, weighting="uniform"),)
        weighting = "popularity" if strategy == "popular" else "uniform"
        return (sample_negatives(self.generator, self.neg_index, users, n=cfg.negative_count, weighting=weighting),)

    def block_loss(self, embeds, rows, users, pos, negs):
        cfg = self.config
        params = self.params
        pos_pred, pos_norm = model_scores(params, users, pos, embeds=embeds)
        neg_scores, neg_norms = model_scores(params, users, negs, embeds=embeds)
        if cfg.selected_negative_strategy() == "misranked":
            neg_pred, neg_norm, weights = warp_negatives(neg_scores, neg_norms, pos_pred, self.n_items)
            loss = part_mean(-F.logsigmoid(pos_pred - neg_pred) * weights, rows)
        else:
            neg_pred, neg_norm = neg_scores, neg_norms
            if cfg.loss == "logistic":
                pos_lp = -F.logsigmoid(pos_pred) * cfg.positive_weight
                neg_lp = -F.logsigmoid(-neg_pred)
                loss = (torch.sum(pos_lp) + torch.sum(neg_lp)) / (rows * (1 + neg_lp.shape[1]))
            else:  # pairwise / BPR
                loss = part_mean(-F.logsigmoid(pos_pred[:, None] - neg_pred), rows)
        if self.explicit_norm:
            loss = loss + cfg.regularization * 0.5 * (part_mean(pos_norm, rows) + part_mean(neg_norm, rows))
        return loss
