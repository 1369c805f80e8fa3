"""
LightGCN graph recommender (He et al. 2020).

Port of ``lkpy_tpu/models/lightgcn.py`` (reference: src/lenskit/graphs/lightgcn.py:
42,108,186,312,319, which wraps ``torch_geometric.nn.LightGCN``): the
embeddings propagate over the symmetric-normalized interaction graph
(:func:`lkpy_tpu_torch.ops.graph.propagate`, sparse products on the training
device in both directions, forward and backward), with BPR or logistic
loss, negatives verified against the interactions on the device, and an
L2 penalty on the batch's ego embeddings, trained with Adam.

Each step is one loss (the propagated loss and the ego-regularization term
together) and one backward pass.  The JAX package splits large graphs'
steps into two programs to get round a TPU compiler failure; the gradient
is the sum of the same two terms.  The epoch loop, the generators and the
parameter container are FlexMF's (:class:`lkpy_tpu_torch.models.flexmf.
FlexMFTrainerBase`), and so is the mesh: with ``TrainingOptions(mesh=)``
the tables are row-sharded over the ``model`` slots, each step propagates
on the first slot over the tables gathered from their shards, and the
batch splits over the ``data`` slots.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F
from pydantic import AliasChoices, BaseModel, Field, model_validator

from lkpy_tpu_torch.config import EmbeddingSizeMixin
from lkpy_tpu_torch.data import Dataset, ItemList, QueryInput, RecQuery, Vocabulary
from lkpy_tpu_torch.models.flexmf import FlexMFTrainerBase, _f32, init_params, part_mean
from lkpy_tpu_torch.ops.graph import propagate, sorted_conv
from lkpy_tpu_torch.ops.sampling import DeviceCSRIndex, sample_negatives
from lkpy_tpu_torch.ops.sparse import DeviceCOO
from lkpy_tpu_torch.parallel.gradient import leaves, take_rows
from lkpy_tpu_torch.pipeline.components import Component
from lkpy_tpu_torch.training import UsesTrainer

__all__ = ["LightGCNConfig", "LightGCNScorer"]


class LightGCNConfig(EmbeddingSizeMixin, BaseModel):
    """Configuration (reference: graphs/lightgcn.py:42)."""

    embedding_size: int = Field(default=16, validation_alias=AliasChoices("embedding_size", "features"))
    layer_count: int = 2
    layer_blend: float | list[float] | None = None
    batch_size: int = 4 * 1024
    learning_rate: float = 0.01
    epochs: int = 10
    regularization: float | None = 0.01
    loss: Literal["logistic", "pairwise"] = "pairwise"

    @model_validator(mode="after")
    def check_layer_blending(self):
        if isinstance(self.layer_blend, list) and len(self.layer_blend) != self.layer_count:
            raise ValueError("layer_blend length must equal layer_count")
        return self

    def blend_weights(self) -> np.ndarray:
        k = self.layer_count
        if self.layer_blend is None:
            return np.full(k + 1, 1.0 / (k + 1), dtype=np.float32)
        if isinstance(self.layer_blend, list):
            return np.asarray([1.0] + list(self.layer_blend), dtype=np.float32) / (k + 1)
        return np.full(k + 1, self.layer_blend, dtype=np.float32)


class LightGCNScorer(UsesTrainer, Component):
    """LightGCN scorer (reference: graphs/lightgcn.py:108).  The propagated
    ``user_embeddings`` and ``item_embeddings`` are float32 tensors where
    training left them."""

    config: LightGCNConfig

    users: Vocabulary
    items: Vocabulary
    user_embeddings: torch.Tensor
    item_embeddings: torch.Tensor

    @property
    def is_trained(self) -> bool:
        return hasattr(self, "item_embeddings")

    @is_trained.setter
    def is_trained(self, v):
        pass

    @classmethod
    def from_numpy(
        cls,
        params: dict[str, np.ndarray],
        users: Vocabulary,
        items: Vocabulary,
        config: LightGCNConfig | dict | None = None,
        device: str | torch.device | None = None,
    ) -> "LightGCNScorer":
        """A scorer from the JAX scorer's ``get_parameters()``
        (``user_embeddings``, ``item_embeddings``), on ``device`` (the card
        unless ``"cpu"``)."""
        scorer = cls(config)
        scorer.users = users
        scorer.items = items
        scorer.load_parameters(params, device=device)
        return scorer

    def create_trainer(self, data, options):
        return LightGCNTrainer(self, data, options)

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
        nums = torch.as_tensor(item_nums[mask].astype(np.int64), device=self.item_embeddings.device)
        scores[mask] = (self.item_embeddings[nums] @ self.user_embeddings[user_num]).cpu().numpy()
        return ItemList(items, scores=scores)

    def get_parameters(self) -> dict[str, np.ndarray]:
        return {"user_embeddings": self.user_embeddings.cpu().numpy(), "item_embeddings": self.item_embeddings.cpu().numpy()}

    def load_parameters(self, state: dict[str, object], *, device: str | torch.device | None = None) -> None:
        """Install the tables: tensors keep their device, arrays go to
        ``device`` (the card unless ``"cpu"``)."""
        for name in ("user_embeddings", "item_embeddings"):
            setattr(self, name, _f32(state[name], device))


class LightGCNTrainer(FlexMFTrainerBase):
    """Trainer (reference: lightgcn.py:186; BPR/logistic at :312,319)."""

    def prepare_data(self, data: Dataset):
        csr = data.interaction_matrix().csr(None)
        coo = csr.to_coo()
        self.examples = DeviceCOO.from_csr(csr, None, device=self.device)
        self.neg_index = DeviceCSRIndex.from_csr(csr, device=self.device)
        deg_u = np.maximum(np.diff(csr.rowptr), 1).astype(np.float32)
        deg_i = np.maximum(np.bincount(coo.col, minlength=self.n_items), 1).astype(np.float32)
        vals = (1.0 / np.sqrt(deg_u[coo.row] * deg_i[coo.col])).astype(np.float32)
        self.conv = sorted_conv(coo.row, coo.col, vals, self.n_users, self.n_items, device=self.device)
        self.blend = self.config.blend_weights()

    def init_model(self):
        return init_params(self.generator, self.n_users, self.n_items, self.config.embedding_size, False, False)

    def make_optimizer(self) -> torch.optim.Optimizer:
        return torch.optim.Adam(leaves(self.params), lr=self.config.learning_rate, fused=True)

    def step_embeds(self):
        """The propagated tables, on the first slot over the whole tables
        (gathered from their shards with a mesh)."""
        params = self.whole_params()
        return propagate(params["u_embed"], params["i_embed"], self.conv, self.blend)

    def draw_negatives(self, users):
        return (sample_negatives(self.generator, self.neg_index, users, n=1)[:, 0],)

    def block_loss(self, embeds, rows, users, pos, negs) -> torch.Tensor:
        """A block's part of the batch's loss: BPR or logistic on the
        propagated embeddings, plus the L2 penalty on the batch's ego
        embeddings, each divided by the batch's size ``rows``."""
        cfg = self.config
        params = self.params
        u_eff, i_eff = embeds
        ue = take_rows(u_eff, users)
        pos_s = torch.sum(ue * take_rows(i_eff, pos), dim=-1)
        neg_s = torch.sum(ue * take_rows(i_eff, negs), dim=-1)
        if cfg.loss == "pairwise":
            loss = -part_mean(F.logsigmoid(pos_s - neg_s), rows)
        else:
            loss = -0.5 * (part_mean(F.logsigmoid(pos_s), rows) + part_mean(F.logsigmoid(-neg_s), rows))
        if cfg.regularization:
            n0 = (
                torch.sum(take_rows(params["u_embed"], users) ** 2)
                + torch.sum(take_rows(params["i_embed"], pos) ** 2)
                + torch.sum(take_rows(params["i_embed"], negs) ** 2)
            ) / rows
            loss = loss + cfg.regularization * 0.5 * n0
        return loss

    def finalize(self):
        with torch.no_grad():
            u_eff, i_eff = self.step_embeds()
        self.component.user_embeddings = u_eff
        self.component.item_embeddings = i_eff
