"""The gradient trainers' step (``FlexMFTrainerBase.train_step``) on the CPU:
the epoch is the loop over it, the step keeps its batch in ``last_batch``
and records its spans and counters, and LightGCN's step agrees with the
plain reference of the benchmark (``portbench/reference/lightgcn.py``,
float64, written out without autograd).

Tolerances of the reference comparison, float32 against float64 on 60 users
× 40 items with k = 8 and K = 3: the propagated tables within 1e-6 relative
Frobenius (each entry sums at most 40 products a layer over three layers, at
float32's unit roundoff 6e-8); the ego gradients within 1e-5 (the loss's
gradient through the same three layers back, from sums over the batch);
the tables' change over three Adam steps within 1e-4 (Adam divides each
gradient by its running root mean square, so a gradient's relative error
becomes the update's, and is larger where a gradient nearly cancels); the
losses within 1e-6.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.logging import counts, record_spans, take_spans
from lkpy_tpu_torch.models import FlexMFImplicitScorer, LightGCNScorer
from lkpy_tpu_torch.ops.sampling import DeviceCSRIndex, csr_contains
from lkpy_tpu_torch.training import TrainingOptions
from portbench.core.compare import relative_gap
from portbench.reference import lightgcn as ref

torch.set_num_threads(1)

CPU = TrainingOptions(rng=42, device="cpu")
SPANS = {"lkt.grad.step", "lkt.grad.negatives", "lkt.graph.propagate", "lkt.grad.backward", "lkt.grad.update"}


def _dataset(seed=0, n_users=60, n_items=40):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 12, n_users)
    users = np.repeat(np.arange(n_users), lens)
    items = np.concatenate([rng.choice(n_items, size=n, replace=False) for n in lens])
    return from_interactions_df(pd.DataFrame({"user_id": users, "item_id": items}))


MAKERS = {
    "bpr": lambda: FlexMFImplicitScorer(preset="bpr", embedding_size=8, batch_size=64),
    "lightgcn": lambda: LightGCNScorer(embedding_size=8, layer_count=3, batch_size=64),
}


@pytest.mark.parametrize("model", sorted(MAKERS))
def test_epoch_is_the_loop_over_steps(model):
    ds = _dataset()
    by_epoch = MAKERS[model]().create_trainer(ds, CPU)
    by_step = MAKERS[model]().create_trainer(ds, CPU)
    for epoch in range(2):
        want = by_epoch.train_epoch()
        losses = []
        while by_step.epochs_trained == epoch:
            losses.append(by_step.train_step())
        total = torch.zeros(())
        for loss in losses:
            total += loss
        assert float(total) / len(losses) == want
        assert by_step.epochs_trained == by_epoch.epochs_trained == epoch + 1
        for name, table in by_epoch.get_parameters().items():
            np.testing.assert_array_equal(by_step.get_parameters()[name], table, err_msg=name)


@pytest.mark.parametrize("model", sorted(MAKERS))
def test_epoch_finishes_an_open_epoch(model):
    ds = _dataset(1)
    whole = MAKERS[model]().create_trainer(ds, CPU)
    split = MAKERS[model]().create_trainer(ds, CPU)
    whole.train_epoch()
    split.train_step()
    split.train_step()
    split.train_epoch()
    assert split.epochs_trained == 1
    for name, table in whole.get_parameters().items():
        np.testing.assert_array_equal(split.get_parameters()[name], table, err_msg=name)


@pytest.mark.parametrize("model", sorted(MAKERS))
def test_last_batch_holds_the_step_columns_and_negatives(model):
    ds = _dataset(2)
    trainer = MAKERS[model]().create_trainer(ds, CPU)
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    loss = trainer.train_step()
    users, pos, neg = trainer.last_batch
    assert users.shape == pos.shape == (64,) and neg.shape[0] == 64
    index = DeviceCSRIndex.from_csr(ds.interaction_matrix().csr(None), bloom=False, device="cpu")
    assert bool(csr_contains(index, users, pos).all())
    assert not bool(csr_contains(index, users.reshape(64, *[1] * (neg.dim() - 1)), neg).any())
    # the loss the step returned is that of these columns on the tables before it
    after = trainer.params
    trainer.params = before
    try:
        with torch.no_grad():
            again = trainer.block_loss(trainer.step_embeds(), 64, users, pos, neg)
    finally:
        trainer.params = after
    assert float(again) == float(loss)


@pytest.mark.parametrize("model", sorted(MAKERS))
def test_a_step_records_its_spans_and_counters(model):
    ds = _dataset(3)
    trainer = MAKERS[model]().create_trainer(ds, CPU)
    nnz = ds.interaction_matrix().csr(None).nnz
    take_spans()
    before = counts()
    with record_spans():
        trainer.train_step()
    after = counts()
    names = {s.name for s in take_spans()}
    products = 12 if model == "lightgcn" else 0  # 3 layers, two directions, forward and backward

    def added(name):
        return after.get(name, 0) - before.get(name, 0)

    assert names == (SPANS if model == "lightgcn" else SPANS - {"lkt.graph.propagate"})
    assert added("grad.examples") == 64
    assert added("graph.spmm_products") == products
    assert added("graph.spmm_edges") == products * nnz


def test_a_step_records_nothing_outside_record_spans():
    trainer = MAKERS["lightgcn"]().create_trainer(_dataset(3), CPU)
    take_spans()
    before = counts()
    trainer.train_step()
    assert take_spans() == [] and counts() == before


def test_lightgcn_steps_match_the_plain_reference():
    ds = _dataset(4)
    settings = {"embedding_size": 8, "layer_count": 3, "batch_size": 16, "learning_rate": 1e-2, "regularization": 1e-2}
    trainer = LightGCNScorer(**settings).create_trainer(ds, CPU)
    gen = torch.Generator().manual_seed(5)
    nu, ni = trainer.n_users, trainer.n_items
    start = {"u_embed": 0.1 * torch.randn((nu, 8), generator=gen), "i_embed": 0.1 * torch.randn((ni, 8), generator=gen)}
    trainer.load_parameters({k: v.clone() for k, v in start.items()})
    with torch.no_grad():
        u_eff, i_eff = trainer.step_embeds()
    losses, draws = [], []
    for s in range(3):
        losses.append(float(trainer.train_step()))
        draws.append(trainer.last_batch)
        if s == 0:
            u_grad, i_grad = (trainer.params[k].grad.clone() for k in ("u_embed", "i_embed"))
    coo = ds.interaction_matrix().csr(None).to_coo()
    g = ref.Graph(torch.as_tensor(coo.row), torch.as_tensor(coo.col), nu, ni)
    want = ref.train(g, start["u_embed"], start["i_embed"], draws, 3, settings["regularization"], settings["learning_rate"], "float64")
    assert relative_gap(u_eff, want[0]["u_eff"]) <= 1e-6
    assert relative_gap(i_eff, want[0]["i_eff"]) <= 1e-6
    assert relative_gap(u_grad, want[0]["u_grad"]) <= 1e-5
    assert relative_gap(i_grad, want[0]["i_grad"]) <= 1e-5
    for name in ("u_embed", "i_embed"):
        got = trainer.params[name].detach() - start[name]
        assert relative_gap(got, want[-1][name] - start[name].double()) <= 1e-4, name
    np.testing.assert_allclose(losses, [float(w["loss"]) for w in want], rtol=1e-6)
