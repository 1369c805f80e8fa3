"""The port's SLIM (``lkpy_tpu_torch.ops.slim`` and
``lkpy_tpu_torch.models.slim``) against the JAX package's on the CPU.

Both packages get the same synthetic binary interactions, made with numpy
from a seed (50 users × 40 items).  The port forms ``A @ w`` and
``Aᵀ @ r`` as CSR products where the JAX package sums segments, so sums
round otherwise and weights within rounding of 0 can flip between 0 and a
tiny value: dense weights are compared within atol 1e-5, never CSR
structures.  The power-iteration step is equal (the same host code and
seed).  The reference's coordinate-descent oracle
(``tests/models/test_linear.py::slim_oracle_cd``) holds the port at its
own atol 5e-3.  Scores from the JAX weights within rtol 1e-5.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import RecQuery as JaxRecQuery
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models.slim import SLIMScorer as JaxSLIM
from lkpy_tpu.ops import slim as jax_slim
from lkpy_tpu_torch.batch import recommend
from lkpy_tpu_torch.data import ItemList, RecQuery, Vocabulary, from_interactions_df
from lkpy_tpu_torch.models import SLIMScorer
from lkpy_tpu_torch.ops import slim
from lkpy_tpu_torch.ops.gather_rows import gather_rows
from lkpy_tpu_torch.pipeline import Pipeline, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions
from tests.models.test_linear import slim_oracle_cd

torch.set_num_threads(1)

N_USERS, N_ITEMS = 50, 40
UNKNOWN_ITEM = 99_999
CPU = TrainingOptions(device="cpu")


def _frame(seed=0, n_users=N_USERS, n_items=N_ITEMS, density=0.15):
    rng = np.random.default_rng(seed)
    A = rng.uniform(size=(n_users, n_items)) < density
    u, i = np.nonzero(A)
    return pd.DataFrame({"user_id": u + 1, "item_id": i + 1})


@pytest.fixture(scope="module")
def data():
    df = _frame()
    jds, tds = jax_from_df(df), from_interactions_df(df)
    ui = tds.interaction_matrix().csr(None)
    ui = ui.with_values(np.ones(ui.nnz, dtype=np.float32))
    return jds, tds, ui


def test_lipschitz_equals_jax(data):
    jds, _, ui = data
    assert slim._lipschitz(ui) == jax_slim._lipschitz(jds.interaction_matrix().csr(None))


@pytest.mark.parametrize("lo,hi", [(0, 16), (16, 40), (5, 6)])
def test_slim_block_matches_jax(data, lo, hi):
    _, _, ui = data
    coo = ui.to_coo()
    l1, l2, iters = 0.3, 0.5, 40
    step = float(np.float32(1.0 / slim._lipschitz(ui)))
    targets = np.arange(lo, hi, dtype=np.int32)
    a_t = np.asarray(ui.to_scipy().todense(), dtype=np.float32)[:, targets]
    want = jax_slim._slim_block(
        jnp.asarray(coo.row), jnp.asarray(coo.col), jnp.zeros(N_ITEMS), jnp.asarray(targets), jnp.asarray(a_t),
        l1, l2, jnp.float32(step), N_USERS, N_ITEMS, iters,
    )  # fmt: skip
    dev = torch.device("cpu")
    a, a_tr = slim.device_csr(ui, dev), slim.device_csr(ui.transpose(), dev)
    got = slim._slim_block(a, a_tr, torch.from_numpy(targets.astype(np.int64)), torch.from_numpy(a_t), l1, l2, step, iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert (got >= 0).all() and (got[targets, np.arange(len(targets))] == 0).all()


@pytest.mark.parametrize("block", [256, 16, 7])
def test_train_slim_matches_jax(data, block):
    jds, _, ui = data
    want = jax_slim.train_slim(jds.interaction_matrix().csr(None).with_values(np.ones(ui.nnz, np.float32)), 0.2, 0.4, 60, block)
    got = slim.train_slim(ui, 0.2, 0.4, 60, block, device="cpu")
    assert got.shape == (N_ITEMS, N_ITEMS) and got.colind.dtype == np.int32 and got.values.dtype == np.float32
    np.testing.assert_allclose(got.to_scipy().toarray(), want.to_scipy().toarray(), rtol=0, atol=1e-5)


def test_train_slim_reports_progress(data):
    _, _, ui = data

    class Bar:
        done = 0

        def update(self, n):
            Bar.done += n

    slim.train_slim(ui, 1.0, 1.0, 2, 16, device="cpu", progress=Bar())
    assert Bar.done == N_ITEMS


def test_slim_matches_cd_oracle():
    """The mirror of tests/models/test_linear.py::test_slim_matches_cd_oracle:
    FISTA and the reference's CD reach the same optimum."""
    rng = np.random.default_rng(42)
    A = (rng.uniform(size=(30, 12)) < 0.3).astype(np.float32)
    df = pd.DataFrame({"user_id": np.nonzero(A)[0], "item_id": np.nonzero(A)[1]})
    s = SLIMScorer(l1_reg=0.5, l2_reg=0.5, max_iters=500)
    s.train(from_interactions_df(df), CPU)
    w_mine = s.weights.to_scipy().toarray()
    w_oracle = slim_oracle_cd(A[:, sorted(df.item_id.unique())], 0.5, 0.5)
    np.testing.assert_allclose(w_mine, w_oracle, atol=5e-3)
    np.testing.assert_array_equal(s.weight_table.numpy(), w_mine)


@pytest.fixture(scope="module")
def trained(data):
    jds, tds, _ = data
    js = JaxSLIM(l1_reg=0.1, l2_reg=0.1, max_iters=50)
    js.train(jds)
    ts = SLIMScorer(l1_reg=0.1, l2_reg=0.1, max_iters=50)
    ts.train(tds, CPU)
    return js, ts


def test_scorer_weights_match_jax(trained):
    js, ts = trained
    w = ts.weights.to_scipy().toarray()
    np.testing.assert_allclose(w, js.weights.to_scipy().toarray(), rtol=0, atol=1e-5)
    assert (w >= 0).all() and (np.diag(w) == 0).all()
    assert ts.weight_table.device.type == "cpu"


def test_scores_from_jax_weights(data, trained):
    _, tds, _ = data
    js, _ = trained
    ts = SLIMScorer.from_numpy(js.weights, tds.items, js.config.model_dump(), device="cpu")
    ids = np.r_[np.arange(1, N_ITEMS + 1), UNKNOWN_ITEM]
    for hist in ([1, 5, 9], [2], [3, UNKNOWN_ITEM], [UNKNOWN_ITEM], []):
        got = ts(RecQuery(user_items=ItemList(item_ids=hist)), ItemList(item_ids=ids)).scores()
        want = js(JaxRecQuery(user_items=JaxItemList(item_ids=hist)), JaxItemList(item_ids=ids)).scores()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_per_query_call_gathers_the_history(trained, monkeypatch):
    import lkpy_tpu_torch.models._dense as module

    _, ts = trained
    calls = []
    monkeypatch.setattr(module, "gather_rows", lambda table, idx: calls.append(len(idx)) or gather_rows(table, idx))
    ts(RecQuery(user_items=ItemList(item_ids=[1, 2, 3, UNKNOWN_ITEM])), ItemList(item_ids=[4, 5]))
    assert calls == [3]


def test_pipeline_pickle_and_config(data, trained):
    _, tds, _ = data
    pipe = topn_pipeline(SLIMScorer(l1_reg=0.1, l2_reg=0.1, max_iters=20), n=5)
    pipe.train(tds, CPU)
    recs = recommend(pipe, tds.users.ids[:5], n=5)
    assert recs.total_items() > 0
    again = Pipeline.from_config(pipe.get_config())
    assert again.config_hash() == pipe.config_hash()
    _, ts = trained
    back = pickle.loads(pickle.dumps(ts))
    q = RecQuery(user_items=ItemList(item_ids=[1, 2]))
    np.testing.assert_array_equal(back(q, ItemList(item_ids=[3, 4])).scores(), ts(q, ItemList(item_ids=[3, 4])).scores())


def test_runs_on_the_card_unless_told_cpu(data, monkeypatch):
    _, tds, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SLIMScorer(max_iters=1).train(tds, TrainingOptions())
    with pytest.raises(RuntimeError, match="CUDA"):
        SLIMScorer.from_numpy(np.eye(2, dtype=np.float32), Vocabulary([1, 2]))
