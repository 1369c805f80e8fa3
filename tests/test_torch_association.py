"""The port's association-rule scorer (``lkpy_tpu_torch.models.association``)
against the JAX package's on the CPU.

Both packages get the same synthetic interactions, made with numpy from a
seed (80 users × 50 items, some items never rated).  The port normalizes
the co-occurrence counts in float64 as the JAX package does and stores
float32, so the tables agree within 1e-6 relative (they are equal to the
bit on these inputs); scores, means over history rows in float32 summed in
another order, within rtol 1e-6 with the same NaN pattern.
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sps
import torch

from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import RecQuery as JaxRecQuery
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models.association import AssociationScorer as JaxAssociation
from lkpy_tpu_torch.batch import recommend
from lkpy_tpu_torch.data import ItemList, RecQuery, Vocabulary, from_interactions_df
from lkpy_tpu_torch.models import AssociationScorer
from lkpy_tpu_torch.ops.gather_rows import gather_rows
from lkpy_tpu_torch.pipeline import Pipeline, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

N_USERS, N_ITEMS = 80, 50
UNKNOWN_ITEM = 99_999
CPU = TrainingOptions(device="cpu")
CONFIGS = {
    "probability": dict(),
    "lift": dict(method="lift"),
    "damped_lift": dict(method="lift", damping=2.5),
    "damped_probability": dict(damping=0.3),
}


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 12, size=N_USERS)
    users = np.repeat(np.arange(N_USERS), lens)
    items = np.concatenate([rng.choice(N_ITEMS, size=n, replace=False) for n in lens])
    return pd.DataFrame({"user_id": users + 1, "item_id": items + 1})


@pytest.fixture(scope="module")
def data():
    df = _frame()
    return jax_from_df(df), from_interactions_df(df)


@pytest.fixture(scope="module")
def trained(data):
    jds, tds = data
    out = {}
    for name, cfg in CONFIGS.items():
        js = JaxAssociation(**cfg)
        js.train(jds)
        ts = AssociationScorer(**cfg)
        ts.train(tds, CPU)
        out[name] = js, ts
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tables_match_jax(trained, name):
    js, ts = trained[name]
    assert "_assoc_scores" not in ts.__dict__  # the SciPy form is built only when read
    want = js.assoc_scores.toarray()
    got = ts.score_table.numpy()
    assert ts.score_table.device.type == "cpu" and ts.score_table.dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (np.diag(got) == 0).all()
    sp = ts.assoc_scores
    assert isinstance(sp, sps.csr_array) and sp.shape == js.assoc_scores.shape and sp.nnz == js.assoc_scores.nnz
    assert ts.assoc_scores is sp
    np.testing.assert_array_equal(ts.item_freqs, js.item_freqs)
    assert ts.item_freqs.dtype == np.int32


@pytest.mark.parametrize("max_nbrs", [None, 1, 3, 40])
@pytest.mark.parametrize("name", ["probability", "damped_lift"])
def test_scores_match_jax(data, name, max_nbrs):
    jds, tds = data
    js = JaxAssociation(**CONFIGS[name], max_nbrs=max_nbrs)
    js.train(jds)
    ts = AssociationScorer(**CONFIGS[name], max_nbrs=max_nbrs)
    ts.train(tds, CPU)
    ids = np.r_[np.arange(1, N_ITEMS + 1), UNKNOWN_ITEM]
    for hist in ([1, 5, 9, 22, 31], [2], [3, UNKNOWN_ITEM], [UNKNOWN_ITEM], []):
        got = ts(RecQuery(user_items=ItemList(item_ids=hist)), ItemList(item_ids=ids)).scores()
        want = js(JaxRecQuery(user_items=JaxItemList(item_ids=hist)), JaxItemList(item_ids=ids)).scores()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_scorer_from_jax_arrays(data, trained):
    _, tds = data
    js, ts = trained["damped_lift"]
    back = AssociationScorer.from_numpy(js.assoc_scores, js.item_freqs, tds.items, js.config.model_dump(), device="cpu")
    np.testing.assert_allclose(back.score_table.numpy(), ts.score_table.numpy(), rtol=1e-6)
    q = RecQuery(user_items=ItemList(item_ids=[4, 8]))
    want = js(JaxRecQuery(user_items=JaxItemList(item_ids=[4, 8])), JaxItemList(item_ids=[1, 2, 3])).scores()
    np.testing.assert_allclose(back(q, ItemList(item_ids=[1, 2, 3])).scores(), want, rtol=1e-6)


def test_per_query_call_gathers_the_history(trained, monkeypatch):
    import lkpy_tpu_torch.models._dense as history_module

    _, ts = trained["probability"]
    calls = []
    monkeypatch.setattr(history_module, "gather_rows", lambda table, idx: calls.append(len(idx)) or gather_rows(table, idx))
    ts(RecQuery(user_items=ItemList(item_ids=[1, 2, UNKNOWN_ITEM])), ItemList(item_ids=[4, 5]))
    assert calls == [2]


def test_pipeline_pickle_and_config(data, trained):
    _, tds = data
    pipe = topn_pipeline(AssociationScorer(method="lift"), n=5)
    pipe.train(tds, CPU)
    recs = recommend(pipe, tds.users.ids[:5], n=5)
    assert recs.total_items() > 0
    again = Pipeline.from_config(pipe.get_config())
    assert again.config_hash() == pipe.config_hash()
    _, ts = trained["lift"]
    back = pickle.loads(pickle.dumps(ts))
    q = RecQuery(user_items=ItemList(item_ids=[1, 2]))
    np.testing.assert_array_equal(back(q, ItemList(item_ids=[3, 4])).scores(), ts(q, ItemList(item_ids=[3, 4])).scores())


def test_runs_on_the_card_unless_told_cpu(data, monkeypatch):
    _, tds = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AssociationScorer().train(tds, TrainingOptions())
    with pytest.raises(RuntimeError, match="CUDA"):
        AssociationScorer.from_numpy(sps.csr_array(np.eye(2)), np.ones(2), Vocabulary([1, 2]))
