"""The port's EASE scorer (``lkpy_tpu_torch.models.ease``) against the JAX
package's on the CPU, and the data-layer pieces it reads (the SciPy export
of the interaction matrix, ``CSR.from_scipy``/``to_scipy``).

Both packages get the same synthetic interactions, made with numpy from a
seed (300 users × 180 items, 10 items without any user).  Tolerances: the
co-occurrence Gram equal to SciPy's to the bit (integer counts, exact in
float32); the weights within rtol 1e-3 of the JAX package's (both invert
in float32, by different factorizations' rounding) plus atol 1e-5 of the
largest weight; scores from the same weights
within rtol 1e-4 / atol 1e-5 with the same NaN pattern; lists of separately
trained scorers within atol 1e-4 (sums of up to 60 weights) and equal
wherever the score gap to the next rank exceeds 1e-4.
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sps
import torch

import lkpy_tpu
import lkpy_tpu_torch
from lkpy_tpu.batch import recommend as jax_batch_recommend
from lkpy_tpu.data import DatasetBuilder as JaxBuilder
from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data.matrix import CSR as JaxCSR
from lkpy_tpu.models.ease import EASEScorer as JaxEASE
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch import recommend
from lkpy_tpu_torch.data import CSR, DatasetBuilder, ItemList, Vocabulary
from lkpy_tpu_torch.models import EASEScorer
from lkpy_tpu_torch.models.ease import EASEConfig
from lkpy_tpu_torch.ops.knn import cooccurrence_gram
from lkpy_tpu_torch.pipeline import Pipeline, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

N_USERS, N_ITEMS, EMPTY_ITEMS = 300, 180, 10
UNKNOWN_USER, UNKNOWN_ITEM = 10_001, 99_999
CPU = TrainingOptions(device="cpu")


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, size=N_USERS) + 3, 60)
    users = np.repeat(np.arange(N_USERS), lens)
    items = np.concatenate([rng.choice(N_ITEMS - EMPTY_ITEMS, size=n, replace=False) for n in lens])
    ratings = (rng.integers(1, 11, size=len(users)) / 2.0).astype(np.float32)
    return pd.DataFrame({"user_id": users + 1, "item_id": items + 1, "rating": ratings})


def _dataset(builder_cls, df):
    dsb = builder_cls()
    dsb.add_entities("item", np.arange(1, N_ITEMS + 1))
    dsb.add_interactions("rating", df, entities=["user", "item"], missing="insert", default=True)
    return dsb.build()


@pytest.fixture(scope="module")
def data():
    df = _frame()
    jds, tds = _dataset(JaxBuilder, df), _dataset(DatasetBuilder, df)
    js = JaxEASE()
    js.train(jds, JaxTrainingOptions())
    return jds, tds, df, js


@pytest.mark.parametrize("attribute", [None, "rating", "count"])
@pytest.mark.parametrize("layout", ["csr", "coo"])
def test_scipy_export_matches_jax(data, attribute, layout):
    jds, tds, _, _ = data
    got = tds.interaction_matrix().scipy(attribute, layout=layout)
    want = jds.interaction_matrix().scipy(attribute, layout=layout)
    assert type(got) is type(want) and got.shape == want.shape and got.dtype == want.dtype
    assert (got != want).nnz == 0
    assert (got.tocsr() != want.tocsr()).nnz == 0


def test_csr_scipy_round_trip_matches_jax():
    rng = np.random.default_rng(1)
    m = sps.random(40, 30, density=0.2, random_state=1, format="coo", dtype=np.float32)
    m.data = rng.uniform(1, 5, m.nnz).astype(np.float32)
    got, want = CSR.from_scipy(m), JaxCSR.from_scipy(m)
    np.testing.assert_array_equal(got.rowptr, want.rowptr)
    np.testing.assert_array_equal(got.colind, want.colind)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.rowptr.dtype == np.int64 and got.colind.dtype == np.int32
    for structural in (False, True):
        a, b = got.to_scipy(structural=structural), want.to_scipy(structural=structural)
        assert isinstance(a, sps.csr_array) and (a != b).nnz == 0
    assert (CSR.from_scipy(m).drop_values().to_scipy() != (m != 0).astype(np.float32)).nnz == 0


def test_gram_equals_scipy_to_the_bit(data):
    """The Gram the JAX package forms on the host (models/ease.py:68-72)."""
    jds, tds, _, _ = data
    ui = jds.interaction_matrix().scipy(None).astype(np.float32)
    ui.data[:] = 1.0
    want = np.asarray((ui.T @ ui).todense(), dtype=np.float32)
    for budget in (4 << 30, 1):  # the least chunk is 1,024 users: one chunk either way here
        got = cooccurrence_gram(tds.interaction_matrix().csr(None), max_dense_bytes=budget, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    assert (np.diag(want)[-EMPTY_ITEMS:] == 0).all()


def test_weights_match_jax(data):
    _, tds, _, js = data
    ts = EASEScorer()
    ts.train(tds, CPU)
    w, jw = ts.weights.numpy(), np.asarray(js.weights)
    assert ts.weights.device.type == "cpu" and ts.weights.dtype == torch.float32
    np.testing.assert_allclose(w, jw, rtol=1e-3, atol=1e-5 * np.abs(jw).max())
    assert (np.diag(w) == 0).all()
    # empty items: their Gram row is λ on the diagonal only, so their weights are 0
    assert (w[-EMPTY_ITEMS:] == 0).all() and (w[:, -EMPTY_ITEMS:] == 0).all()


@pytest.mark.parametrize("reg", [0.5, 250.0])
def test_regularization_matches_jax(data, reg):
    jds, tds, _, _ = data
    js, ts = JaxEASE(regularization=reg), EASEScorer(regularization=reg)
    js.train(jds, JaxTrainingOptions())
    ts.train(tds, CPU)
    jw = np.asarray(js.weights)
    np.testing.assert_allclose(ts.weights.numpy(), jw, rtol=1e-3, atol=1e-5 * np.abs(jw).max())


def test_scores_from_jax_weights(data):
    jds, tds, _, js = data
    ts = EASEScorer.from_numpy(np.asarray(js.weights), Vocabulary(js.items.ids, "item"), device="cpu")
    rng = np.random.default_rng(3)
    n_finite = 0
    for u in rng.choice(np.arange(1, N_USERS + 1), 10, replace=False):
        cands = np.append(rng.choice(np.arange(1, N_ITEMS + 1), 50, replace=False), UNKNOWN_ITEM)
        got = ts(tds.user_row(u), ItemList(item_ids=cands))
        want = js(jds.user_row(u), JaxItemList(item_ids=cands))
        np.testing.assert_array_equal(np.isnan(got.scores()), np.isnan(want.scores()))
        np.testing.assert_allclose(got.scores(), want.scores(), rtol=1e-4, atol=1e-5)
        n_finite += int(np.isfinite(got.scores()).sum())
        assert np.isnan(got.scores()[-1])
    assert n_finite == 500
    # an empty history, and one of unknown items only
    for hist in (ItemList(item_ids=[]), ItemList(item_ids=[UNKNOWN_ITEM])):
        assert np.isnan(ts(hist, ItemList(item_ids=[1, 2, 3])).scores()).all()


def test_topn_pipeline_recommend_matches_jax(data):
    jds, tds, df, _ = data
    jp = lkpy_tpu.topn_pipeline(JaxEASE(), n=10)
    jp.train(jds, JaxTrainingOptions(rng=42))
    tp = topn_pipeline(EASEScorer(), n=10)
    tp.train(tds, TrainingOptions(rng=42, device="cpu"))
    users = np.append(df["user_id"].unique()[:30], UNKNOWN_USER)
    got = recommend(tp, users, n=10)
    want = jax_batch_recommend(jp, users, n=10)
    for u in users:
        g, w = got.lookup(u), want.lookup(u)
        assert len(g) == len(w) == (0 if u == UNKNOWN_USER else 10)
        if not len(g):
            continue
        s = w.scores()
        np.testing.assert_allclose(g.scores(), s, rtol=1e-4, atol=1e-4)
        clear = np.ones(10, bool)
        gap = np.abs(np.diff(s)) > 1e-4
        clear[:-1] &= gap
        clear[1:] &= gap
        clear[-1] = False
        np.testing.assert_array_equal(np.asarray(g.ids())[clear], np.asarray(w.ids())[clear])
    assert len(lkpy_tpu_torch.recommend(tp, users[0], n=10)) == 10


def test_config_round_trip_and_pickle(data):
    _, tds, _, _ = data
    assert EASEConfig().regularization == 1.0
    assert EASEScorer(regularization=3.0).dump_config() == JaxEASE(regularization=3.0).dump_config()
    tp = topn_pipeline(EASEScorer(regularization=2.0), n=5)
    again = Pipeline.from_config(tp.get_config())
    assert again.config_hash() == tp.config_hash()
    assert again.node("scorer").component.config.regularization == 2.0
    ts = EASEScorer()
    ts.train(tds, CPU)
    back = pickle.loads(pickle.dumps(ts))
    assert torch.equal(back.weights, ts.weights) and back.items == ts.items
    hist = tds.user_row(5)
    np.testing.assert_array_equal(back(hist, ItemList(item_ids=[1, 2, 3])).scores(), ts(hist, ItemList(item_ids=[1, 2, 3])).scores())


def test_runs_on_the_card_unless_told_cpu(data, monkeypatch):
    _, tds, _, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EASEScorer().train(tds, TrainingOptions())
    with pytest.raises(RuntimeError, match="CUDA"):
        EASEScorer.from_numpy(np.zeros((2, 2), np.float32), Vocabulary([1, 2]))
