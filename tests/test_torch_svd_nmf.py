"""The port's BiasedSVD and NMF scorers (``lkpy_tpu_torch.models.svd``,
``lkpy_tpu_torch.models.nmf``) and the batch route's ``user_components``
branch against the JAX package on the CPU.

Both packages get the same synthetic ratings, made with numpy from a seed
(70 users × 45 items).  The signs of singular vectors are free, so the SVD
is compared through ``U·S·Vt`` and the scores, and the components only up
to a sign a column.  Tolerances: the randomized SVD's reconstruction and
the trained scorers' scores within 1e-4 relative; singular values within
1e-5 relative; NMF's ``W·H`` after 20 multiplicative updates within 1e-4
relative; scores of scorers built from the JAX scorers' arrays within rtol
1e-5; batch lists equal to the JAX package's where the score gap to the
next rank exceeds 1e-4, unknown users' lists empty.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu_torch
from lkpy_tpu.batch.device import device_recommend as jax_device_recommend
from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models import nmf as jax_nmf
from lkpy_tpu.models import svd as jax_svd
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch import recommend
from lkpy_tpu_torch.batch.device import _extract_arrays, device_recommend, supports_device_batch
from lkpy_tpu_torch.data import ArrayTopNILC, ItemList, Vocabulary, from_interactions_df
from lkpy_tpu_torch.models import nmf, svd
from lkpy_tpu_torch.models._dense import dense_on_device
from lkpy_tpu_torch.models.nmf import NMFScorer
from lkpy_tpu_torch.models.svd import BiasedSVDScorer
from lkpy_tpu_torch.ops.gather_rows import gather_rows
from lkpy_tpu_torch.pipeline import Pipeline, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

N_USERS, N_ITEMS = 70, 45
UNKNOWN_USER, UNKNOWN_ITEM = 10_001, 99_999
CPU = TrainingOptions(rng=42, device="cpu")
GAP = 1e-4


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(4, 20, size=N_USERS)
    users = np.repeat(np.arange(N_USERS), lens)
    items = np.concatenate([rng.choice(N_ITEMS, size=n, replace=False) for n in lens])
    ratings = (rng.integers(1, 11, size=len(users)) / 2.0).astype(np.float32)
    return pd.DataFrame({"user_id": users + 1, "item_id": items + 1, "rating": ratings})


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _clear(s: np.ndarray) -> np.ndarray:
    gap = np.abs(np.diff(s)) > GAP
    clear = np.ones(len(s), bool)
    clear[:-1] &= gap
    clear[1:] &= gap
    clear[-1:] = False
    return clear


@pytest.fixture(scope="module")
def data():
    df = _frame()
    return jax_from_df(df), from_interactions_df(df)


@pytest.fixture(scope="module")
def trained(data):
    jds, tds = data
    out = {}
    for name, jcls, tcls, cfg in (
        ("svd", jax_svd.BiasedSVDScorer, BiasedSVDScorer, dict(features=6)),
        ("nmf", jax_nmf.NMFScorer, NMFScorer, dict(features=6, max_iter=20)),
    ):
        js = jcls(**cfg)
        js.train(jds, JaxTrainingOptions(rng=42))
        ts = tcls(**cfg)
        ts.train(tds, CPU)
        out[name] = js, ts
    return out


def _svd_params(js) -> dict:
    b = js.bias
    return dict(user_components=js.user_components, item_components=js.item_components, global_bias=b.global_bias,
                item_biases=b.item_biases, user_biases=b.user_biases)  # fmt: skip


def _from_jax(name, js, tds):
    if name == "svd":
        return BiasedSVDScorer.from_numpy(_svd_params(js), js.config.model_dump(), tds.users, tds.items, device="cpu")
    params = dict(user_components=js.user_components, item_components=js.item_components)
    return NMFScorer.from_numpy(params, js.config.model_dump(), tds.users, tds.items, device="cpu")


def test_dense_on_device_equals_scipy(data):
    _, tds = data
    csr = tds.interaction_matrix().csr("rating")
    want = csr.to_scipy().toarray()
    np.testing.assert_array_equal(dense_on_device(csr, torch.device("cpu")).numpy(), want)
    np.testing.assert_array_equal(dense_on_device(csr, torch.device("cpu"), structural=True).numpy(), want != 0)
    np.testing.assert_array_equal(dense_on_device(csr.drop_values(), torch.device("cpu")).numpy(), want != 0)


def test_rand_svd_core_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((60, 30)).astype(np.float32) @ np.diag(np.linspace(3, 0.1, 30)).astype(np.float32)
    omega = rng.standard_normal((30, 14)).astype(np.float32)
    ju, js_, jvt = (np.asarray(x) for x in jax_svd._rand_svd_core(jnp.asarray(a), jnp.asarray(omega), 5))
    tu, ts_, tvt = (x.numpy() for x in svd._rand_svd_core(torch.from_numpy(a), torch.from_numpy(omega), 5))
    np.testing.assert_allclose(ts_, js_, rtol=1e-5)
    assert _rel((tu * ts_) @ tvt, (ju * js_) @ jvt) <= 1e-4
    # each singular pair up to its sign
    signs = np.sign(np.sum(tvt * jvt, axis=1))
    np.testing.assert_allclose(tvt * signs[:, None], jvt, atol=1e-4)
    np.testing.assert_allclose(tu * signs[None, :], ju, atol=1e-4)


def test_svd_scorer_matches_jax(data, trained):
    jds, tds = data
    js, ts = trained["svd"]
    assert ts.item_components.shape == (6, N_ITEMS) and ts.user_components.device.type == "cpu"
    t_full = ts.user_components.numpy() @ ts.item_components.numpy()
    assert _rel(t_full, js.user_components @ js.item_components) <= 1e-4
    vt = ts.item_components.numpy().astype(np.float64)
    np.testing.assert_allclose(vt @ vt.T, np.eye(6), atol=1e-5)
    ids = np.r_[np.arange(1, N_ITEMS + 1), UNKNOWN_ITEM]
    for user in (1, 30, UNKNOWN_USER):
        got = ts(user, ItemList(item_ids=ids)).scores()
        want = js(user, JaxItemList(item_ids=ids)).scores()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_nmf_init_matches_jax(data):
    _, tds = data
    csr = tds.interaction_matrix().csr("rating")
    dense = csr.to_scipy().toarray().astype(np.float32)
    w0, h0 = nmf.nmf_init(np.random.default_rng(3), csr.shape, 6, float(np.sum(csr.values, dtype=np.float64)))
    rng = np.random.default_rng(3)
    scale = np.sqrt(dense.mean() / 6)
    jw0 = np.abs(rng.standard_normal((N_USERS, 6))).astype(np.float32) * scale
    jh0 = np.abs(rng.standard_normal((6, N_ITEMS))).astype(np.float32) * scale
    np.testing.assert_allclose(w0, jw0, rtol=1e-6)
    np.testing.assert_allclose(h0, jh0, rtol=1e-6)


def test_nmf_mu_matches_jax(data):
    _, tds = data
    a = tds.interaction_matrix().csr("rating").to_scipy().toarray().astype(np.float32)
    rng = np.random.default_rng(4)
    w0 = rng.uniform(0.1, 1.0, (N_USERS, 5)).astype(np.float32)
    h0 = rng.uniform(0.1, 1.0, (5, N_ITEMS)).astype(np.float32)
    jw, jh = (np.asarray(x) for x in jax_nmf._nmf_mu(jnp.asarray(a), jnp.asarray(w0), jnp.asarray(h0), 20))
    tw, th = (x.numpy() for x in nmf._nmf_mu(torch.from_numpy(a), torch.from_numpy(w0), torch.from_numpy(h0), 20))
    assert _rel(tw @ th, jw @ jh) <= 1e-4
    assert (tw >= 0).all() and (th >= 0).all()
    # the loop in pieces is the loop
    pw, ph = nmf._nmf_mu(torch.from_numpy(a), torch.from_numpy(w0), torch.from_numpy(h0), 7)
    pw, ph = nmf._nmf_mu(torch.from_numpy(a), pw, ph, 13)
    np.testing.assert_array_equal(pw.numpy(), tw)


def test_nmf_scorer_matches_jax(data, trained):
    js, ts = trained["nmf"]
    w, h = ts.user_components.numpy(), ts.item_components.numpy()
    assert (w >= 0).all() and (h >= 0).all() and h.shape == (6, N_ITEMS)
    assert _rel(w @ h, js.user_components @ js.item_components) <= 1e-4
    ids = np.r_[np.arange(1, N_ITEMS + 1), UNKNOWN_ITEM]
    for user in (2, 40, UNKNOWN_USER):
        got = ts(user, ItemList(item_ids=ids)).scores()
        want = js(user, JaxItemList(item_ids=ids)).scores()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["svd", "nmf"])
def test_scores_from_jax_arrays(data, trained, name):
    _, tds = data
    js, _ = trained[name]
    ts = _from_jax(name, js, tds)
    ids = np.r_[np.arange(1, N_ITEMS + 1), UNKNOWN_ITEM]
    for user in (1, 9, UNKNOWN_USER):
        got = ts(user, ItemList(item_ids=ids)).scores()
        want = js(user, JaxItemList(item_ids=ids)).scores()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the batch route reads the same tables: the item-major rows are contiguous
    arrays = _extract_arrays(ts)
    assert arrays["i_embed"].shape == (N_ITEMS, 6) and arrays["i_embed"].is_contiguous()
    assert ("u_bias" in arrays) == (name == "svd")


@pytest.mark.parametrize("name", ["svd", "nmf"])
def test_per_query_call_gathers_the_candidates(data, trained, name, monkeypatch):
    _, ts = trained[name]
    calls = []
    monkeypatch.setattr(svd, "gather_rows", lambda table, idx: calls.append(len(idx)) or gather_rows(table, idx))
    ts(3, ItemList(item_ids=[1, 2, 3, UNKNOWN_ITEM]))
    assert calls == [3]


@pytest.mark.parametrize("name", ["svd", "nmf"])
def test_device_recommend_matches_jax(data, trained, name):
    jds, tds = data
    js, _ = trained[name]
    ts = _from_jax(name, js, tds)
    assert supports_device_batch(ts)
    users = np.r_[np.arange(1, N_USERS + 1, 4), UNKNOWN_USER]
    got = device_recommend(ts, users, 10, tds.interaction_matrix(), device="cpu")
    want = jax_device_recommend(js, users, 10, jds.interaction_matrix(), exact=True)
    for u in users:
        g, w = got.lookup(u), want.lookup(u)
        assert len(g) == len(w)
        clear = _clear(w.scores())
        assert np.array_equal(np.asarray(g.ids())[clear], np.asarray(w.ids())[clear])
        np.testing.assert_allclose(g.scores(), w.scores(), rtol=1e-5, atol=1e-5)
    assert len(got.lookup(UNKNOWN_USER)) == 0


@pytest.mark.parametrize("name", ["svd", "nmf"])
def test_pipeline_routes_pickle_and_config(data, name):
    _, tds = data
    scorer = BiasedSVDScorer(features=5) if name == "svd" else NMFScorer(features=5, max_iter=10)
    pipe = topn_pipeline(scorer, n=5)
    pipe.train(tds, CPU)
    users = tds.users.ids[:6]
    batch = recommend(pipe, users, n=5)
    assert isinstance(batch, ArrayTopNILC)
    for u in users:
        one = lkpy_tpu_torch.recommend(pipe, u, n=5)
        np.testing.assert_allclose(one.scores(), batch.lookup(u).scores(), rtol=1e-5)
    again = Pipeline.from_config(pipe.get_config())
    assert again.config_hash() == pipe.config_hash()
    back = pickle.loads(pickle.dumps(scorer))
    np.testing.assert_array_equal(back(2, ItemList(item_ids=[1, 2])).scores(), scorer(2, ItemList(item_ids=[1, 2])).scores())


def test_runs_on_the_card_unless_told_cpu(data, monkeypatch):
    _, tds = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for scorer in (BiasedSVDScorer(features=2), NMFScorer(features=2, max_iter=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            scorer.train(tds, TrainingOptions())
    params = dict(user_components=np.zeros((2, 2)), item_components=np.zeros((2, 2)), global_bias=0.0,
                  item_biases=np.zeros(2), user_biases=np.zeros(2))  # fmt: skip
    for cls in (BiasedSVDScorer, NMFScorer):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls.from_numpy(params, None, Vocabulary([1, 2]), Vocabulary([1, 2]))
