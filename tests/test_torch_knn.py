"""The port's item and user kNN scorers (``lkpy_tpu_torch.models.knn``)
against the JAX package's on the CPU, through ``train``, ``__call__``,
``from_numpy`` and the user's path: ``topn_pipeline``/``predict_pipeline``
→ ``Pipeline.train`` → ``recommend``/``predict``.

Both packages get the same synthetic ratings, made with numpy from a seed:
250 users × 200 items, 12 items in the vocabulary without any user.  The
port trains with ``TrainingOptions(device="cpu")``.  Tolerances: table sims
within 1e-5, neighbour ids equal at gaps > 1e-5; scores within rtol 1e-4 /
atol 1e-5 with the same NaN pattern, counts equal where the table is
carried across (``from_numpy`` from the JAX scorer's state); lists equal
wherever the score gap to the next rank exceeds 1e-4.
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu
import lkpy_tpu_torch
from lkpy_tpu.batch import predict as jax_batch_predict
from lkpy_tpu.batch import recommend as jax_batch_recommend
from lkpy_tpu.data import DatasetBuilder as JaxBuilder
from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import ItemListCollection as JaxILC
from lkpy_tpu.data import RecQuery as JaxRecQuery
from lkpy_tpu.data import Vocabulary as JaxVocabulary
from lkpy_tpu.models.knn import ItemKNNScorer as JaxItemKNN
from lkpy_tpu.models.knn import UserKNNScorer as JaxUserKNN
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch import predict, recommend
from lkpy_tpu_torch.data import DatasetBuilder, ItemList, ItemListCollection, RecQuery, Vocabulary
from lkpy_tpu_torch.models import ItemKNNScorer, UserKNNScorer
from lkpy_tpu_torch.models.knn import ItemKNNConfig, UserKNNConfig
from lkpy_tpu_torch.pipeline import Pipeline, predict_pipeline, topn_pipeline
from lkpy_tpu_torch.testing import ScorerTests
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

N_USERS, N_ITEMS, EMPTY_ITEMS = 250, 200, 12
UNKNOWN_USER, UNKNOWN_ITEM = 10_001, 99_999
CPU = TrainingOptions(device="cpu")


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.5, size=N_USERS) + 4, 80)
    users = np.repeat(np.arange(N_USERS), lens)
    pop = 1.0 / np.arange(1, N_ITEMS - EMPTY_ITEMS + 1) ** 0.7
    items = np.concatenate([rng.choice(N_ITEMS - EMPTY_ITEMS, size=n, replace=False, p=pop / pop.sum()) for n in lens])
    ratings = (rng.integers(1, 11, size=len(users)) / 2.0).astype(np.float32)
    return pd.DataFrame({"user_id": users + 1, "item_id": items + 1, "rating": ratings})


def _dataset(builder_cls, df):
    """All N_ITEMS items in the vocabulary, the last EMPTY_ITEMS without users."""
    dsb = builder_cls()
    dsb.add_entities("item", np.arange(1, N_ITEMS + 1))
    dsb.add_interactions("rating", df, entities=["user", "item"], missing="insert", default=True)
    return dsb.build()


@pytest.fixture(scope="module")
def data():
    df = _frame()
    return _dataset(JaxBuilder, df), _dataset(DatasetBuilder, df), df


def _assert_tables_agree(js, ji, ts, ti, tol=1e-5):
    np.testing.assert_allclose(ts, js, rtol=0, atol=tol)
    gap_prev = np.concatenate([np.full((js.shape[0], 1), np.inf), -np.diff(js, axis=1)], axis=1)
    gap_next = np.concatenate([-np.diff(js, axis=1), np.zeros((js.shape[0], 1))], axis=1)
    clear = (js > tol) & (gap_prev > tol) & (gap_next > tol)
    assert clear.any()
    np.testing.assert_array_equal(ti[clear], ji[clear])


def _assert_scores_agree(got: ItemList, want, counts: bool = True):
    g, w = got.scores(), want.scores()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    if counts:
        np.testing.assert_array_equal(got.field("nbr_counts"), want.field("nbr_counts"))


def _assert_lists_agree(got, want, n):
    """Equal ids wherever the score gap to the next rank exceeds 1e-4."""
    assert len(got) == len(want)
    s = want.scores()
    np.testing.assert_allclose(got.scores(), s, rtol=1e-4, atol=1e-5)
    gap = np.abs(np.diff(s)) > 1e-4
    clear = np.ones(len(s), bool)
    clear[:-1] &= gap
    clear[1:] &= gap
    if len(want) == n:
        clear[-1] = False
    np.testing.assert_array_equal(np.asarray(got.ids())[clear], np.asarray(want.ids())[clear])


def _queries(jds, tds, seed=5):
    """(user id, port history, JAX history, candidates) for known users, a
    user unknown to the model with a history, and an empty history."""
    rng = np.random.default_rng(seed)
    out = []
    for u in rng.choice(np.arange(1, N_USERS + 1), 8, replace=False):
        cands = np.append(rng.choice(np.arange(1, N_ITEMS + 1), 40, replace=False), UNKNOWN_ITEM)
        out.append((u, tds.user_row(u), jds.user_row(u), cands))
    hist = tds.user_row(3)
    ids, ratings = np.append(hist.ids(), UNKNOWN_ITEM), np.append(hist.field("rating"), 4.0)
    out.append((UNKNOWN_USER, ItemList(item_ids=ids, rating=ratings), JaxItemList(item_ids=ids, rating=ratings), np.arange(1, N_ITEMS + 1)))
    out.append((UNKNOWN_USER, ItemList(item_ids=[], rating=[]), JaxItemList(item_ids=[], rating=[]), np.arange(1, 30)))
    return out


def _score_all(scorer, jscorer, queries, counts=True):
    n_finite = 0
    for uid, hist, jhist, cands in queries:
        got = scorer(RecQuery(user_id=uid, user_items=hist), ItemList(item_ids=cands))
        want = jscorer(JaxRecQuery(user_id=uid, user_items=jhist), JaxItemList(item_ids=cands))
        _assert_scores_agree(got, want, counts)
        n_finite += int(np.isfinite(got.scores()).sum())
        if len(hist) == 0:
            assert np.isnan(got.scores()).all()
        assert np.isnan(got.scores()[np.asarray(cands) == UNKNOWN_ITEM]).all()
    assert n_finite > 100


@pytest.mark.parametrize("feedback", ["explicit", "implicit"])
def test_item_knn_trains_like_jax(data, feedback):
    jds, tds, _ = data
    js = JaxItemKNN(feedback=feedback, save_nbrs=60)
    js.train(jds, JaxTrainingOptions())
    ts = ItemKNNScorer(feedback=feedback, save_nbrs=60)
    ts.train(tds, CPU)
    assert ts.sim_table.sims.device.type == "cpu" and ts.sim_table.k == 60
    _assert_tables_agree(np.asarray(js.sim_table.sims), np.asarray(js.sim_table.indices), ts.sim_table.sims.numpy(), ts.sim_table.indices.numpy())
    np.testing.assert_array_equal(ts.item_counts.numpy(), np.asarray(js.item_counts))
    assert (ts.item_counts.numpy()[-EMPTY_ITEMS:] == 0).all()
    if feedback == "explicit":
        np.testing.assert_allclose(ts.item_means, js.item_means, rtol=1e-6)
    else:
        assert ts.item_means is None and js.item_means is None
    assert ts.items == Vocabulary(jds.items.ids)


@pytest.mark.parametrize("max_nbrs,min_nbrs", [(20, 1), (5, 2)])
@pytest.mark.parametrize("feedback", ["explicit", "implicit"])
def test_item_knn_scores_like_jax_from_its_table(data, feedback, max_nbrs, min_nbrs):
    jds, tds, _ = data
    js = JaxItemKNN(feedback=feedback, max_nbrs=max_nbrs, min_nbrs=min_nbrs)
    js.train(jds, JaxTrainingOptions())
    ts = ItemKNNScorer.from_numpy(
        np.asarray(js.sim_table.indices), np.asarray(js.sim_table.sims), js.item_means,
        Vocabulary(js.items.ids, "item"), js.config.model_dump(), device="cpu",
    )  # fmt: skip
    assert ts.config == ItemKNNConfig(**js.config.model_dump())
    np.testing.assert_array_equal(ts.item_counts.numpy(), np.asarray(js.item_counts))
    _score_all(ts, js, _queries(jds, tds))


@pytest.mark.parametrize("feedback", ["explicit", "implicit"])
def test_item_knn_trained_scores_match_jax(data, feedback):
    jds, tds, _ = data
    js = JaxItemKNN(feedback=feedback)
    js.train(jds, JaxTrainingOptions())
    ts = ItemKNNScorer(feedback=feedback)
    ts.train(tds, CPU)
    # nbr_table_cap 512 over 200 items keeps every neighbour: no ties at the table's edge
    assert ts.sim_table.k == N_ITEMS - 1
    _score_all(ts, js, _queries(jds, tds, seed=6))


@pytest.mark.parametrize("feedback", ["explicit", "implicit"])
def test_user_knn_scores_like_jax(data, feedback):
    jds, tds, _ = data
    js = JaxUserKNN(feedback=feedback, max_nbrs=15)
    js.train(jds, JaxTrainingOptions())
    ts = UserKNNScorer(feedback=feedback, max_nbrs=15)
    ts.train(tds, CPU)
    assert ts._nv_vals.device.type == "cpu" and all(b.cols.device.type == "cpu" for b in ts._iu_buckets)
    if feedback == "explicit":
        np.testing.assert_allclose(ts.user_means, js.user_means, rtol=1e-6)
    _score_all(ts, js, _queries(jds, tds, seed=7))
    # from the user-item CSR arrays, prepared as train prepares them
    csr = tds.interaction_matrix().csr("rating" if feedback == "explicit" else None)
    again = UserKNNScorer.from_numpy(csr.rowptr, csr.colind, csr.values, tds.users, tds.items, ts.config, device="cpu")
    _score_all(again, js, _queries(jds, tds, seed=8))


@pytest.mark.parametrize("scorer", ["item", "user"])
def test_topn_pipeline_recommend_matches_jax(data, scorer):
    jds, tds, df = data
    port_cls, jax_cls = (ItemKNNScorer, JaxItemKNN) if scorer == "item" else (UserKNNScorer, JaxUserKNN)
    jp = lkpy_tpu.topn_pipeline(jax_cls(feedback="implicit"), n=10)
    jp.train(jds, JaxTrainingOptions(rng=42))
    tp = topn_pipeline(port_cls(feedback="implicit"), n=10)
    tp.train(tds, TrainingOptions(rng=42, device="cpu"))
    users = np.append(df["user_id"].unique()[:30], UNKNOWN_USER)
    got = recommend(tp, users, n=10)
    want = jax_batch_recommend(jp, users, n=10)
    assert type(got).__name__ == "ItemListCollection"  # the per-query runner: no embedding tables
    for u in users:
        if u == UNKNOWN_USER:
            assert len(got.lookup(u)) == len(want.lookup(u)) == 0
            continue
        assert len(got.lookup(u)) == 10
        _assert_lists_agree(got.lookup(u), want.lookup(u), 10)
    one = lkpy_tpu_torch.recommend(tp, users[0], n=10)
    _assert_lists_agree(one, lkpy_tpu.recommend(jp, users[0], n=10), 10)


@pytest.mark.parametrize("scorer", ["item", "user"])
def test_predict_pipeline_matches_jax(data, scorer):
    jds, tds, df = data
    port_cls, jax_cls = (ItemKNNScorer, JaxItemKNN) if scorer == "item" else (UserKNNScorer, JaxUserKNN)
    jp = lkpy_tpu.predict_pipeline(jax_cls())
    jp.train(jds, JaxTrainingOptions(rng=7))
    tp = predict_pipeline(port_cls())
    tp.train(tds, TrainingOptions(rng=7, device="cpu"))
    rng = np.random.default_rng(4)
    keys = [1, 2, 3, 50, UNKNOWN_USER]
    items = {u: np.append(rng.choice(np.arange(1, N_ITEMS + 1), 8, replace=False), UNKNOWN_ITEM) for u in keys}
    got = predict(tp, ItemListCollection.from_dict({u: ItemList(item_ids=i) for u, i in items.items()}))
    want = jax_batch_predict(jp, JaxILC.from_dict({u: JaxItemList(item_ids=i) for u, i in items.items()}))
    for u in keys:
        g, w = got.lookup(u).scores(), want.lookup(u).scores()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        assert np.isfinite(g).all()  # the bias fallback fills what the kNN scorer cannot


def test_configs_aliases_and_round_trip(data):
    from lkpy_tpu.models.knn import ItemKNNConfig as JaxItemKNNConfig
    from lkpy_tpu.models.knn import UserKNNConfig as JaxUserKNNConfig

    for alias in ("nnbrs", "k", "max_nbrs"):
        assert ItemKNNConfig(**{alias: 7}).max_nbrs == UserKNNConfig(**{alias: 7}).max_nbrs == 7
    tiny = {"min_sim": 0.0, "feedback": "implicit"}
    assert ItemKNNConfig(**tiny).model_dump() == JaxItemKNNConfig(**tiny).model_dump()
    assert UserKNNConfig(**tiny).model_dump() == JaxUserKNNConfig(**tiny).model_dump()
    assert ItemKNNConfig(**tiny).min_sim == float(np.finfo(np.float32).smallest_normal)
    assert ItemKNNConfig().nbr_table_cap == 512 and ItemKNNConfig().explicit
    tp = topn_pipeline(ItemKNNScorer(k=5, feedback="implicit", save_nbrs=30), n=10)
    cfg = tp.get_config()
    assert cfg.components["scorer"].code == "lkpy_tpu_torch.models.knn:ItemKNNScorer"
    again = Pipeline.from_config(cfg)
    assert again.config_hash() == tp.config_hash()
    assert again.node("scorer").component.config == tp.node("scorer").component.config
    assert not again.node("scorer").component.is_trained
    assert UserKNNScorer(k=3).dump_config() == {**JaxUserKNN(k=3).dump_config()}


@pytest.mark.parametrize("scorer", ["item", "user"])
def test_pickle_round_trip(data, scorer):
    jds, tds, _ = data
    ts = ItemKNNScorer(feedback="implicit") if scorer == "item" else UserKNNScorer(feedback="explicit")
    ts.train(tds, CPU)
    back = pickle.loads(pickle.dumps(ts))
    assert back.is_trained and back.config == ts.config
    for uid, hist, _, cands in _queries(jds, tds, seed=9)[:3]:
        query = RecQuery(user_id=uid, user_items=hist)
        np.testing.assert_array_equal(back(query, ItemList(item_ids=cands)).scores(), ts(query, ItemList(item_ids=cands)).scores())


def test_vocabulary_and_item_list_pickle_like_jax():
    v = Vocabulary(["b", "a", "c"], "item", reorder=False)
    back = pickle.loads(pickle.dumps(v))
    assert back == v and back.name == "item" and back.number("c") == 2 and list(back.ids) == ["b", "a", "c"]
    assert back.__getstate__().keys() == JaxVocabulary(["b", "a", "c"], "item", reorder=False).__getstate__().keys()
    il = ItemList(item_ids=["a", "c"], vocabulary=v, scores=[1.0, 2.0], ordered=True, rating=[3.0, 4.5])
    again = pickle.loads(pickle.dumps(il))
    assert len(again) == 2 and again.ordered and list(again.numbers()) == [1, 2]
    np.testing.assert_array_equal(again.field("rating"), [3.0, 4.5])
    jil = JaxItemList(item_ids=["a", "c"], scores=[1.0, 2.0])
    assert again.__getstate__().keys() == jil.__getstate__().keys()


def test_scorers_run_on_the_card_unless_told_cpu(data, monkeypatch):
    _, tds, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for scorer in (ItemKNNScorer(feedback="implicit"), UserKNNScorer()):
        with pytest.raises(RuntimeError, match="CUDA"):
            scorer.train(tds, TrainingOptions())
    with pytest.raises(RuntimeError, match="CUDA"):
        ItemKNNScorer.from_numpy(np.zeros((3, 2), np.int32), np.zeros((3, 2), np.float32), None, Vocabulary([1, 2, 3]))
    csr = tds.interaction_matrix().csr(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        UserKNNScorer.from_numpy(csr.rowptr, csr.colind, None, tds.users, tds.items)


class TestItemKNNImplicitGrid(ScorerTests):
    """The harness's grid (``lkpy_tpu_torch.testing``) on the CPU, with the
    JAX package's grid configuration (``tests/models/test_scorer_grid.py``)."""

    component = ItemKNNScorer
    config = ItemKNNScorer.validate_config({"feedback": "implicit"})
    can_score = "some"
    expected_ndcg = 0.10
    device = "cpu"
