"""The port's bias model (``lkpy_tpu_torch.models.bias``) and its segment
reductions against ``lkpy_tpu.models.bias`` and ``lkpy_tpu.ops.segment``.

Tolerance: rtol 1e-5 / atol 1e-6 (float32 sums accumulated in different
orders by the two frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import RecQuery as JaxRecQuery
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models import bias as jax_bias
from lkpy_tpu.ops import segment as jax_segment
from lkpy_tpu_torch.data import ItemList, RecQuery, from_interactions_df
from lkpy_tpu_torch.models import bias
from lkpy_tpu_torch.ops import segment
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _ratings_df(seed=0, n_users=60, n_items=45, nnz=900):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_users, nnz) * n_items + rng.integers(0, n_items, nnz))
    u, i = key // n_items, key % n_items
    r = np.clip(3.5 + rng.normal(0, 0.6, n_items)[i] + rng.normal(0, 0.4, n_users)[u] + rng.normal(0, 0.5, len(u)), 0.5, 5)
    return pd.DataFrame({"user_id": u + 100, "item_id": i + 1000, "rating": r.astype(np.float32)})


@pytest.fixture(scope="module")
def data():
    df = _ratings_df()
    return df, jax_from_df(df), from_interactions_df(df)


@pytest.mark.parametrize("damping", [0.0, 2.5])
def test_segment_reductions_match_jax(damping):
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(500).astype(np.float32)
    seg = rng.integers(0, 37, 500).astype(np.int32)
    seg[seg == 5] = 6  # an empty segment
    tv, ts = torch.from_numpy(vals), torch.from_numpy(seg)
    np.testing.assert_allclose(segment.segment_sum(tv, ts, 40).numpy(), np.asarray(jax_segment.segment_sum(vals, seg, 40)), **TOL)
    np.testing.assert_array_equal(segment.segment_count(ts, 40).numpy(), np.asarray(jax_segment.segment_count(seg, 40)))
    got = segment.segment_mean(tv, ts, 40, damping=damping).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_segment.segment_mean(jnp.asarray(vals), jnp.asarray(seg), 40, damping=damping)), **TOL)
    assert got[5] == 0.0 and got[39] == 0.0


@pytest.mark.parametrize("spec,entity,want", [(3.0, "user", 3.0), ({"user": 2.0}, "item", 0.0), ((1.0, 4.0), "item", 4.0), ([1.0, 4.0], "user", 1.0)])
def test_entity_damping(spec, entity, want):
    assert bias.entity_damping(spec, entity) == jax_bias.entity_damping(spec, entity) == want


def _assert_models_equal(got, ref):
    assert got.global_bias == pytest.approx(ref.global_bias, rel=1e-6)
    for name in ("item_biases", "user_biases"):
        g, r = getattr(got, name), getattr(ref, name)
        assert (g is None) == (r is None)
        if r is not None:
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, r, **TOL)
    assert (got.items is None) == (ref.items is None) and (got.users is None) == (ref.users is None)


@pytest.mark.parametrize("entities", [{"user", "item"}, {"item"}, {"user"}])
@pytest.mark.parametrize("damping", [0.0, 5.0, {"user": 2.0, "item": 7.0}, (1.0, 4.0)])
def test_learn_matches_jax(data, entities, damping):
    _, jds, tds = data
    ref = jax_bias.BiasModel.learn(jds, damping, entities=entities)
    got = bias.BiasModel.learn(tds, damping, entities=entities, device="cpu")
    _assert_models_equal(got, ref)


def test_users_only_biases_are_against_the_global_mean(data):
    df, _, tds = data
    got = bias.BiasModel.learn(tds, 0.0, entities={"user"}, device="cpu")
    want = (df["rating"] - df["rating"].mean()).groupby(df["user_id"]).mean()
    np.testing.assert_allclose(got.user_biases, want.loc[tds.users.ids].to_numpy(), rtol=1e-4, atol=1e-5)
    assert got.item_biases is None


def test_learn_needs_ratings():
    df = _ratings_df().drop(columns="rating")
    with pytest.raises(ValueError):
        bias.BiasModel.learn(from_interactions_df(df), device="cpu")


def test_transform_matrix_matches_jax(data):
    _, jds, tds = data
    for entities in ({"user", "item"}, {"item"}):
        ref = jax_bias.BiasModel.learn(jds, 5.0, entities=entities)
        got = bias.BiasModel.learn(tds, 5.0, entities=entities, device="cpu")
        r = ref.transform_matrix(jds.interaction_matrix().csr("rating"))
        g = got.transform_matrix(tds.interaction_matrix().csr("rating"))
        np.testing.assert_array_equal(g.colind, r.colind)
        np.testing.assert_array_equal(g.rowptr, r.rowptr)
        assert g.values.dtype == np.float32
        np.testing.assert_allclose(g.values, r.values, rtol=1e-5, atol=1e-5)


def _lists(ids, ratings=None):
    kw = {} if ratings is None else {"rating": np.asarray(ratings, dtype=np.float32)}
    return JaxItemList(item_ids=np.asarray(ids), **kw), ItemList(item_ids=np.asarray(ids), **kw)


@pytest.mark.parametrize("entities", [{"user", "item"}, {"user"}])
def test_compute_for_items_matches_jax(data, entities):
    df, jds, tds = data
    ref = jax_bias.BiasModel.learn(jds, 5.0, entities=entities)
    got = bias.BiasModel.learn(tds, 5.0, entities=entities, device="cpu")
    j_items, t_items = _lists([1000, 1003, 999_999, 1010])  # one unknown item
    j_hist, t_hist = _lists([1001, 1002, 424242, 1007], [4.0, 2.5, 5.0, 3.0])
    j_empty, t_empty = _lists([], [])
    cases = [
        dict(user_id=int(df["user_id"].iloc[0])),  # a known user
        dict(user_id=-5),  # an unknown user
        dict(user_id=None),
        dict(user_id=int(df["user_id"].iloc[0]), user_items=(j_hist, t_hist)),  # fold-in wins over the stored bias
        dict(user_id=-5, user_items=(j_hist, t_hist)),
        dict(user_id=int(df["user_id"].iloc[0]), user_items=(j_empty, t_empty)),  # no ratings: the stored bias
    ]
    for case in cases:
        j_ui, t_ui = case.get("user_items", (None, None))
        rs, rb = ref.compute_for_items(j_items, case["user_id"], j_ui)
        gs, gb = got.compute_for_items(t_items, case["user_id"], t_ui)
        np.testing.assert_allclose(gs, rs, **TOL)
        assert gb == pytest.approx(rb, rel=1e-5, abs=1e-6)
    # an explicit bias in place of the user's
    np.testing.assert_allclose(got.compute_for_items(t_items, bias=0.25), ref.compute_for_items(j_items, bias=0.25), **TOL)
    if entities == {"user"}:
        # users-only fold-in: residuals against the global mean alone
        _, gb = got.compute_for_items(t_items, None, t_hist)
        assert gb == pytest.approx(float(np.sum(np.array([4.0, 2.5, 5.0, 3.0]) - got.global_bias) / (4 + 5.0)), rel=1e-6)


@pytest.mark.parametrize("config", [{"damping": 5.0}, {"damping": 0.0, "entities": ["item"]}, {"damping": {"user": 3.0}}])
def test_bias_scorer_matches_jax(data, config):
    df, jds, tds = data
    js = jax_bias.BiasScorer(**config)
    js.train(jds)
    ts = bias.BiasScorer(**config)
    assert not ts.is_trained
    ts.train(tds, TrainingOptions(device="cpu"))
    assert ts.is_trained
    model = ts.model
    ts.train(tds, TrainingOptions(device="cpu", retrain=False))
    assert ts.model is model  # already trained: skipped
    uid = int(df["user_id"].iloc[3])
    j_items, t_items = _lists([1000, 1003, 999_999, 1010])
    j_hist, t_hist = _lists([1001, 1002], [4.0, 2.5])
    queries = [
        (uid, uid),
        (-1, -1),
        (None, None),
        (j_hist, t_hist),
        (JaxRecQuery(user_id=uid, user_items=j_hist), RecQuery(user_id=uid, user_items=t_hist)),
    ]
    for jq, tq in queries:
        ref, got = js(jq, j_items), ts(tq, t_items)
        np.testing.assert_array_equal(got.ids(), ref.ids())
        np.testing.assert_allclose(got.scores(), ref.scores(), **TOL)


def test_rec_query_create():
    hist = ItemList(item_ids=[1, 2])
    assert RecQuery.create(None) == RecQuery()
    q = RecQuery.create(7)
    assert q.user_id == 7 and q.query_id == 7 and q.user_items is None
    assert RecQuery.create(hist).user_items is hist and RecQuery.create(hist).query_items is hist
    assert RecQuery.create(q) is q


def test_bias_scorer_config_errors():
    with pytest.raises(TypeError):
        bias.BiasScorer(bias.BiasConfig(), damping=1.0)
    with pytest.raises(TypeError):
        bias.BiasScorer(3)
    assert bias.BiasScorer({"damping": 2.0}).config.entity_damping("item") == 2.0
