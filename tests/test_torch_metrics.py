"""Parity of the port's metrics (``lkpy_tpu_torch.metrics``) with the JAX
package's on the CPU: every metric class and function on the same lists,
made with numpy from a seed, within 1e-12, and ``RunAnalysis``'s frames
(per-list values, summary, global metrics) with missing test lists and
metric defaults."""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu.data as jax_data
import lkpy_tpu.metrics as jax_metrics
import lkpy_tpu.metrics.ranking as jax_ranking
import lkpy_tpu.utils.stats as jax_stats
import lkpy_tpu_torch.data as data
import lkpy_tpu_torch.metrics as metrics
import lkpy_tpu_torch.metrics.ranking as ranking
import lkpy_tpu_torch.utils.stats as stats

torch.set_num_threads(1)

TOL = 1e-12
N_USERS = 26
N_ITEMS = 60
CATS = np.random.default_rng(99).integers(0, 2, size=(N_ITEMS * 5 + 20, 5)).astype(np.float64)
VECS = np.random.default_rng(98).standard_normal((N_ITEMS * 5 + 20, 4))


def _frame(seed=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 25, size=40)
    users = np.repeat(np.arange(40), lens)
    items = np.concatenate([rng.choice(N_ITEMS, size=n, replace=False) for n in lens])
    ratings = (rng.integers(1, 11, size=len(users)) / 2.0).astype(np.float32)
    return pd.DataFrame({"user_id": users + 100, "item_id": items * 5 + 3, "rating": ratings})


def _build(pkg, seed=3):
    """Recommendation, test and prediction lists of N_USERS users in one
    package: random ranked lists of catalog items (one with an item outside
    the catalog, one empty), test lists with ratings (one empty, two users
    without one), predictions of the test items with noise (one NaN)."""
    ds = pkg.from_interactions_df(_frame())
    rng = np.random.default_rng(seed)
    ids = ds.items.ids
    recs, tests, preds = {}, {}, {}
    for u in range(N_USERS):
        n = 0 if u == 5 else int(rng.integers(1, 16))
        rid = rng.choice(ids, size=n, replace=False)
        if u == 3:
            rid[0] = 99_999
        scores = np.sort(rng.random(n).astype(np.float32))[::-1].copy()
        nums = np.searchsorted(ids, rid)
        kw = dict(scores=scores, ordered=True, vec=VECS[nums])
        if u % 2 and u != 3:
            recs[u] = pkg.ItemList(item_nums=nums, vocabulary=ds.items, **kw)
        else:
            recs[u] = pkg.ItemList(item_ids=rid, **kw)
        if u in (7, 11):
            continue
        m = 0 if u == 9 else int(rng.integers(1, 9))
        tid = np.concatenate([rng.choice(rid, size=min(m // 2, n), replace=False), rng.choice(ids, size=m, replace=False)])
        tid = pd.unique(tid)
        r = (rng.integers(1, 11, size=len(tid)) / 2.0).astype(np.float32)
        tests[u] = pkg.ItemList(item_ids=tid, rating=r)
        p = r + rng.normal(0, 0.7, size=len(tid)).astype(np.float32)
        if u == 13 and len(p):
            p[0] = np.nan
        preds[u] = pkg.ItemList(item_ids=tid, scores=p)
    return ds, recs, tests, preds


@pytest.fixture(scope="module")
def both():
    return _build(jax_data), _build(data)


def _cats(il):
    return CATS[np.searchsorted(np.arange(N_ITEMS * 5 + 20), np.minimum(il.ids(), N_ITEMS * 5 + 19))]


def _vecs(il):
    return VECS[np.minimum(il.ids(), N_ITEMS * 5 + 19)]


# name -> factory(metrics module, dataset)
LIST_METRICS = {
    "NDCG": lambda m, ds: m.NDCG(),
    "NDCG@10": lambda m, ds: m.NDCG(10),
    "NDCG@k=5": lambda m, ds: m.NDCG(k=5),
    "NDCG-rating": lambda m, ds: m.NDCG(10, gain="rating"),
    "NDCG-geometric": lambda m, ds: m.NDCG(10, weight=m.GeometricRankWeight(0.7)),
    "NDCG-log3": lambda m, ds: m.NDCG(weight=m.LogRankWeight(base=3, offset=1)),
    "DCG@10": lambda m, ds: m.DCG(10),
    "DCG-rating": lambda m, ds: m.DCG(gain="rating"),
    "Precision@5": lambda m, ds: m.Precision(5),
    "Precision": lambda m, ds: m.Precision(),
    "Recall@10": lambda m, ds: m.Recall(10),
    "Hit@3": lambda m, ds: m.Hit(3),
    "RecipRank@10": lambda m, ds: m.RecipRank(10),
    "AveragePrecision": lambda m, ds: m.AveragePrecision(),
    "AveragePrecision@5": lambda m, ds: m.AveragePrecision(5),
    "RBP@10": lambda m, ds: m.RBP(10),
    "RBP-normalized": lambda m, ds: m.RBP(10, normalize=True, patience=0.5),
    "RBP-log": lambda m, ds: m.RBP(weight=m.LogRankWeight()),
    "MeanPopRank@10": lambda m, ds: m.MeanPopRank(ds, 10),
    "Entropy": lambda m, ds: m.Entropy(),
    "Entropy-categories": lambda m, ds: m.Entropy(10, categories=_cats),
    "RankBiasedEntropy": lambda m, ds: m.RankBiasedEntropy(patience=0.6),
    "RankBiasedEntropy-categories": lambda m, ds: m.RankBiasedEntropy(categories=_cats),
    "ILS-vectors": lambda m, ds: m.ILS(vectors=_vecs),
    "ILS-field": lambda m, ds: m.ILS(8, field="vec"),
    "ListLength": lambda m, ds: m.ListLength(),
    "TestItemCount": lambda m, ds: m.TestItemCount(),
}


def _same(got, want):
    if want is None or (isinstance(want, float) and np.isnan(want)):
        return got is None or (isinstance(got, float) and np.isnan(got))
    return abs(got - want) <= TOL


def _measure(metric, out, test):
    try:
        return metric.measure_list(out, test)
    except (ValueError, KeyError) as e:
        return type(e)


@pytest.mark.parametrize("name", sorted(LIST_METRICS))
def test_list_metric_matches_jax(both, name):
    (jds, jrecs, jtests, _), (tds, trecs, ttests, _) = both
    jm = LIST_METRICS[name](jax_metrics, jds)
    tm = LIST_METRICS[name](metrics, tds)
    assert tm.label == jm.label and tm.default == jm.default
    empty = (jax_data.ItemList(), data.ItemList())
    for u in range(N_USERS):
        want = _measure(jm, jrecs[u], jtests.get(u, empty[0]))
        got = _measure(tm, trecs[u], ttests.get(u, empty[1]))
        if isinstance(want, type):
            assert got is want, (name, u)
        else:
            assert _same(got, want), (name, u, got, want)


@pytest.mark.parametrize("name", ["RMSE", "MAE"])
@pytest.mark.parametrize("missing", ["error", "ignore"])
def test_predict_metrics_match_jax(both, name, missing):
    (_, jrecs, jtests, jpreds), (_, trecs, ttests, tpreds) = both
    jm, tm = getattr(jax_metrics, name)(missing, missing), getattr(metrics, name)(missing, missing)
    assert tm.default is jm.default is None
    fn, jfn = getattr(metrics, name.lower()), getattr(jax_metrics, name.lower())
    for u in jtests:
        for jo, to in [(jpreds[u], tpreds[u]), (jpreds[u][::2], tpreds[u][::2]), (jrecs[u], trecs[u])]:
            want, got = _measure(jm, jo, jtests[u]), _measure(tm, to, ttests[u])
            assert got is want if isinstance(want, type) else _same(got, want), (name, u, got, want)
            assert _same(fn(to, ttests[u]), jfn(jo, jtests[u]))
    with pytest.raises(ValueError):
        tm.measure_list(data.ItemList(item_ids=[1]), ttests[0])


GLOBAL_METRICS = {
    "UniqueItemCount": lambda m, ds: m.UniqueItemCount(),
    "ListGini@10": lambda m, ds: m.ListGini(10, items=ds),
    "ListGini-vocabulary": lambda m, ds: m.ListGini(items=ds.items),
    "ExposureGini@10": lambda m, ds: m.ExposureGini(10, items=ds),
    "ExposureGini": lambda m, ds: m.ExposureGini(items=ds.items),
}


def _collections(pkg, recs, tests):
    return pkg.ItemListCollection.from_dict(recs, "user_id"), pkg.ItemListCollection.from_dict(tests, "user_id")


@pytest.mark.parametrize("name", sorted(GLOBAL_METRICS))
def test_global_metric_matches_jax(both, name):
    (jds, jrecs, jtests, _), (tds, trecs, ttests, _) = both
    jm, tm = GLOBAL_METRICS[name](jax_metrics, jds), GLOBAL_METRICS[name](metrics, tds)
    assert tm.label == jm.label
    got = tm.measure_run(*_collections(data, trecs, ttests))
    want = jm.measure_run(*_collections(jax_data, jrecs, jtests))
    assert _same(got, want), (got, want)


def _frames_equal(got: pd.DataFrame | pd.Series, want):
    if isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want, check_exact=False, rtol=0, atol=TOL)
    else:
        pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=0, atol=TOL)


def _analyses(m):
    ranked = m.RunAnalysis(m.NDCG(10), m.RBP(10), m.Precision(10), m.Recall(10), m.RecipRank(10), m.Hit(10))
    ranked.add_metric(m.AveragePrecision(10), label="MAP", default=0.5)
    ranked.add_metric(m.ListLength)
    ranked.add_metric(lambda out, test: float(len(out) + len(test)), label="sizes")
    ranked.add_metric(m.UniqueItemCount())
    predicted = m.RunAnalysis(m.RMSE("ignore", "ignore"), m.MAE("ignore", "ignore"))
    globals_only = m.RunAnalysis(m.UniqueItemCount())
    return ranked, predicted, globals_only


def test_run_analysis_frames_match_jax(both):
    (_, jrecs, jtests, jpreds), (_, trecs, ttests, tpreds) = both
    jr, tr = _collections(jax_data, jrecs, jtests), _collections(data, trecs, ttests)
    jp = jax_data.ItemListCollection.from_dict(jpreds, "user_id")
    tp = data.ItemListCollection.from_dict(tpreds, "user_id")
    results = []
    for ja, ta, jout, tout in zip(_analyses(jax_metrics), _analyses(metrics), [jr[0], jp, jr[0]], [tr[0], tp, tr[0]]):
        want, got = ja.measure(jout, jr[1]), ta.measure(tout, tr[1])
        _frames_equal(got.list_metrics(), want.list_metrics())
        _frames_equal(got.list_metrics(fill_missing=False), want.list_metrics(fill_missing=False))
        _frames_equal(got.list_summary(), want.list_summary())
        _frames_equal(got.global_metrics(), want.global_metrics())
        results.append(got)
    # users 7 and 11 have no test list: measured against an empty list, NaN until filled by the defaults
    raw, filled = results[0].list_metrics(fill_missing=False), results[0].list_metrics()
    assert len(raw) == N_USERS and raw.loc[[7, 11], "NDCG@10"].isna().all()
    assert (filled.loc[[7, 11], "NDCG@10"] == 0.0).all() and (filled.loc[[7, 11], "MAP"] == 0.5).all()
    assert "UniqueItemCount" in results[0].global_metrics() and results[2].list_summary().index.tolist() == ["UniqueItemCount"]


@pytest.mark.parametrize("scores", [[3.0, 0.5, 0.0, 2.0], [], [np.nan, 1.0, -1.0], [0.0, 0.0]])
@pytest.mark.parametrize("graded", [True, False])
def test_dcg_functions_match_jax(scores, graded):
    for w in (None, "geometric"):
        jw = jax_metrics.GeometricRankWeight(0.8) if w else None
        tw = metrics.GeometricRankWeight(0.8) if w else None
        assert _same(ranking.array_dcg(np.array(scores), tw, graded=graded), jax_ranking.array_dcg(np.array(scores), jw, graded=graded))
        assert _same(ranking.fixed_dcg(len(scores), tw), jax_ranking.fixed_dcg(len(scores), jw))


def test_weights_and_stats_match_jax():
    ranks = np.arange(1, 30)
    for jw, tw in [
        (jax_metrics.LogRankWeight(), metrics.LogRankWeight()),
        (jax_metrics.LogRankWeight(base=10, offset=2), metrics.LogRankWeight(base=10, offset=2)),
        (jax_metrics.GeometricRankWeight(0.3), metrics.GeometricRankWeight(0.3)),
    ]:
        np.testing.assert_array_equal(tw.weight(ranks), jw.weight(ranks))
        np.testing.assert_array_equal(tw.log_weight(ranks), jw.log_weight(ranks))
        assert tw.series_sum() == jw.series_sum()
    rng = np.random.default_rng(0)
    for v in (rng.random(50), np.zeros(4), np.array([]), rng.integers(0, 3, 20)):
        assert stats.gini(v) == jax_stats.gini(v)
        assert stats.damped_mean(v, 5.0) == jax_stats.damped_mean(v, 5.0)


def test_reranking_metrics_match_jax(both):
    (_, jrecs, _, _), (_, trecs, _, _) = both
    for a in range(8):
        for b in range(8):
            for n in (3, 10):
                assert _same(
                    metrics.rank_biased_overlap(trecs[a], trecs[b], n=n),
                    jax_metrics.rank_biased_overlap(jrecs[a], jrecs[b], n=n),
                )
                assert _same(
                    metrics.least_item_promoted(trecs[a], trecs[b], n=n),
                    jax_metrics.least_item_promoted(jrecs[a], jrecs[b], n=n),
                )
    w = (jax_metrics.LogRankWeight(), metrics.LogRankWeight())
    assert _same(metrics.rank_biased_overlap(trecs[1], trecs[2], w[1]), jax_metrics.rank_biased_overlap(jrecs[1], jrecs[2], w[0]))


def test_measure_list_and_call_metric_match_jax(both):
    (jds, jrecs, jtests, _), (tds, trecs, ttests, _) = both
    assert _same(metrics.measure_list(metrics.NDCG, trecs[1], ttests[1], 5), jax_metrics.measure_list(jax_metrics.NDCG, jrecs[1], jtests[1], 5))
    assert _same(metrics.measure_list(metrics.Hit(2), trecs[2], ttests[2]), jax_metrics.measure_list(jax_metrics.Hit(2), jrecs[2], jtests[2]))
    assert metrics.measure_list(metrics.ListLength, trecs[4]) == jax_metrics.measure_list(jax_metrics.ListLength, jrecs[4])
    fn = lambda out, test: float(len(out) * 2)  # noqa: E731
    assert metrics.measure_list(fn, trecs[4]) == jax_metrics.measure_list(fn, jrecs[4])
    with pytest.raises(TypeError):
        metrics.measure_list(object(), trecs[4])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = metrics.call_metric(metrics.Recall, trecs[6], ttests[6])
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert _same(got, jax_metrics.call_metric(jax_metrics.Recall, jrecs[6], jtests[6]))


def test_truncation_needs_ordered_lists():
    il = data.ItemList(item_ids=np.arange(8))
    with pytest.raises(ValueError):
        metrics.NDCG(3).measure_list(il, il)
    assert metrics.NDCG(10).measure_list(il, il) == jax_metrics.NDCG(10).measure_list(
        jax_data.ItemList(item_ids=np.arange(8)), jax_data.ItemList(item_ids=np.arange(8))
    )
