"""The port's ``models/basic.py`` components against the JAX package's on the
same synthetic data (numpy from a seed), on the host as in both packages."""

import numpy as np
import pandas as pd
import pytest

from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import RecQuery as JaxRecQuery
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.lazy import LazyValue as JaxLazyValue
from lkpy_tpu.models import basic as jb
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.data import ItemList, RecQuery, from_interactions_df
from lkpy_tpu_torch.lazy import LazyValue
from lkpy_tpu_torch.models import basic as tb
from lkpy_tpu_torch.training import TrainingOptions


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n = 900
    df = pd.DataFrame(
        {
            "user_id": rng.integers(1, 60, n),
            "item_id": rng.integers(1, 90, n),
            "rating": (rng.integers(1, 11, n) / 2.0).astype(np.float32),
            "timestamp": rng.integers(1_000, 2_000, n).astype(np.float64),
        }
    ).drop_duplicates(["user_id", "item_id"])
    return jax_from_df(df), from_interactions_df(df)


def _both(name, data, **config):
    """The JAX and the port component of one name and config, trained."""
    jds, tds = data
    j, t = getattr(jb, name)(**config), getattr(tb, name)(**config)
    if hasattr(j, "train"):
        j.train(jds, JaxTrainingOptions())
        t.train(tds, TrainingOptions(device="cpu"))
    assert t.dump_config() == j.dump_config()
    return j, t


def _items(ids, scores=None, jax=False):
    cls = JaxItemList if jax else ItemList
    return cls(item_ids=np.asarray(ids), scores=None if scores is None else np.asarray(scores, np.float32))


def _same(got, want):
    np.testing.assert_array_equal(got.ids(), want.ids())
    gs, ws = got.scores(), want.scores()
    assert (gs is None) == (ws is None)
    if gs is not None:
        np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("score", ["quantile", "rank", "count"])
def test_pop_scorer(data, score):
    j, t = _both("PopScorer", data, score=score)
    ids = [1, 5, 17, 89, 4242]
    _same(t(_items(ids)), j(_items(ids, jax=True)))


@pytest.mark.parametrize("cutoff", [0.0, 1_500.0])
def test_time_bounded_pop(data, cutoff):
    j, t = _both("TimeBoundedPopScore", data, cutoff=cutoff, score="count")
    ids = list(range(1, 90))
    _same(t(_items(ids)), j(_items(ids, jax=True)))


@pytest.mark.parametrize("n, config_n", [(None, -1), (3, -1), (None, 4), (-1, 2)])
def test_topn_ranker(data, n, config_n):
    j, t = _both("TopNRanker", data, n=config_n)
    ids, scores = [4, 8, 15, 16, 23, 42], [0.5, np.nan, 2.0, 2.0, -1.0, 0.7]
    got, want = t(_items(ids, scores), n=n), j(_items(ids, scores, jax=True), n=n)
    _same(got, want)
    np.testing.assert_array_equal(got.ranks(), want.ranks())


def test_random_selector(data):
    j, t = _both("RandomSelector", data, n=5, rng=17)
    ids = list(range(100, 140))
    for user in (1, 2, None):
        _same(t(_items(ids), query=user), j(_items(ids, jax=True), query=user))


def test_history_lookup_and_candidates(data):
    jl, tl = _both("UserTrainingHistoryLookup", data)
    for exclude in ("user-history", "all", "none"):
        jc, tc = _both("TrainingItemsCandidateSelector", data, exclude=exclude)
        for user in (1, 7, 59, 4242):
            tq, jq = tl(user), jl(user)
            if jq.user_items is None:
                assert tq.user_items is None
            else:
                _same(tq.user_items, jq.user_items)
                np.testing.assert_array_equal(tq.user_items.field("rating"), jq.user_items.field("rating"))
            _same(tc(tq), jc(jq))
    q = tl(RecQuery(user_id=3, user_items=ItemList(item_ids=[1, 2])))
    assert list(q.user_items.ids()) == [1, 2]  # a history the query brings is kept
    assert list(jl(JaxRecQuery(user_id=3, user_items=JaxItemList(item_ids=[1, 2]))).user_items.ids()) == [1, 2]


@pytest.mark.parametrize("score", ["rating", "indicator"])
@pytest.mark.parametrize("source", ["training", "query"])
def test_known_rating_scorer(data, score, source):
    j, t = _both("KnownRatingScorer", data, score=score, source=source)
    jl, tl = _both("UserTrainingHistoryLookup", data)
    ids = list(range(1, 40))
    for user in (2, 9, 4242):
        _same(t(tl(user), _items(ids)), j(jl(user), _items(ids, jax=True)))


def test_fallback_scorer():
    t, j = tb.FallbackScorer(), jb.FallbackScorer()
    ids = [1, 2, 3, 4]
    primary = ([0.5, np.nan, 0.1, np.nan], [9.0, 8.0, 7.0, 6.0])
    ran = []

    def backup(jax):
        ran.append(jax)
        return _items(ids[::-1], primary[1], jax=jax)

    _same(t(_items(ids, primary[0]), LazyValue(lambda: backup(False))), j(_items(ids, primary[0], jax=True), JaxLazyValue(lambda: backup(True))))
    assert ran == [False, True]
    # nothing to fill: the lazy backup never runs
    full = [0.5, 0.2, 0.1, 0.3]
    _same(t(_items(ids, full), LazyValue(lambda: backup(False))), j(_items(ids, full, jax=True), JaxLazyValue(lambda: backup(True))))
    assert ran == [False, True]
    # a plain backup list works as well
    _same(t(_items(ids, primary[0]), _items(ids, primary[1])), j(_items(ids, primary[0], jax=True), _items(ids, primary[1], jax=True)))
