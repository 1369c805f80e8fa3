"""``quick_measure_model`` in both packages on the CPU: the same synthetic
interactions (300 users x 200 items, with ratings, made with numpy from a
seed) and the same seed give the same split; the port's pipeline trains with
``device="cpu"``, so its kernels' plain versions run.  Implicit ALS: equal
ids at clear score gaps and every global metric within 2e-3.  Biased MF:
RMSE and MAE within 1e-4 relative.  The bias model: every metric within
1e-9."""

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.metrics import quick_measure_model as jax_quick
from lkpy_tpu.models.als import BiasedMFScorer as JaxBiasedMF
from lkpy_tpu.models.als import ImplicitMFScorer as JaxImplicitMF
from lkpy_tpu.models.bias import BiasScorer as JaxBiasScorer
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.metrics import quick_measure_model
from lkpy_tpu_torch.models.als import BiasedMFScorer, ImplicitMFScorer
from lkpy_tpu_torch.models.bias import BiasScorer

torch.set_num_threads(1)


def _frame(seed=8, n_users=300, n_items=200, groups=6):
    """Popularity skew and planted user-group/item-group affinity, as
    bench.py's generator, with ratings that favour the user's group."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 40, size=n_users)
    ugroup = rng.integers(0, groups, size=n_users)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.7
    users, items, ratings = [], [], []
    for u, n in enumerate(lens):
        w = pop * np.where(np.arange(n_items) % groups == ugroup[u], 6.0, 1.0)
        picks = rng.choice(n_items, size=n, replace=False, p=w / w.sum())
        users.append(np.full(n, u))
        items.append(picks)
        bonus = np.where(picks % groups == ugroup[u], 1.2, 0.0)
        ratings.append(np.clip(np.round(2.0 + bonus + rng.normal(0, 0.8, n)) + 0.5, 0.5, 5.0))
    return pd.DataFrame(
        {
            "user_id": np.concatenate(users) + 1,
            "item_id": np.concatenate(items) + 1,
            "rating": np.concatenate(ratings).astype(np.float32),
        }
    )


@pytest.fixture(scope="module")
def datasets():
    df = _frame()
    return jax_from_df(df.copy()), from_interactions_df(df.copy())


def _assert_same_split(got, want):
    assert list(got.test.keys()) == list(want.test.keys())
    for (_, g), (_, w) in zip(got.test.items(), want.test.items()):
        np.testing.assert_array_equal(g.ids(), w.ids())
        assert g.field_names == w.field_names
        for name in w.field_names:
            np.testing.assert_array_equal(g.field(name), w.field(name))
    pd.testing.assert_frame_equal(got.train.interaction_table(ids=True), want.train.interaction_table(ids=True))


def _clear_gap_mismatches(got, want) -> int:
    """Ranks whose ids differ where the reference list's score gap to both
    neighbours exceeds 1e-4."""
    bad = 0
    for key, w in want.items():
        g = got.lookup(*key)
        assert len(g) == len(w)
        s = w.scores()
        gap = np.abs(np.diff(s)) > 1e-4
        clear = np.ones(len(s), bool)
        clear[:-1] &= gap
        clear[1:] &= gap
        clear[-1] = False  # the rank below the last is not known
        bad += int((np.asarray(g.ids())[clear] != np.asarray(w.ids())[clear]).sum())
    return bad


def test_quick_implicit_matches_jax(datasets):
    jds, tds = datasets
    want = jax_quick(JaxImplicitMF(features=8, epochs=3), jds, n_recs=10, rng=42)
    got = quick_measure_model(ImplicitMFScorer(features=8, epochs=3), tds, n_recs=10, rng=42, device="cpu")
    _assert_same_split(got.split, want.split)
    assert len(got.recommendations) == len(want.recommendations) == 60
    assert _clear_gap_mismatches(got.recommendations, want.recommendations) == 0
    gm, wm = got.global_metrics(), want.global_metrics()
    assert list(gm.index) == list(wm.index) == ["NDCG@10", "RBP@10", "Precision@10", "Recall@10", "RecipRank@10", "Hit@10"]
    np.testing.assert_allclose(gm.to_numpy(), wm.to_numpy(), rtol=0, atol=2e-3)
    assert gm["NDCG@10"] > 0.05
    assert got.predictions is None and got.pred_analysis is None


def test_quick_biased_mf_matches_jax(datasets):
    jds, tds = datasets
    kw = dict(predicts_ratings=True, n_recs=10, user_frac=0.3, rng=7)
    want = jax_quick(JaxBiasedMF(features=6, epochs=4, damping=5.0), jds, **kw)
    got = quick_measure_model(BiasedMFScorer(features=6, epochs=4, damping=5.0), tds, device="cpu", **kw)
    _assert_same_split(got.split, want.split)
    gm, wm = got.global_metrics(), want.global_metrics()
    assert list(gm.index) == list(wm.index)
    np.testing.assert_allclose(gm[["RMSE", "MAE"]].to_numpy(), wm[["RMSE", "MAE"]].to_numpy(), rtol=1e-4)
    assert len(got.predictions) == len(want.predictions) == 90
    for key, w in want.predictions.items():
        np.testing.assert_allclose(got.predictions.lookup(*key).scores(), w.scores(), rtol=1e-4, atol=1e-4)


def test_quick_bias_matches_jax(datasets):
    jds, tds = datasets
    kw = dict(predicts_ratings=True, n_recs=15, user_frac=0.25, holdout_frac=0.3, rng=3)
    want = jax_quick(JaxBiasScorer(damping=5.0), jds, **kw)
    got = quick_measure_model(BiasScorer(damping=5.0), tds, device="cpu", **kw)
    _assert_same_split(got.split, want.split)
    pd.testing.assert_frame_equal(got.list_summary(), want.list_summary(), check_exact=False, rtol=0, atol=1e-9)
    pd.testing.assert_frame_equal(
        got.run_analysis.list_metrics(), want.run_analysis.list_metrics(), check_exact=False, rtol=0, atol=1e-9
    )


def test_quick_needs_a_card_unless_told_otherwise(datasets, monkeypatch):
    _, tds = datasets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quick_measure_model(ImplicitMFScorer(features=4, epochs=1), tds, user_frac=0.05)
