"""
Shared component test bases (port of ``lkpy_tpu/testing/components.py``).

Capability parity with the reference's uniform model test grid
(reference: src/lenskit/testing/_components.py:29 ``BasicComponentTests`` —
config round-trips; :110 ``ScorerTests`` — train / score known & unknown
users / empty queries / pickle round-trip / topn pipeline runs; accuracy
gates :348,365).

Subclass and set ``component`` (and optionally ``config``, ``device``,
``expected_rmse``, ``expected_ndcg``, ``needs_ratings``).  The grid trains
on :func:`synthetic_ratings`, a MovieLens-shaped set made from a seed; the
accuracy gates train on ml-latest-small (:func:`~lkpy_tpu_torch.testing.
movielens.ml_test_dir`) and skip where it is absent.  Components train on
the card unless ``device = "cpu"``.
"""

from __future__ import annotations

import inspect
import pickle

import numpy as np
import pandas as pd
import pytest

from lkpy_tpu_torch.data import Dataset, ItemList, RecQuery, from_interactions_df, load_movielens, load_movielens_df
from lkpy_tpu_torch.metrics import quick_measure_model
from lkpy_tpu_torch.pipeline import topn_pipeline
from lkpy_tpu_torch.testing.movielens import ml_test_dir
from lkpy_tpu_torch.training import TrainingOptions

__all__ = ["BasicComponentTests", "ScorerTests", "TrainingTests", "synthetic_ratings"]

#: items the grid scores, and user 1, are in every set it trains on
GRID_ITEMS = (31, 1029, 296)


def synthetic_ratings(seed: int = 42, n_users: int = 120, n_items: int = 1200) -> Dataset:
    """A MovieLens-shaped ratings set from ``seed``: user ids ``1..n_users``,
    item ids ``1..n_items`` with popularity falling with the id, 15 to 60
    ratings a user in half stars from a rank-4 taste model, and user 1 rating
    each of :data:`GRID_ITEMS`."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.7
    u_f = rng.normal(size=(n_users, 4))
    i_f = rng.normal(size=(n_items, 4))
    users, items = [], []
    for u in range(n_users):
        n = int(rng.integers(15, 61))
        users.append(np.full(n, u))
        items.append(rng.choice(n_items, n, replace=False, p=pop / pop.sum()))
    users, items = np.concatenate(users), np.concatenate(items)
    keep = users != 0
    users = np.concatenate([users[keep], np.zeros(len(GRID_ITEMS) + 20, int)])
    extra = np.setdiff1d(rng.choice(n_items, 40, replace=False), np.asarray(GRID_ITEMS) - 1)[:20]
    items = np.concatenate([items[keep], np.asarray(GRID_ITEMS) - 1, extra])
    raw = 3.0 + np.sum(u_f[users] * i_f[items], axis=1) / 2 + rng.normal(scale=0.5, size=len(users))
    ratings = np.clip(np.round(raw * 2) / 2, 0.5, 5.0)
    df = pd.DataFrame({"user_id": users + 1, "item_id": items + 1, "rating": ratings})
    return from_interactions_df(df.drop_duplicates(["user_id", "item_id"]))


class BasicComponentTests:
    """Config instantiation + round-trip tests (reference: _components.py:29)."""

    component: type
    config: object | None = None

    def _make(self):
        if self.config is not None:
            return self.component(self.config)
        return self.component()

    def test_instantiate_default(self):
        comp = self._make()
        assert comp is not None

    def test_config_roundtrip(self):
        comp = self._make()
        dumped = comp.dump_config()
        comp2 = self.component(self.component.validate_config(dumped))
        assert comp2.dump_config() == dumped


class _Data:
    """The grid's set and the accuracy gates' MovieLens sets."""

    #: where components train: None (the card) or ``"cpu"``
    device: str | None = None

    def _options(self, **kwargs) -> TrainingOptions:
        return TrainingOptions(device=self.device, **kwargs)

    @pytest.fixture(scope="class")
    def grid_ds(self) -> Dataset:
        return synthetic_ratings()

    @staticmethod
    def _ml_path():
        try:
            return ml_test_dir()
        except FileNotFoundError:
            pytest.skip("the accuracy gates need ml-latest-small, which is not in the repository")

    @pytest.fixture(scope="class")
    def ml_ds(self) -> Dataset:
        return load_movielens(self._ml_path())

    @pytest.fixture(scope="class")
    def ml_dense_ds(self) -> Dataset:
        """ml-latest-small restricted to items with at least 20 ratings
        (ML-100K's density, where the reference's gates were set)."""
        ratings = load_movielens_df(self._ml_path())
        counts = ratings.groupby("item_id").size()
        return from_interactions_df(ratings[ratings.item_id.isin(counts[counts >= 20].index)])


class TrainingTests(BasicComponentTests, _Data):
    """Common training tests (reference: _components.py:74 ``TrainingTests``):
    the component trains and reports itself trained.  Scorers get the full
    grid from :class:`ScorerTests`; use this base directly for trainable
    non-scorer components."""

    @pytest.fixture(scope="class")
    def trained_component(self, grid_ds: Dataset):
        comp = self._make()
        comp.train(grid_ds, self._options(rng=42))
        return comp

    def test_is_trained(self, trained_component):
        assert getattr(trained_component, "is_trained", True)

    def test_retrain_false_is_noop(self, trained_component):
        # retrain=False on an already-trained component must not clobber it
        before = pickle.dumps(trained_component.dump_config())
        trained_component.train(None, self._options(retrain=False))
        assert pickle.dumps(trained_component.dump_config()) == before


class ScorerTests(BasicComponentTests, _Data):
    """Train/score grid (reference: _components.py:110)."""

    can_score: str = "all"  # "all" | "some"
    needs_ratings: bool = False
    expected_rmse: tuple[float, float] | None = None
    expected_ndcg: float | None = None
    use_dense_gate: bool = False
    #: config used by the (slow) accuracy-gate tests; defaults to ``config``.
    #: Grid tests run tiny configs for speed, gates run realistic ones.
    eval_config: object | None = None

    def _make_eval(self):
        if self.eval_config is not None:
            return self.component(self.eval_config)
        return self._make()

    @pytest.fixture(scope="class")
    def trained(self, grid_ds: Dataset):
        comp = self._make()
        comp.train(grid_ds, self._options(rng=42))
        return comp

    def _query(self, ds, user_id=1):
        hist = ds.user_row(user_id)
        return RecQuery(user_id=user_id, user_items=hist)

    def _score(self, trained, items, query):
        """Call the scorer, passing ``query`` only if its signature takes one
        (PopScorer-style components score items without a query, mirroring
        reference basic/popularity.py)."""
        params = inspect.signature(type(trained).__call__).parameters
        if "query" in params:
            return trained(query=query, items=items)
        return trained(items=items)

    def test_score_known_items(self, trained, grid_ds):
        out = self._score(trained, ItemList(item_ids=list(GRID_ITEMS)), self._query(grid_ds))
        assert len(out) == 3
        s = out.scores()
        assert s is not None
        if self.can_score == "all":
            assert np.isfinite(s).all()

    def test_score_unknown_item(self, trained, grid_ds):
        out = self._score(trained, ItemList(item_ids=[9999999]), self._query(grid_ds))
        assert len(out) == 1

    def test_score_unknown_user(self, trained, grid_ds):
        q = RecQuery(user_id=99999999)
        out = self._score(trained, ItemList(item_ids=[31]), q)
        assert len(out) == 1

    def test_empty_query(self, trained, grid_ds):
        out = self._score(trained, ItemList(item_ids=[31, 1029]), RecQuery())
        assert len(out) == 2

    def test_empty_items(self, trained, grid_ds):
        out = self._score(trained, ItemList(), self._query(grid_ds))
        assert len(out) == 0

    def test_pickle_roundtrip(self, trained, grid_ds):
        copy = pickle.loads(pickle.dumps(trained))
        q = self._query(grid_ds)
        items = ItemList(item_ids=list(GRID_ITEMS))
        a = self._score(copy, items, q).scores()
        b = self._score(trained, items, q).scores()
        if a is None or (hasattr(a, "dtype") and not np.issubdtype(np.asarray(a).dtype, np.number)):
            assert (a is None) == (b is None)
            return
        np.testing.assert_allclose(a, b, equal_nan=True, rtol=1e-6)

    def test_topn_pipeline_run(self, grid_ds):
        from lkpy_tpu_torch import recommend

        pipe = topn_pipeline(self._make(), n=10)
        pipe.train(grid_ds, self._options(rng=42))
        recs = recommend(pipe, query=1, n=10)
        assert len(recs) <= 10
        assert recs.ordered

    @pytest.mark.slow
    @pytest.mark.eval
    def test_batch_prediction_accuracy(self, ml_ds, ml_dense_ds):
        """RMSE gate (reference: _components.py:348)."""
        if self.expected_rmse is None:
            pytest.skip("no expected RMSE")
        ds = ml_dense_ds if self.use_dense_gate else ml_ds
        res = quick_measure_model(self._make_eval(), ds, predicts_ratings=True, rng=42, user_frac=0.5, device=self.device)
        rmse = float(res.list_summary().loc["RMSE", "mean"])
        lo, hi = self.expected_rmse
        assert lo <= rmse <= hi

    @pytest.mark.slow
    @pytest.mark.eval
    def test_batch_top_n_accuracy(self, ml_ds, ml_dense_ds):
        """NDCG gate (reference: _components.py:365)."""
        if self.expected_ndcg is None:
            pytest.skip("no expected NDCG")
        ds = ml_dense_ds if self.use_dense_gate else ml_ds
        res = quick_measure_model(self._make_eval(), ds, rng=42, user_frac=0.5, device=self.device)
        ndcg = float(res.list_summary().loc["NDCG@20", "mean"])
        assert ndcg >= self.expected_ndcg
