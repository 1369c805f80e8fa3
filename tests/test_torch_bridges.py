"""The port's ``hpfrec`` and ``implicit`` bridges (``lkpy_tpu_torch.models.hpf``,
``lkpy_tpu_torch.models.implicit_bridge``) against the JAX package's on the
CPU, as ``tests/models/test_bridges.py`` holds the JAX package's: neither
package is installed, so ``train`` raises the same ImportError, and the
adapter (the matrix or frame handed to ``fit``, the factors taken back,
scoring, unknown users and items) runs against fake models injected at the
import seams.  Both packages' scores from the same fake factors are equal.
"""

import sys
from types import ModuleType

import numpy as np
import pandas as pd
import pytest

from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models import hpf as jax_hpf
from lkpy_tpu.models import implicit_bridge as jax_bridge
from lkpy_tpu_torch.data import ItemList, from_interactions_df
from lkpy_tpu_torch.models.hpf import HPFScorer
from lkpy_tpu_torch.models.implicit_bridge import ALS, BPR
from lkpy_tpu_torch.training import TrainingOptions

FRAME = pd.DataFrame(
    {
        "user_id": [1, 1, 2, 2, 3, 3, 3],
        "item_id": [10, 20, 10, 30, 20, 30, 40],
        "rating": [4.0, 3.0, 5.0, 2.0, 3.5, 4.5, 1.0],
    }
)


class _FakeImplicitModel:
    """Stands in for implicit's AlternatingLeastSquares/BPR."""

    def __init__(self, factors):
        self.factors = factors
        self.fit_calls = []

    def fit(self, matrix, show_progress=True):
        self.fit_calls.append(matrix)
        n_u, n_i = matrix.shape
        rng = np.random.default_rng(0)
        self.user_factors = rng.normal(size=(n_u, self.factors)).astype(np.float32)
        self.item_factors = rng.normal(size=(n_i, self.factors)).astype(np.float32)


class _FakeHPF:
    last = None

    def __init__(self, k, reindex, verbose):
        self.k = k
        self.reindex = reindex
        _FakeHPF.last = self

    def fit(self, df):
        self.fit_df = df
        rng = np.random.default_rng(1)
        self.Theta = rng.gamma(1.0, size=(int(df["UserId"].max()) + 1, self.k)).astype(np.float32)
        self.Beta = rng.gamma(1.0, size=(int(df["ItemId"].max()) + 1, self.k)).astype(np.float32)


@pytest.mark.parametrize("name", ["ALS", "BPR"])
def test_implicit_bridge_contract(name, monkeypatch):
    cls, jcls = {"ALS": (ALS, jax_bridge.ALS), "BPR": (BPR, jax_bridge.BPR)}[name]
    ds = from_interactions_df(FRAME)
    scorer = cls(cls.validate_config({"factors": 8}))
    fake = _FakeImplicitModel(8)
    monkeypatch.setattr(cls, "_construct", lambda self: fake)
    scorer.train(ds)
    assert len(fake.fit_calls) == 1
    m = fake.fit_calls[0]
    assert m.shape == (ds.user_count, ds.item_count) and m.dtype == np.float32
    assert scorer.user_factors.shape == (3, 8) and scorer.item_factors.shape == (4, 8)
    scorer.train(ds, TrainingOptions(retrain=False))
    assert len(fake.fit_calls) == 1

    jscorer = jcls(jcls.validate_config({"factors": 8}))
    jfake = _FakeImplicitModel(8)
    monkeypatch.setattr(jcls, "_construct", lambda self: jfake)
    jscorer.train(jax_from_df(FRAME))
    assert type(m) is type(jfake.fit_calls[0]) and (m != jfake.fit_calls[0]).nnz == 0
    for user in (1, 3, 999):
        got = scorer(user, ItemList(item_ids=[10, 30, 999])).scores()
        want = jscorer(user, JaxItemList(item_ids=[10, 30, 999])).scores()
        np.testing.assert_array_equal(got, want)
    assert np.isnan(scorer(999, ItemList(item_ids=[10, 20])).scores()).all()


def test_implicit_bridge_errors_without_package():
    ds = from_interactions_df(FRAME)
    for cls, jcls in ((ALS, jax_bridge.ALS), (BPR, jax_bridge.BPR)):
        with pytest.raises(ImportError, match="implicit") as got:
            cls(cls.validate_config({})).train(ds)
        with pytest.raises(ImportError, match="implicit") as want:
            jcls(jcls.validate_config({})).train(jax_from_df(FRAME))
        assert str(got.value) == str(want.value)


def test_hpf_bridge_contract(monkeypatch):
    mod = ModuleType("hpfrec")
    mod.HPF = _FakeHPF
    monkeypatch.setitem(sys.modules, "hpfrec", mod)
    ds = from_interactions_df(FRAME)
    scorer = HPFScorer(HPFScorer.validate_config({"features": 6}))
    scorer.train(ds)
    hpf = _FakeHPF.last
    assert not hpf.reindex
    assert list(hpf.fit_df.columns) == ["UserId", "ItemId", "Count"]
    assert hpf.fit_df["UserId"].max() == ds.user_count - 1
    assert scorer.user_features.shape == (3, 6) and scorer.item_features.shape == (4, 6)

    jscorer = jax_hpf.HPFScorer(jax_hpf.HPFScorer.validate_config({"features": 6}))
    jscorer.train(jax_from_df(FRAME))
    pd.testing.assert_frame_equal(hpf.fit_df.reset_index(drop=True), _FakeHPF.last.fit_df.reset_index(drop=True))
    for user in (2, 999):
        got = scorer(user, ItemList(item_ids=[10, 40, 999])).scores()
        want = jscorer(user, JaxItemList(item_ids=[10, 40, 999])).scores()
        np.testing.assert_array_equal(got, want)
    assert np.all(np.isnan(scorer(999, ItemList(item_ids=[10])).scores()))


def test_hpf_errors_without_package():
    with pytest.raises(ImportError, match="hpfrec") as got:
        HPFScorer(HPFScorer.validate_config({})).train(from_interactions_df(FRAME))
    with pytest.raises(ImportError, match="hpfrec") as want:
        jax_hpf.HPFScorer(jax_hpf.HPFScorer.validate_config({})).train(jax_from_df(FRAME))
    assert str(got.value) == str(want.value)


def test_scoring_from_factors_set_by_hand():
    ds = from_interactions_df(FRAME)
    jds = jax_from_df(FRAME)
    rng = np.random.default_rng(2)
    uf, itf = rng.random((3, 4)).astype(np.float32), rng.random((4, 4)).astype(np.float32)
    for port, jax in ((ALS(), jax_bridge.ALS()), (HPFScorer(), jax_hpf.HPFScorer())):
        names = ("user_factors", "item_factors") if isinstance(port, ALS) else ("user_features", "item_features")
        for obj, d in ((port, ds), (jax, jds)):
            obj.users, obj.items = d.users, d.items
            setattr(obj, names[0], uf)
            setattr(obj, names[1], itf)
        assert port.is_trained
        for user in (1, 2, 3):
            got = port(user, ItemList(item_ids=[40, 10, 7])).scores()
            np.testing.assert_array_equal(got, jax(user, JaxItemList(item_ids=[40, 10, 7])).scores())
