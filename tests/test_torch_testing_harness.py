"""The port's test harness (``lkpy_tpu_torch.testing``) against the JAX
package's (``lkpy_tpu.testing``) on the CPU.

- The hypothesis strategies: each package's strategy run under the same
  derandomized settings gives the same draws (their code is the same, so
  the same choice sequence builds the same value), built on each package's
  own ``CSR`` and ``ItemList``, which must hold equal arrays.
- ``set_env_var``, ``ml_test_dir`` and the grid's test names.
- The grid itself runs through its subclasses in ``test_torch_training.py``
  (``ImplicitMFScorer``) and ``test_torch_knn.py`` (``ItemKNNScorer``).
"""

import os

import numpy as np
import pytest
from hypothesis import HealthCheck, Phase, given, settings

import lkpy_tpu.testing as jax_testing
import lkpy_tpu.testing.arrays as jax_arrays
import lkpy_tpu_torch.testing as testing
import lkpy_tpu_torch.testing.arrays as arrays
from lkpy_tpu_torch.testing.components import GRID_ITEMS, synthetic_ratings

DRAWS = 40
SAME = settings(derandomize=True, database=None, max_examples=DRAWS, phases=[Phase.generate], suppress_health_check=list(HealthCheck), deadline=None)


def _draws(strategy) -> list:
    out = []

    @SAME
    @given(strategy)
    def collect(value):
        out.append(value)

    collect()
    return out


@pytest.mark.parametrize("kwargs", [{}, {"max_rows": 5, "max_cols": 7, "max_nnz": 20}])
def test_coo_arrays_and_sparse_csr_match_jax(kwargs):
    got, want = _draws(arrays.coo_arrays(**kwargs)), _draws(jax_arrays.coo_arrays(**kwargs))
    assert len(got) == len(want) == DRAWS
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]
        assert len(np.unique(g[0] * g[3][1] + g[1])) == len(g[0])
    got, want = _draws(arrays.sparse_csr(**kwargs)), _draws(jax_arrays.sparse_csr(**kwargs))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.nnz == w.nnz
        np.testing.assert_array_equal(g.rowptr, w.rowptr)
        np.testing.assert_array_equal(g.colind, w.colind)
        np.testing.assert_array_equal(g.values, w.values)


@pytest.mark.parametrize("scores", ["maybe", "yes", "no"])
def test_scored_lists_match_jax(scores):
    got, want = _draws(arrays.scored_lists(max_len=30, scores=scores)), _draws(jax_arrays.scored_lists(max_len=30, scores=scores))
    assert len(got) == len(want) == DRAWS
    for g, w in zip(got, want):
        assert type(g).__module__.startswith("lkpy_tpu_torch.")
        np.testing.assert_array_equal(g.ids(), w.ids())
        if w.scores() is None:
            assert g.scores() is None
        else:
            np.testing.assert_array_equal(g.scores(), w.scores())
    if scores == "yes":
        assert all(g.scores() is not None for g in got)


@pytest.mark.parametrize("value", ["x", None])
@pytest.mark.parametrize("before", ["old", None])
def test_set_env_var_matches_jax(monkeypatch, value, before):
    name = "LKT_HARNESS_PROBE"
    seen = []
    for mod in (testing, jax_testing):
        if before is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, before)
        with mod.set_env_var(name, value):
            inside = os.environ.get(name)
        seen.append((inside, os.environ.get(name)))
    assert seen[0] == seen[1] == (value, before)


def test_ml_test_dir_matches_jax(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for mod in (testing, jax_testing):
        with pytest.raises(FileNotFoundError):
            mod.ml_test_dir()
    (tmp_path / "data" / "ml-latest-small").mkdir(parents=True)
    assert testing.ml_test_dir() == jax_testing.ml_test_dir()
    assert testing.ml_test_dir().resolve() == (tmp_path / "data" / "ml-latest-small").resolve()


def _tests(cls) -> set[str]:
    return {n for n in dir(cls) if n.startswith("test_")}


def test_grid_has_the_jax_cases():
    for name in ("BasicComponentTests", "TrainingTests", "ScorerTests"):
        assert _tests(getattr(testing, name)) == _tests(getattr(jax_testing, name)), name
    assert set(testing.__all__) >= set(jax_testing.__all__)


def test_synthetic_ratings_holds_the_grid_items():
    ds = synthetic_ratings()
    assert ds.user_count == 120 and ds.interaction_count > 4000
    assert set(GRID_ITEMS) <= set(ds.user_row(1).ids())
    assert synthetic_ratings().interaction_count == ds.interaction_count
