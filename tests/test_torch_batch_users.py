"""``lkpy_tpu_torch.batch.recommend`` with the users given in each form
(a one-pass iterator, ``split.test.keys()``, a list, an array) against the
JAX package's ``batch.recommend`` on a per-query pipeline.

The set: 60 users × 40 items, 8 to 15 items a user, made with numpy from
seed 3.  ``topn_pipeline(ItemKNNScorer(feedback="implicit", max_nbrs=5),
n=5)`` takes the per-query route in both packages.  Lists hold the same
users; each list's scores agree within 1e-5 and its items are equal
wherever the gap to the next rank exceeds 1e-5 (ties have no promised
order).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu
from lkpy_tpu.batch import recommend as jax_recommend
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models.knn import ItemKNNScorer as JaxItemKNN
from lkpy_tpu.splitting import SampleN as JaxSampleN
from lkpy_tpu.splitting import sample_users as jax_sample_users
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch import topn_pipeline
from lkpy_tpu_torch.batch import recommend
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.models.knn import ItemKNNScorer
from lkpy_tpu_torch.splitting import SampleN, sample_users
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

GAP = 1e-5


def _frame():
    rng = np.random.default_rng(3)
    n_users, n_items = 60, 40
    lens = rng.integers(8, 16, n_users)
    users = np.repeat(np.arange(1, n_users + 1), lens)
    items = np.concatenate([rng.choice(n_items, n, replace=False) + 1 for n in lens])
    return pd.DataFrame({"user_id": users, "item_id": items})


@pytest.fixture(scope="module")
def pipes():
    df = _frame()
    jds, tds = jax_from_df(df), from_interactions_df(df)
    jp = lkpy_tpu.topn_pipeline(JaxItemKNN(feedback="implicit", max_nbrs=5), n=5)
    jp.train(jds, JaxTrainingOptions(rng=42))
    tp = topn_pipeline(ItemKNNScorer(feedback="implicit", max_nbrs=5), n=5)
    tp.train(tds, TrainingOptions(rng=42, device="cpu"))
    return jds, tds, jp, tp


def _same(got, want):
    assert len(got) == len(want) > 0
    gk = [k.user_id for k, _ in got.items()]
    wk = [k.user_id for k, _ in want.items()]
    assert gk == wk
    for (_, g), (_, w) in zip(got.items(), want.items()):
        s = w.scores()
        assert len(g) == len(w)
        np.testing.assert_allclose(g.scores(), s, rtol=GAP, atol=GAP)
        clear = np.ones(len(s), bool)
        gap = np.abs(np.diff(s)) > GAP
        clear[:-1] &= gap
        clear[1:] &= gap
        np.testing.assert_array_equal(np.asarray(g.ids())[clear], np.asarray(w.ids())[clear])


def test_one_pass_iterator_of_users(pipes):
    _, _, jp, tp = pipes
    got = recommend(tp, iter([1, 2, 3]), n=5)
    want = jax_recommend(jp, iter([1, 2, 3]), n=5)
    assert len(got) == 3
    _same(got, want)


def test_split_test_keys(pipes):
    jds, tds, jp, tp = pipes
    tsplit = sample_users(tds, 5, SampleN(2), rng=7)
    jsplit = jax_sample_users(jds, 5, JaxSampleN(2), rng=7)
    assert [k.user_id for k in tsplit.test.keys()] == [k.user_id for k in jsplit.test.keys()]
    got = recommend(tp, tsplit.test.keys(), n=5)
    want = jax_recommend(jp, jsplit.test.keys(), n=5)
    assert len(got) == 5
    _same(got, want)


@pytest.mark.parametrize("form", [list, np.asarray])
def test_list_and_array_unchanged(pipes, form):
    _, _, jp, tp = pipes
    users = form([5, 9, 12, 60])
    got = recommend(tp, users, n=5)
    _same(got, jax_recommend(jp, users, n=5))
    # the input itself is left as it was, and a second call gives the same lists
    assert list(users) == [5, 9, 12, 60]
    again = recommend(tp, users, n=5)
    for (_, a), (_, b) in zip(got.items(), again.items()):
        np.testing.assert_array_equal(a.ids(), b.ids())
