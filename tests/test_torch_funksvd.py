"""The port's FunkSVD (``lkpy_tpu_torch.ops.funksvd.train_feature`` and
``lkpy_tpu_torch.models.funksvd``) against the JAX package's on the CPU.

Both packages get the same synthetic ratings, made with numpy from a seed
(60 users × 40 items, a few items without a rating).  Tolerances:
``train_feature`` after 3 epochs within rtol 1e-5 (float32 sums in another
order); scorers trained by both packages within 1e-4 relative Frobenius
on each table; scores of a scorer built from the JAX scorer's arrays within
rtol 1e-5 with the same NaN pattern; batch lists equal to the JAX package's
wherever the score gap to the next rank exceeds 1e-4.
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
from lkpy_tpu.models.funksvd import FunkSVDScorer as JaxFunkSVD
from lkpy_tpu.ops.funksvd import train_feature as jax_train_feature
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch import recommend
from lkpy_tpu_torch.batch.device import device_recommend, supports_device_batch
from lkpy_tpu_torch.data import ItemList, Vocabulary, from_interactions_df
from lkpy_tpu_torch.models import FunkSVDScorer
from lkpy_tpu_torch.ops.funksvd import train_feature
from lkpy_tpu_torch.ops.gather_rows import gather_rows
from lkpy_tpu_torch.pipeline import Pipeline, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

N_USERS, N_ITEMS = 60, 40
UNKNOWN_USER, UNKNOWN_ITEM = 10_001, 99_999
CONFIG = dict(features=4, epochs=3, batch_size=64, learning_rate=0.01)
CPU = TrainingOptions(rng=42, device="cpu")
GAP = 1e-4


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 15, size=N_USERS)
    users = np.repeat(np.arange(N_USERS), lens)
    items = np.concatenate([rng.choice(N_ITEMS - 3, size=n, replace=False) for n in lens])
    ratings = (rng.integers(1, 11, size=len(users)) / 2.0).astype(np.float32)
    return pd.DataFrame({"user_id": users + 1, "item_id": items + 1, "rating": ratings})


def _clear(s: np.ndarray) -> np.ndarray:
    """Ranks whose score gaps to both neighbours exceed GAP (not the last)."""
    gap = np.abs(np.diff(s)) > GAP
    clear = np.ones(len(s), bool)
    clear[:-1] &= gap
    clear[1:] &= gap
    clear[-1:] = False
    return clear


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def data():
    df = _frame()
    return jax_from_df(df), from_interactions_df(df), df


@pytest.fixture(scope="module")
def trained(data):
    jds, tds, _ = data
    js = JaxFunkSVD(**CONFIG)
    js.train(jds, JaxTrainingOptions(rng=42))
    ts = FunkSVDScorer(**CONFIG)
    ts.train(tds, CPU)
    return js, ts


def _params(js) -> dict:
    return {
        "user_embeddings": js.user_embeddings,
        "item_embeddings": js.item_embeddings,
        "global_bias": js.bias.global_bias,
        "item_biases": js.bias.item_biases,
        "user_biases": js.bias.user_biases,
    }


@pytest.mark.parametrize("clamp", [None, (1.0, 5.0)])
@pytest.mark.parametrize("pad", [0, 13])
def test_train_feature_matches_jax(clamp, pad):
    rng = np.random.default_rng(3)
    n, batch, nu, ni = 320 - pad, 32, 25, 18
    users = rng.integers(0, nu, n).astype(np.int32)
    items = rng.integers(0, ni, n).astype(np.int32)
    ratings = rng.uniform(0.5, 5.0, n).astype(np.float32)
    est = rng.uniform(2.5, 4.0, n).astype(np.float32)
    pads = (-n) % batch

    def padded(a):
        return np.concatenate([a, np.zeros(pads, dtype=a.dtype)])

    mask = padded(np.ones(n, np.float32))
    u_col = rng.uniform(0.05, 0.15, nu).astype(np.float32)
    i_col = rng.uniform(0.05, 0.15, ni).astype(np.float32)
    rmin, rmax = clamp or (-np.inf, np.inf)
    args = (0.02, 0.015, rmin, rmax, nu, ni, 3, batch)
    want = jax_train_feature(
        *(jnp.asarray(padded(a)) for a in (users, items, ratings)), jnp.asarray(mask), jnp.asarray(padded(est)),
        jnp.asarray(u_col), jnp.asarray(i_col), jnp.float32(0.03), *args,
    )  # fmt: skip
    t = torch.from_numpy
    got = train_feature(
        t(padded(users).astype(np.int64)), t(padded(items).astype(np.int64)), t(padded(ratings)), t(mask), t(padded(est)),
        t(u_col), t(i_col), 0.03, *args,
    )  # fmt: skip
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    # the inputs are left as they were
    assert np.array_equal(u_col, t(u_col).numpy())


def test_train_feature_zero_epochs_keeps_the_columns():
    cols = torch.full((4,), 0.1)
    u, i, rmse = train_feature(*(torch.zeros(8, dtype=torch.int64),) * 2, *(torch.ones(8),) * 3, cols, cols, 0.0, 0.1, 0.1, 0.0, 5.0, 4, 4, 0, 4)
    assert torch.equal(u, cols) and torch.equal(i, cols) and float(rmse) == 0.0


def test_trained_tables_match_jax(trained):
    js, ts = trained
    assert ts.user_embeddings.device.type == "cpu" and ts.item_embeddings.dtype == torch.float32
    assert _rel(ts.user_embeddings.numpy(), js.user_embeddings) <= 1e-4
    assert _rel(ts.item_embeddings.numpy(), js.item_embeddings) <= 1e-4
    np.testing.assert_allclose(ts.bias.item_biases, js.bias.item_biases, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.bias.user_biases, js.bias.user_biases, rtol=1e-5, atol=1e-6)
    assert len(ts.feature_rmse) == CONFIG["features"] and np.isfinite(ts.feature_rmse).all()


def test_ranged_training_matches_jax(data):
    jds, tds, _ = data
    js = JaxFunkSVD(**CONFIG, range=(0.5, 5.0))
    js.train(jds, JaxTrainingOptions(rng=7))
    ts = FunkSVDScorer(**CONFIG, range=(0.5, 5.0))
    ts.train(tds, TrainingOptions(rng=7, device="cpu"))
    assert _rel(ts.user_embeddings.numpy(), js.user_embeddings) <= 1e-4
    assert _rel(ts.item_embeddings.numpy(), js.item_embeddings) <= 1e-4


def test_scores_from_jax_arrays(data, trained):
    jds, tds, _ = data
    js, _ = trained
    ts = FunkSVDScorer.from_numpy(_params(js), js.config.model_dump(), tds.users, tds.items, device="cpu")
    ids = np.r_[np.arange(1, N_ITEMS + 1), UNKNOWN_ITEM]
    for user in (1, 17, UNKNOWN_USER):
        got = ts(user, ItemList(item_ids=ids)).scores()
        want = js(user, JaxItemList(item_ids=ids)).scores()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isnan(ts(UNKNOWN_USER, ItemList(item_ids=ids)).scores()).all()


def test_per_query_call_gathers_the_candidates(trained, monkeypatch):
    import lkpy_tpu_torch.models.funksvd as module

    _, ts = trained
    calls = []
    monkeypatch.setattr(module, "gather_rows", lambda table, idx: calls.append(len(idx)) or gather_rows(table, idx))
    ts(3, ItemList(item_ids=[1, 2, UNKNOWN_ITEM]))
    # one row gather a call, of the known candidates (on the card P launches once: tests/test_torch_cuda.py)
    assert calls == [2]


def test_device_recommend_matches_jax(data, trained):
    jds, tds, _ = data
    js, _ = trained
    ts = FunkSVDScorer.from_numpy(_params(js), js.config.model_dump(), tds.users, tds.items, device="cpu")
    assert supports_device_batch(ts)
    users = np.r_[np.arange(1, N_USERS + 1, 3), UNKNOWN_USER]
    got = device_recommend(ts, users, 10, tds.interaction_matrix(), device="cpu")
    want = jax_device_recommend(js, users, 10, jds.interaction_matrix(), exact=True)
    for u in users:
        g, w = got.lookup(u), want.lookup(u)
        assert len(g) == len(w)
        s = w.scores()
        clear = _clear(s)
        assert np.array_equal(np.asarray(g.ids())[clear], np.asarray(w.ids())[clear])
        np.testing.assert_allclose(g.scores(), s, rtol=1e-5, atol=1e-5)
    assert len(got.lookup(UNKNOWN_USER)) == 0


def test_pipeline_routes_agree_and_round_trip(data):
    _, tds, _ = data
    pipe = topn_pipeline(FunkSVDScorer(**CONFIG), n=5)
    pipe.train(tds, CPU)
    users = tds.users.ids[:8]
    batch = recommend(pipe, users, n=5)
    for u in users:
        one = lkpy_tpu_torch.recommend(pipe, u, n=5)
        np.testing.assert_allclose(one.scores(), batch.lookup(u).scores(), rtol=1e-5)
    again = Pipeline.from_config(pipe.get_config())
    assert again.config_hash() == pipe.config_hash()
    assert again.node("scorer").component.config.batch_size == 64
    scorer = pipe.node("scorer").component
    back = pickle.loads(pickle.dumps(scorer))
    np.testing.assert_array_equal(back(2, ItemList(item_ids=[1, 2])).scores(), scorer(2, ItemList(item_ids=[1, 2])).scores())


def test_runs_on_the_card_unless_told_cpu(data, monkeypatch):
    _, tds, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FunkSVDScorer(**CONFIG).train(tds, TrainingOptions())
    params = {"user_embeddings": np.zeros((2, 2)), "item_embeddings": np.zeros((2, 2)), "global_bias": 0.0,
              "item_biases": np.zeros(2), "user_biases": np.zeros(2)}  # fmt: skip
    with pytest.raises(RuntimeError, match="CUDA"):
        FunkSVDScorer.from_numpy(params, None, Vocabulary([1, 2]), Vocabulary([1, 2]))
