"""The user's path through the port against the JAX package on the CPU:
``topn_pipeline`` → ``Pipeline.train`` → ``recommend``, ``predict_pipeline``
→ ``predict``, and the component configs (``embedding_size_exp``).

Both packages get the same synthetic interactions, made with numpy from a
seed, and the same training seed; a pipeline derives each component's seed
from its node name in both.  The port trains with
``TrainingOptions(device="cpu")``, so its kernels' plain versions run.
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
from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import ItemListCollection as JaxILC
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models.als import BiasedMFScorer as JaxBiasedMF
from lkpy_tpu.models.als import ImplicitMFScorer as JaxImplicitMF
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch import predict, recommend
from lkpy_tpu_torch.data import ItemList, ItemListCollection, from_interactions_df
from lkpy_tpu_torch.models.als import BiasedMFScorer, ImplicitMFScorer
from lkpy_tpu_torch.pipeline import Pipeline, predict_pipeline, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

UNKNOWN = [10_001, 10_002]


def _frame(seed=0, n_users=150, n_items=80):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, size=n_users) + 3, n_items // 2)
    users = np.repeat(np.arange(n_users), lens)
    items = np.concatenate([rng.choice(n_items, size=n, replace=False) for n in lens])
    ratings = (rng.integers(1, 11, size=len(users)) / 2.0).astype(np.float32)
    return pd.DataFrame({"user_id": users + 1, "item_id": items + 1, "rating": ratings})


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_lists_agree(got, want, n):
    """Equal ids wherever the score gap to the next rank exceeds 1e-4, and
    scores within 1e-4 relative."""
    assert len(got) == len(want)
    s_got, s_want = got.scores(), want.scores()
    np.testing.assert_allclose(s_got, s_want, rtol=1e-4, atol=1e-6)
    gap = np.abs(np.diff(s_want)) > 1e-4
    clear = np.ones(len(want), bool)
    clear[:-1] &= gap
    clear[1:] &= gap
    if len(want) == n:
        clear[-1] = False  # the rank below the last is not known
    np.testing.assert_array_equal(np.asarray(got.ids())[clear], np.asarray(want.ids())[clear])


@pytest.fixture(scope="module")
def implicit():
    df = _frame()
    jp = lkpy_tpu.topn_pipeline(JaxImplicitMF(features=8, epochs=3), n=10)
    jp.train(jax_from_df(df), JaxTrainingOptions(rng=42))
    tp = topn_pipeline(ImplicitMFScorer(features=8, epochs=3), n=10)
    tp.train(from_interactions_df(df), TrainingOptions(rng=42, device="cpu"))
    users = np.concatenate([df["user_id"].unique()[:40], UNKNOWN])
    return jp, tp, users


def test_trained_factors_match_jax(implicit):
    jp, tp, _ = implicit
    js, ts = jp.node("scorer").component, tp.node("scorer").component
    assert ts.item_embeddings.device.type == "cpu"
    # 3 epochs: within 1e-3 relative Frobenius, as the training tests hold them
    assert _rel(ts.item_embeddings.numpy(), js.item_embeddings) <= 1e-3
    assert _rel(ts.user_embeddings.numpy(), js.user_embeddings) <= 1e-3


def test_batch_route_runner_route_and_jax_agree(implicit):
    jp, tp, users = implicit
    fast = recommend(tp, users, n=10)
    slow = recommend(tp, users, n=10, device=False)
    ref = jax_batch_recommend(jp, users, n=10)
    assert type(fast).__name__ == "ArrayTopNILC" and type(slow).__name__ == "ItemListCollection"
    for u in users:
        if u in UNKNOWN:
            assert len(fast.lookup(u)) == len(slow.lookup(u)) == len(ref.lookup(u)) == 0
            continue
        assert len(fast.lookup(u)) == 10
        _assert_lists_agree(fast.lookup(u), slow.lookup(u), 10)
        _assert_lists_agree(fast.lookup(u), ref.lookup(u), 10)


def test_per_query_recommend(implicit):
    jp, tp, users = implicit
    for u in users[:5]:
        got = lkpy_tpu_torch.recommend(tp, u, n=10)
        _assert_lists_agree(got, lkpy_tpu.recommend(jp, u, n=10), 10)
    assert len(lkpy_tpu_torch.recommend(tp, UNKNOWN[0], n=10)) == 0


@pytest.mark.parametrize("fallback", [True, False])
def test_predict_pipeline_matches_jax(fallback):
    df = _frame(seed=3)
    jp = lkpy_tpu.predict_pipeline(JaxBiasedMF(features=6, epochs=3, damping=5.0), fallback=fallback)
    jp.train(jax_from_df(df), JaxTrainingOptions(rng=7))
    tp = predict_pipeline(BiasedMFScorer(features=6, epochs=3, damping=5.0), fallback=fallback)
    tp.train(from_interactions_df(df), TrainingOptions(rng=7, device="cpu"))
    rng = np.random.default_rng(4)
    keys = [1, 2, 3, 50, UNKNOWN[0]]
    items = {u: np.append(rng.choice(df["item_id"].unique(), 6, replace=False), 99_999) for u in keys}
    got = predict(tp, ItemListCollection.from_dict({u: ItemList(item_ids=i) for u, i in items.items()}))
    want = jax_batch_predict(jp, JaxILC.from_dict({u: JaxItemList(item_ids=i) for u, i in items.items()}))
    nans = 0
    for u in keys:
        g, w = got.lookup(u).scores(), want.lookup(u).scores()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)], rtol=1e-4, atol=1e-4)
        nans += int(np.isnan(g).sum())
    assert (nans == 0) == fallback  # without the bias fallback, unknown items and users stay NaN


def test_config_round_trip_hash_and_pickle(implicit):
    _, tp, users = implicit
    cfg = tp.get_config()
    assert cfg.components["scorer"].code == "lkpy_tpu_torch.models.als:ImplicitMFScorer"
    again = Pipeline.from_config(cfg)
    assert again.config_hash() == tp.config_hash() == Pipeline.from_config(cfg.model_dump()).config_hash()
    assert again.node("scorer").component.config == tp.node("scorer").component.config
    assert not again.node("scorer").component.is_trained
    back = pickle.loads(pickle.dumps(tp))
    assert torch.equal(back.node("scorer").component.item_embeddings, tp.node("scorer").component.item_embeddings)
    a, b = recommend(back, users, n=10), recommend(tp, users, n=10)
    assert [list(il.ids()) for il in a.lists()] == [list(il.ids()) for il in b.lists()]


@pytest.mark.parametrize("port, ref", [(ImplicitMFScorer, JaxImplicitMF), (BiasedMFScorer, JaxBiasedMF)])
def test_embedding_size_exp_matches_jax(port, ref):
    got = port(embedding_size_exp=5, epochs=2).config
    want = ref(embedding_size_exp=5, epochs=2).config
    assert got.embedding_size == want.embedding_size == 32
    assert got.model_dump() == want.model_dump()
    assert port({"embedding_size_exp": 3}).config.embedding_size == 8


def test_runner_takes_a_data_frame_of_queries(implicit):
    from lkpy_tpu.batch import BatchPipelineRunner as JaxRunner
    from lkpy_tpu_torch.batch import BatchPipelineRunner

    jp, tp, users = implicit
    rng = np.random.default_rng(12)
    frame = pd.DataFrame(
        {"user_id": np.repeat(users[:6], 4), "item_id": rng.integers(1, 81, 24), "rating": rng.uniform(1, 5, 24)}
    )
    runs = []
    for runner_cls, pipe, queries in [
        (JaxRunner, jp, frame),
        (BatchPipelineRunner, tp, frame),
        (BatchPipelineRunner, tp, ItemListCollection.from_df(frame)),
    ]:
        runner = runner_cls(progress=False)
        runner.recommend(n=10)
        runner.score()
        runs.append(runner.run(pipe, queries))
    want, got, by_ilc = runs
    assert got.outputs == want.outputs == ["recommendations", "scores"]
    for u in users[:6]:
        # test items feed score, never recommend
        _assert_lists_agree(got.output("recommendations").lookup(u), want.output("recommendations").lookup(u), 10)
        a, b = got.output("scores").lookup(u), want.output("scores").lookup(u)
        np.testing.assert_array_equal(a.ids(), frame.loc[frame.user_id == u, "item_id"].to_numpy())
        np.testing.assert_array_equal(a.ids(), b.ids())
        np.testing.assert_array_equal(a.field("rating"), b.field("rating"))
        # the tables agree within 1e-3 relative after 3 epochs (test_trained_factors_match_jax)
        np.testing.assert_allclose(a.scores(), b.scores(), rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(by_ilc.output("scores").lookup(u).scores(), a.scores())
