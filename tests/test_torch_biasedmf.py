"""The port's explicit model family (``BiasedMFScorer``, its trainer and
fold-in, per-query scoring) against the JAX package on the CPU, where the
JAX package solves with LAPACK Cholesky and the port with its kernels' plain
versions.  Inputs are made with numpy from a seed and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.batch.device import device_recommend as jax_device_recommend
from lkpy_tpu.batch.device import supports_device_batch as jax_supports_device_batch
from lkpy_tpu.data import DatasetBuilder as JaxDatasetBuilder
from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import RecQuery as JaxRecQuery
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.models import als as jax_models
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch.batch.device import device_recommend, supports_device_batch
from lkpy_tpu_torch.data import DatasetBuilder, ItemList, RecQuery, from_interactions_df
from lkpy_tpu_torch.models import als as models
from lkpy_tpu_torch.models.als import BiasedMFScorer, ImplicitMFScorer
from lkpy_tpu_torch.ops.spd_solve import spd_solve
from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

K = 12
#: score tolerance of the serving comparison: the fold-in systems are solved
#: with differently ordered f32 arithmetic
SCORE_TOL = 1e-3
GAP = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ratings_df(seed=0, n_users=150, n_items=90):
    """Skewed histories (some past 64 items, so two serving rungs) with
    ratings from item quality, user shift and a planted rank-3 term."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.4, size=n_users) + 3, n_items - 10)
    lens[:4] = 70
    u = np.repeat(np.arange(n_users), lens)
    i = np.concatenate([rng.choice(n_items, size=n, replace=False) for n in lens])
    up, vp = rng.normal(size=(n_users, 3)), rng.normal(size=(n_items, 3))
    r = 3.5 + rng.normal(0, 0.5, n_items)[i] + rng.normal(0, 0.3, n_users)[u] + 0.35 * np.sum(up[u] * vp[i], axis=1)
    r = np.clip(r + rng.normal(0, 0.3, len(u)), 0.5, 5.0).astype(np.float32)
    return pd.DataFrame({"user_id": u * 2 + 10, "item_id": i + 7000, "rating": r})


@pytest.fixture(scope="module")
def frames():
    df = _ratings_df()
    return df, jax_from_df(df), from_interactions_df(df)


@pytest.fixture(scope="module")
def jax_trained(frames):
    _, jds, _ = frames
    js = jax_models.BiasedMFScorer(features=K, epochs=3)
    js.train(jds, JaxTrainingOptions(rng=42))
    return js


def _carry(js, tds, user_embeddings=True):
    """The port's scorer from a JAX-trained one, and a JAX scorer of the same
    ``user_embeddings`` setting on the same parameters."""
    cfg = {"features": K, "epochs": 3, "user_embeddings": user_embeddings}
    ref = jax_models.BiasedMFScorer(jax_models.BiasedMFScorer.validate_config(cfg))
    ref.users, ref.items, ref.bias = js.users, js.items, js.bias
    ref.user_embeddings, ref.item_embeddings = js.user_embeddings, js.item_embeddings
    params = {
        "user_embeddings": js.user_embeddings,
        "item_embeddings": js.item_embeddings,
        "global_bias": js.bias.global_bias,
        "item_biases": js.bias.item_biases,
        "user_biases": js.bias.user_biases,
    }
    return ref, BiasedMFScorer.from_numpy(params, cfg, tds.users, tds.items, device="cpu")


@pytest.mark.parametrize("B,H", [(9, 16), (4, 70)])
def test_fold_explicit_kernel_matches_jax(B, H):
    rng = np.random.default_rng(B * H)
    n_items = 60
    lens = rng.integers(1, H + 1, size=B)
    mask = np.arange(H)[None, :] < lens[:, None]
    cols = np.where(mask, rng.integers(0, n_items, size=(B, H)), 0).astype(np.int32)
    vals = np.where(mask, rng.integers(1, 11, size=(B, H)) / 2.0, 0.0).astype(np.float32)
    i_emb = (rng.standard_normal((n_items, K)) * 0.4).astype(np.float32)
    i_bias = (rng.standard_normal(n_items) * 0.3).astype(np.float32)
    ju, jb = jax_models._fold_explicit_kernel(
        *map(jnp.asarray, (cols, vals, mask, i_emb, i_bias)), jnp.float32(3.4), jnp.float32(5.0), jnp.float32(0.1)
    )
    before = spd_solve.launches
    tu, tb = models._fold_explicit_kernel(
        torch.from_numpy(cols).long(), torch.from_numpy(vals), torch.from_numpy(mask), torch.from_numpy(i_emb),
        torch.from_numpy(i_bias), 3.4, 5.0, 0.1,
    )  # fmt: skip
    assert spd_solve.launches == before  # CPU tensors take the plain version
    # the solve's tolerance: Cholesky in two differently ordered f32 forms
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("epochs,tol", [(1, 1e-4), (3, 1e-3)])
@pytest.mark.parametrize("user_embeddings", [True, False])
def test_train_matches_jax(frames, epochs, tol, user_embeddings):
    _, jds, tds = frames
    cfg = {"features": K, "epochs": epochs, "damping": {"user": 4.0, "item": 6.0}, "user_embeddings": user_embeddings}
    js = jax_models.BiasedMFScorer(jax_models.BiasedMFScorer.validate_config(cfg))
    js.train(jds, JaxTrainingOptions(rng=42))
    ts = BiasedMFScorer(cfg)
    assert not ts.is_trained
    before = spd_solve_chunked.launches
    ts.train(tds, TrainingOptions(rng=42, device="cpu"))
    assert spd_solve_chunked.launches == before
    assert ts.is_trained and ts.item_embeddings.device.type == "cpu"
    np.testing.assert_array_equal(ts.items.ids, js.items.ids)
    assert _rel(ts.item_embeddings.numpy(), js.item_embeddings) <= tol
    if user_embeddings:
        assert _rel(ts.user_embeddings.numpy(), js.user_embeddings) <= tol
    else:
        assert ts.user_embeddings is None and js.user_embeddings is None
    assert ts.bias.global_bias == pytest.approx(js.bias.global_bias, rel=1e-6)
    np.testing.assert_allclose(ts.bias.item_biases, js.bias.item_biases, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.bias.user_biases, js.bias.user_biases, rtol=1e-5, atol=1e-6)
    assert supports_device_batch(ts) == jax_supports_device_batch(js) == bool(user_embeddings)


def test_trainer_starts_from_unit_rows_and_needs_ratings(frames):
    df, _, tds = frames
    trainer = BiasedMFScorer(features=K, epochs=1).create_trainer(tds, TrainingOptions(rng=1, device="cpu"))
    for tab in (trainer.u_factors, trainer.i_factors):
        torch.testing.assert_close(tab.norm(dim=1), torch.ones(tab.shape[0]), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        BiasedMFScorer(features=K).train(from_interactions_df(df.drop(columns="rating")), TrainingOptions(device="cpu"))
    with pytest.raises(TypeError):
        BiasedMFScorer(models.ImplicitMFConfig())


def _compare_recs(got, ref, n, n_items):
    assert len(got) == len(ref)
    for (gk, gl), (rk, rl) in zip(got.items(), ref.items()):
        assert gk.user_id == rk.user_id
        assert len(gl) == len(rl)
        gs, rs = gl.scores(), rl.scores()
        np.testing.assert_allclose(gs, rs, rtol=SCORE_TOL, atol=SCORE_TOL)
        if len(rs) > 1:
            gaps = np.abs(np.diff(rs))
            clear = np.ones(len(rs), bool)
            clear[:-1] &= gaps > GAP
            clear[1:] &= gaps > GAP
            if len(rs) == min(n, n_items):
                clear[-1] = False  # the cut-off may fall inside a tie
            np.testing.assert_array_equal(gl.ids()[clear], rl.ids()[clear])


@pytest.mark.parametrize("user_embeddings", [True, "prefer"])
@pytest.mark.parametrize("n", [10, 200])
def test_device_recommend_matches_jax(frames, jax_trained, user_embeddings, n):
    _, jds, tds = frames
    ref_scorer, scorer = _carry(jax_trained, tds, user_embeddings)
    users = np.concatenate([jds.users.ids[::2], [-3, 10**7]])
    ref = jax_device_recommend(ref_scorer, users, n, jds.interaction_matrix(), chunk=16)
    got = device_recommend(scorer, users, n, tds.interaction_matrix(), chunk=16, device="cpu")
    _compare_recs(got, ref, n, tds.item_count)
    matrix = tds.interaction_matrix()
    for key, il in got.items():
        hist = matrix.row_items(key.user_id)
        if hist is None:
            assert len(il) == 0
        else:
            assert len(il) == min(n, tds.item_count - len(hist))
            assert not np.isin(il.ids(), hist.ids()).any()


def test_users_without_history_get_what_jax_gives(frames, jax_trained):
    # a user the matrix knows but who has no ratings has a singular fold-in
    # system (A = 0): both packages give an empty list, as to an unknown
    # user, and finite lists to everyone else in the block
    df, _, tds = frames
    ref_scorer, scorer = _carry(jax_trained, tds)
    extra = np.array([4001, 4002])

    def build(cls):
        b = cls()
        b.add_entities("user", np.concatenate([np.unique(df["user_id"]), extra]))
        b.add_entities("item", np.unique(df["item_id"]))
        b.add_interactions("rating", df, entities=["user", "item"], default=True)
        return b.build()

    jds2, tds2 = build(JaxDatasetBuilder), build(DatasetBuilder)
    np.testing.assert_array_equal(tds2.items.ids, tds.items.ids)
    users = np.concatenate([extra[:1], df["user_id"].unique()[:20], extra[1:], [-9]])
    ref = jax_device_recommend(ref_scorer, users, 8, jds2.interaction_matrix(), chunk=8)
    got = device_recommend(scorer, users, 8, tds2.interaction_matrix(), chunk=8, device="cpu")
    _compare_recs(got, ref, 8, tds.item_count)
    for uid in [*extra, -9]:
        assert len(got.lookup(uid)) == 0 and len(ref.lookup(uid)) == 0
    assert all(len(got.lookup(u)) == 8 for u in users[1:21])


def _query_cases(df, item_list, rec_query):
    uid = int(df["user_id"].iloc[0])
    rows = df[df["user_id"] == uid]
    hist = item_list(item_ids=rows["item_id"].to_numpy(), rating=rows["rating"].to_numpy())
    other = item_list(item_ids=np.array([7001, 7005, 424242, 7033]), rating=np.array([4.5, 2.0, 3.0, 5.0], np.float32))
    no_ratings = item_list(item_ids=np.array([7001, 7005]))
    return {
        "known user": uid,
        "known user, history": rec_query(user_id=uid, user_items=hist),
        "unknown user, history": rec_query(user_id=-4, user_items=other),
        "history alone": other,
        "unknown user": -4,
        "no query": None,
        "empty history": rec_query(user_id=-4, user_items=item_list(item_ids=np.array([], np.int64))),
        "history without ratings": rec_query(user_id=uid, user_items=no_ratings),
    }


@pytest.mark.parametrize("user_embeddings", [True, "prefer"])
def test_biasedmf_call_matches_jax(frames, jax_trained, user_embeddings):
    df, _, tds = frames
    ref_scorer, scorer = _carry(jax_trained, tds, user_embeddings)
    ids = np.array([7000, 7003, 999_999, 7040, 7011])  # one unknown item
    jq, tq = _query_cases(df, JaxItemList, JaxRecQuery), _query_cases(df, ItemList, RecQuery)
    for name in jq:
        ref = ref_scorer(jq[name], JaxItemList(item_ids=ids))
        got = scorer(tq[name], ItemList(item_ids=ids))
        np.testing.assert_array_equal(got.ids(), ref.ids())
        np.testing.assert_array_equal(np.isnan(got.scores()), np.isnan(ref.scores()), err_msg=name)
        np.testing.assert_allclose(got.scores(), ref.scores(), rtol=1e-4, atol=1e-5, err_msg=name)
        no_row = name in ("unknown user", "no query", "empty history")
        if user_embeddings == "prefer":  # the history is not folded in
            no_row = no_row or name in ("unknown user, history", "history alone")
        if no_row:
            assert np.isnan(got.scores()).all()  # neither row nor usable history
        else:
            assert np.isnan(got.scores()).tolist() == [False, False, True, False, False]


@pytest.mark.parametrize("use_ratings", [False, True])
def test_implicit_call_matches_jax(frames, use_ratings):
    df, jds, tds = frames
    cfg = {"features": K, "epochs": 2, "use_ratings": use_ratings, "weight": 10.0}
    js = jax_models.ImplicitMFScorer(jax_models.ImplicitMFScorer.validate_config(cfg))
    js.train(jds, JaxTrainingOptions(rng=3))
    params = {"user_embeddings": js.user_embeddings, "item_embeddings": js.item_embeddings, "_OtOr": js._OtOr}
    ts = ImplicitMFScorer.from_numpy(params, cfg, tds.users, tds.items, device="cpu")
    ids = np.array([7000, 7003, 999_999, 7040, 7011])
    jq, tq = _query_cases(df, JaxItemList, JaxRecQuery), _query_cases(df, ItemList, RecQuery)
    for name in jq:
        if use_ratings and name == "history without ratings":
            with pytest.raises(ValueError):
                ts(tq[name], ItemList(item_ids=ids))
            continue
        ref = js(jq[name], JaxItemList(item_ids=ids))
        got = ts(tq[name], ItemList(item_ids=ids))
        np.testing.assert_array_equal(np.isnan(got.scores()), np.isnan(ref.scores()), err_msg=name)
        np.testing.assert_allclose(got.scores(), ref.scores(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_batch_fold_in_equals_per_query_fold_in(frames, jax_trained):
    # the batched kernel and new_user_embedding give one user the same
    # embedding and bias (damped user bias removed before the solve in both)
    df, _, tds = frames
    _, scorer = _carry(jax_trained, tds)
    matrix = tds.interaction_matrix()
    uids = df["user_id"].unique()[:12]
    hists = [matrix.row_items(u) for u in uids]
    H = max(len(h) for h in hists)
    cols = np.zeros((len(uids), H), np.int64)
    vals = np.zeros((len(uids), H), np.float32)
    mask = np.zeros((len(uids), H), bool)
    for r, h in enumerate(hists):
        cols[r, : len(h)], vals[r, : len(h)], mask[r, : len(h)] = h.numbers(), h.field("rating"), True
    emb, ub = scorer.device_fold_in(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(mask))
    for r, h in enumerate(hists):
        want_emb, want_ub = scorer.new_user_embedding(None, h)
        np.testing.assert_allclose(emb[r].numpy(), want_emb, rtol=5e-3, atol=5e-4)
        assert float(ub[r]) == pytest.approx(want_ub, rel=1e-5, abs=1e-6)
    with pytest.raises(ValueError):
        scorer.device_fold_in(torch.from_numpy(cols), None, torch.from_numpy(mask))
