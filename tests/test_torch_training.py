"""The port's training slice against the JAX package on the CPU.

One bucket through both packages' fused bucket step (the JAX one reaches the
Pallas training solve, run in interpret mode), whole ALS epochs in both
modes from the same tables, ``ImplicitMFScorer.train`` in both packages from
the same seed, parameters carried from the JAX trainer into the port's, and
the trained port scorer served by both packages.  Inputs are made with numpy
from a seed and handed to both.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from lkpy_tpu import random as jax_random
from lkpy_tpu.batch.device import device_recommend as jax_device_recommend
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.data.matrix import CSR as JaxCSR
from lkpy_tpu.models.als import ImplicitMFScorer as JaxImplicitMF
from lkpy_tpu.ops import als as jax_als
from lkpy_tpu.ops import sparse as jax_sparse
from lkpy_tpu.training import TrainingOptions as JaxTrainingOptions
from lkpy_tpu_torch import random as torch_random
from lkpy_tpu_torch.batch.device import device_recommend
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.models.als import ImplicitMFScorer
from lkpy_tpu_torch.ops import als as torch_als
from lkpy_tpu_torch.ops import sparse as torch_sparse
from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked
from lkpy_tpu_torch.training import TrainingOptions

torch.set_num_threads(1)

N_USERS, N_ITEMS, K = 300, 120, 16


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _interactions(seed, n_users=N_USERS, n_items=N_ITEMS):
    """Skewed random interactions with ratings in [0.5, 5]; a few users and
    items have none."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.5, size=n_users) + 2, n_items // 2)
    lens[::17] = 0
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.7
    pop[-5:] = 0.0
    pop /= pop.sum()
    users = np.repeat(np.arange(n_users), lens)
    items = np.concatenate([rng.choice(n_items, size=n, replace=False, p=pop) for n in lens])
    ratings = rng.integers(1, 11, size=len(users)) / 2.0
    return users, items, ratings.astype(np.float32)


def _matrices(mode, seed=0):
    """Both packages' (user × item, item × user) CSRs of the same data, with
    confidences (implicit) or centred ratings (explicit) as values."""
    u, i, r = _interactions(seed)
    vals = r * 40.0 if mode == "implicit" else r - r.mean()
    shape = (N_USERS, N_ITEMS)
    j, t = JaxCSR.from_coo(u, i, vals, shape), CSR.from_coo(u, i, vals, shape)
    return (j, j.transpose()), (t, t.transpose())


def _tables(mode, seed=1):
    rng = np.random.default_rng(seed)
    if mode == "implicit":
        return [(rng.standard_normal((n, K)) * 0.1).astype(np.float32) ** 2 for n in (N_USERS, N_ITEMS)]
    tabs = [rng.standard_normal((n, K)).astype(np.float32) for n in (N_USERS, N_ITEMS)]
    return [t / np.linalg.norm(t, axis=1, keepdims=True) for t in tabs]


@pytest.mark.parametrize("mode", ["implicit", "explicit"])
def test_bucket_step_matches_jax_fused_bucket(mode):
    (jcsr, _), (tcsr, _) = _matrices(mode)
    # a bucket in two chunks whose last chunk ends in padding rows
    jb = [b for b in jax_sparse.bucket_rows(jcsr, ratio=2.0) if b.width == 16][0]
    tb = [b for b in torch_sparse.bucket_rows(tcsr, ratio=2.0) if b.width == 16][0]
    jch = jax_als.chunk_buckets([jb], entries=16 * (jb.n // 2))[0]
    tch = torch_als.chunk_buckets([tb], entries=16 * (tb.n // 2), device="cpu")[0]
    assert tch.rows.shape[0] == 2 and (np.asarray(jch.rows) == np.iinfo(np.int32).max).any()
    left, right = _tables(mode)
    reg = 0.1
    if mode == "implicit":
        otor = jax_als.implicit_otor(jnp.asarray(right), jnp.float32(reg))
        ref_left, ref_dsq = jax_als._fused_bucket_implicit(
            jnp.asarray(left), jnp.float32(0.0), jch.rows, jch.cols, jch.values, jch.mask, jnp.asarray(right), otor
        )
    else:
        ref_left, ref_dsq = jax_als._fused_bucket_explicit(
            jnp.asarray(left), jnp.float32(0.0), jch.rows, jch.cols, jch.values, jch.mask, jnp.asarray(right), jnp.float32(reg)
        )
    before = spd_solve_chunked.launches
    got_left, got_dsq = torch_als._run_half(torch.from_numpy(left), torch.from_numpy(right), reg, (tch,), mode)
    assert spd_solve_chunked.launches == before  # CPU tensors take the plain version
    # blocked Gauss-Jordan (JAX) and Cholesky (port) round differently in f32
    assert np.isfinite(got_left.numpy()).all()
    np.testing.assert_allclose(got_left.numpy(), np.asarray(ref_left), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(got_dsq), float(ref_dsq), rtol=1e-4)
    # rows outside the bucket are untouched
    untouched = np.setdiff1d(np.arange(N_USERS), tb.rows)
    np.testing.assert_array_equal(got_left.numpy()[untouched], left[untouched])


@pytest.mark.parametrize("mode", ["implicit", "explicit"])
@pytest.mark.parametrize("epochs,tol", [(1, 1e-4), (3, 1e-3)])
def test_als_epoch_matches_jax(mode, epochs, tol):
    (ju, ji), (tu, ti) = _matrices(mode)
    jub = jax_als.chunk_buckets(jax_sparse.bucket_rows(ju, ratio=1.35))
    jib = jax_als.chunk_buckets(jax_sparse.bucket_rows(ji, ratio=1.35))
    tub = torch_als.chunk_buckets(torch_sparse.bucket_rows(tu, ratio=1.35), device="cpu")
    tib = torch_als.chunk_buckets(torch_sparse.bucket_rows(ti, ratio=1.35), device="cpu")
    u0, i0 = _tables(mode)
    ju_t, ji_t = jnp.asarray(u0), jnp.asarray(i0)
    tu_t, ti_t = torch.from_numpy(u0), torch.from_numpy(i0)
    for _ in range(epochs):
        ju_t, ji_t, jdu, jdi = jax_als.als_epoch(jub, jib, ju_t, ji_t, 0.1, 0.1, mode=mode)
        tu_t, ti_t, tdu, tdi = torch_als.als_epoch(tub, tib, tu_t, ti_t, 0.1, 0.1, mode=mode)
    assert isinstance(tdu, torch.Tensor) and tdu.ndim == 0  # deltas stay tensors
    assert _rel(tu_t.numpy(), ju_t) <= tol
    assert _rel(ti_t.numpy(), ji_t) <= tol
    np.testing.assert_allclose([float(tdu), float(tdi)], [float(jdu), float(jdi)], rtol=1e-4)
    # the inputs are not modified
    np.testing.assert_array_equal(torch.from_numpy(u0).numpy(), _tables(mode)[0])


def test_als_half_epoch_takes_buckets():
    (ju, _), (tu, _) = _matrices("implicit")
    u0, i0 = _tables("implicit")
    ref, ref_d = jax_als.als_half_epoch(jax_sparse.bucket_rows(ju), jnp.asarray(u0), jnp.asarray(i0), 0.1, mode="implicit")
    got, got_d = torch_als.als_half_epoch(
        torch_sparse.bucket_rows(tu), torch.from_numpy(u0), torch.from_numpy(i0), 0.1, mode="implicit"
    )
    assert isinstance(got_d, float)
    assert _rel(got.numpy(), ref) <= 1e-4
    np.testing.assert_allclose(got_d, ref_d, rtol=1e-4)
    with pytest.raises(ValueError, match="mode"):
        torch_als.als_half_epoch(torch_sparse.bucket_rows(tu), torch.from_numpy(u0), torch.from_numpy(i0), 0.1, mode="bpr")


@pytest.mark.parametrize("B,P", [(12, 16), (5, 40)])
def test_solve_explicit_bucket_matches_jax(B, P):
    rng = np.random.default_rng(B * P)
    lens = rng.integers(1, P + 1, size=B)
    mask = np.arange(P)[None, :] < lens[:, None]
    cols = np.where(mask, rng.integers(0, N_ITEMS, size=(B, P)), 0).astype(np.int32)
    vals = np.where(mask, rng.normal(size=(B, P)), 0.0).astype(np.float32)
    right = (rng.standard_normal((N_ITEMS, K)) * 0.3).astype(np.float32)
    ref = np.asarray(jax_als.solve_explicit_bucket(*map(jnp.asarray, (cols, vals, mask, right)), jnp.float32(0.1)))
    got = torch_als.solve_explicit_bucket(
        torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(mask), torch.from_numpy(right), 0.1
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-4)
    items = np.array([3, 7, 50])
    r = np.array([1.0, -0.5, 2.0], np.float32)
    np.testing.assert_array_equal(
        torch_als.solve_row_explicit(items, r, right, 0.1), jax_als.solve_row_explicit(items, r, right, 0.1)
    )
    otor = right.T @ right + 0.1 * np.eye(K, dtype=np.float32)
    np.testing.assert_array_equal(
        torch_als.solve_row_implicit(items, r + 2, right, otor), jax_als.solve_row_implicit(items, r + 2, right, otor)
    )
    assert not torch_als.solve_row_implicit(items[:0], r[:0], right, otor).any()


def _frame(use_ratings: bool):
    u, i, r = _interactions(4)
    df = pd.DataFrame({"user_id": u * 3 + 100, "item_id": i + 5000})
    if use_ratings:
        df["rating"] = r
    return df


@pytest.mark.parametrize(
    "use_ratings,user_embeddings", [(False, True), (True, True), (False, False), (True, "prefer")]
)
def test_scorer_train_matches_jax(use_ratings, user_embeddings):
    df = _frame(use_ratings)
    cfg = {"features": K, "epochs": 3, "use_ratings": use_ratings, "user_embeddings": user_embeddings}
    js = JaxImplicitMF(JaxImplicitMF.validate_config(cfg))
    js.train(jax_from_df(df), JaxTrainingOptions(rng=42))
    ts = ImplicitMFScorer(cfg)
    assert not ts.is_trained
    ts.train(from_interactions_df(df), TrainingOptions(rng=42, device="cpu"))
    assert ts.is_trained and ts.item_embeddings.device.type == "cpu"
    np.testing.assert_array_equal(ts.items.ids, js.items.ids)
    assert _rel(ts.item_embeddings.numpy(), js.item_embeddings) <= 1e-3
    assert _rel(ts._OtOr.numpy(), js._OtOr) <= 1e-3
    if user_embeddings:
        assert _rel(ts.user_embeddings.numpy(), js.user_embeddings) <= 1e-3
    else:
        assert ts.user_embeddings is None and js.user_embeddings is None


def test_parameters_carry_from_jax_trainer():
    df = _frame(False)
    js = JaxImplicitMF(features=K, epochs=3)
    jt = js.create_trainer(jax_from_df(df), JaxTrainingOptions(rng=42))
    jt.train_epoch()
    ts = ImplicitMFScorer(features=K, epochs=3)
    tt = ts.create_trainer(from_interactions_df(df), TrainingOptions(rng=7, device="cpu"))
    tt.load_parameters(jt.get_parameters())
    for _ in range(2):
        jt.train_epoch()
        tt.train_epoch()
    state = tt.get_parameters()
    assert _rel(state["user_factors"].numpy(), jt.get_parameters()["user_factors"]) <= 1e-3
    assert _rel(state["item_factors"].numpy(), jt.get_parameters()["item_factors"]) <= 1e-3
    jt.finalize()
    tt.finalize()
    assert _rel(ts._OtOr.numpy(), js._OtOr) <= 1e-3
    # the returned state is a copy: training on does not change it
    before = state["item_factors"].clone()
    tt.train_epoch()
    torch.testing.assert_close(state["item_factors"], before, rtol=0, atol=0)


@pytest.fixture(scope="module")
def trained_port():
    df = _frame(False)
    ts = ImplicitMFScorer(features=K, epochs=3)
    ts.train(from_interactions_df(df), TrainingOptions(rng=42, device="cpu"))
    return df, ts


@pytest.mark.parametrize("user_embeddings", [True, "prefer"])
def test_trained_scorer_serves_like_jax(trained_port, user_embeddings):
    df, fitted = trained_port
    jds, tds = jax_from_df(df), from_interactions_df(df)
    cfg = {"features": K, "epochs": 3, "user_embeddings": user_embeddings}
    ts = ImplicitMFScorer(cfg)
    ts.load_parameters(fitted.get_parameters())
    ts._OtOr, ts.users, ts.items = fitted._OtOr, fitted.users, fitted.items
    js = JaxImplicitMF(JaxImplicitMF.validate_config(cfg))
    js.users, js.items = jds.users, jds.items
    js.user_embeddings = fitted.user_embeddings.numpy()
    js.item_embeddings = fitted.item_embeddings.numpy()
    js._OtOr = fitted._OtOr.numpy()
    users = np.concatenate([jds.users.ids[::2], [-1]])
    ref = jax_device_recommend(js, users, 10, jds.interaction_matrix(), chunk=32)
    got = device_recommend(ts, users, 10, tds.interaction_matrix(), chunk=32, device="cpu")
    tol = 1e-4
    for (gk, gl), (rk, rl) in zip(got.items(), ref.items()):
        assert gk.user_id == rk.user_id and len(gl) == len(rl)
        rs = rl.scores()
        np.testing.assert_allclose(gl.scores(), rs, rtol=tol, atol=tol)
        if len(rs) > 1:
            gaps = np.abs(np.diff(rs))
            clear = np.ones(len(rs), bool)
            clear[:-1] &= gaps > tol
            clear[1:] &= gaps > tol
            clear[-1] = False  # the cut-off may fall inside a tie
            np.testing.assert_array_equal(gl.ids()[clear], rl.ids()[clear])
    assert len(got.lookup(-1)) == 0


def test_train_keeps_module_mode_switch(trained_port):
    _, ts = trained_port
    assert ts.eval() is ts and not ts.training
    assert ts.train() is ts and ts.training
    assert ts.train(False) is ts and not ts.training
    # retrain=False leaves a trained scorer alone
    table = ts.item_embeddings
    assert ts.train(None, TrainingOptions(retrain=False, device="cpu")) is None
    assert ts.item_embeddings is table
    params = ts.get_parameters()
    assert set(params) == {"user_embeddings", "item_embeddings"}
    other = ImplicitMFScorer(features=K)
    other.load_parameters({k: v.numpy() for k, v in params.items()}, device="cpu")
    torch.testing.assert_close(other.item_embeddings, table, rtol=0, atol=0)
    assert other.is_trained


def test_training_options(monkeypatch):
    opts = TrainingOptions(environment={"LKT_X": "yes", "LKT_Y": "maybe"}, device="cpu")
    assert opts.env_var("LKT_X") == "yes" and opts.env_flag("LKT_X")
    assert opts.env_flag("LKT_Y", default=True) and not opts.env_flag("LKT_UNSET")
    assert opts.configured_device() == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TrainingOptions().configured_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ImplicitMFScorer(features=K).train(from_interactions_df(_frame(False)), TrainingOptions(rng=1))


@pytest.mark.parametrize("seed", [42, [1, 2, 3], np.random.SeedSequence(9)])
def test_random_matches_jax(seed):
    np.testing.assert_array_equal(
        torch_random.random_generator(seed).standard_normal(8), jax_random.random_generator(seed).standard_normal(8)
    )
    assert torch_random.int_seed(seed) == jax_random.int_seed(seed)
    assert torch_random.derive_seed("user", 7, base=seed).entropy == jax_random.derive_seed("user", 7, base=seed).entropy
    assert (
        torch_random.spawn_seed(np.random.SeedSequence(5)).generate_state(2).tolist()
        == jax_random.spawn_seed(np.random.SeedSequence(5)).generate_state(2).tolist()
    )
    gen = np.random.default_rng(3)
    assert torch_random.random_generator(gen) is gen
    assert TrainingOptions(rng=seed).random_generator().integers(1 << 30) == JaxTrainingOptions(
        rng=seed
    ).random_generator().integers(1 << 30)


def test_global_rng():
    saved = torch_random._global_seed, jax_random._global_seed
    try:
        torch_random.set_global_rng(17)
        jax_random.set_global_rng(17)
        assert torch_random.global_rng_seed().entropy == jax_random.global_rng_seed().entropy == 17
        assert torch_random.random_generator().integers(1 << 30) == jax_random.random_generator().integers(1 << 30)
    finally:
        torch_random._global_seed, jax_random._global_seed = saved
