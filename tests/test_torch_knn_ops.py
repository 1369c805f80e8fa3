"""The port's kNN operations (``lkpy_tpu_torch.ops.knn``) against the JAX
package's ``lkpy_tpu.ops.knn`` on the CPU.

The same item-major matrices, made with numpy from a seed (a few hundred
users × about 200 items, some items and users empty), go through both.
Tolerances: similarities within 1e-5; neighbour ids equal wherever the gap
to the next similarity of the row exceeds 1e-5 (``lax.top_k`` puts the
lower index first among ties, ``torch.topk`` promises no order, and float32
sums in another order move the last bits); padding slots are compared by
similarity only; scores within rtol 1e-4 / atol 1e-5 with the same NaN
pattern, and equal counts where the table is carried across.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from lkpy_tpu.data.matrix import CSR as JaxCSR
from lkpy_tpu.ops import knn as jax_knn
from lkpy_tpu_torch.batch.device import invalidate_device_cache
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.ops import knn

torch.set_num_threads(1)

CPU = "cpu"


def _iu(seed=0, n_items=200, n_users=300, density=0.05, empty_items=10, empty_users=7):
    """Items × users ratings in [0.5, 5] with empty item and user rows."""
    rng = np.random.default_rng(seed)
    m = sps.random(n_items, n_users, density=density, random_state=seed, format="csr", dtype=np.float32)
    m.data = (rng.integers(1, 11, size=m.nnz) / 2.0).astype(np.float32)
    m = m.tolil()
    m[n_items // 2 : n_items // 2 + empty_items, :] = 0
    m[:, :empty_users] = 0
    m = m.tocsr()
    m.eliminate_zeros()
    return m


def _both(m):
    return JaxCSR.from_scipy(m), CSR.from_scipy(m)


def _assert_tables_agree(jt, tt, tol=1e-5):
    js, ji = np.asarray(jt.sims), np.asarray(jt.indices)
    ts, ti = tt.sims.numpy(), tt.indices.numpy()
    assert ts.shape == js.shape and ti.dtype == np.int32
    np.testing.assert_allclose(ts, js, rtol=0, atol=tol)
    # ids where the sim is real and separated from both neighbours in the row
    # (the last column's next rank lies outside the table, so it is not compared)
    gap_prev = np.concatenate([np.full((js.shape[0], 1), np.inf), -np.diff(js, axis=1)], axis=1)
    gap_next = np.concatenate([-np.diff(js, axis=1), np.zeros((js.shape[0], 1))], axis=1)
    clear = (js > tol) & (gap_prev > tol) & (gap_next > tol)
    assert clear.any()
    np.testing.assert_array_equal(ti[clear], ji[clear])
    # rows descending, no self-neighbour, padding only past the real sims
    assert (np.diff(ts, axis=1) <= 0).all()
    rows = np.arange(ts.shape[0])[:, None]
    assert not ((ti == rows) & (ts > 0)).any()


@pytest.mark.parametrize("explicit", [True, False])
def test_normalize_item_matrix(explicit):
    jm, tm = _both(_iu(1))
    jn, jmeans = jax_knn.normalize_item_matrix(jm, explicit=explicit)
    tn, tmeans = knn.normalize_item_matrix(tm, explicit=explicit)
    np.testing.assert_allclose(tn.values, jn.values, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tn.colind, jn.colind)
    if explicit:
        np.testing.assert_allclose(tmeans, jmeans, rtol=1e-6)
    else:
        assert tmeans is None and jmeans is None


def test_normalize_implicit_constant_values_fast_path():
    m = _iu(2)
    m.data[:] = 40.0
    jm, tm = _both(m)
    jn, _ = jax_knn.normalize_item_matrix(jm, explicit=False)
    tn, _ = knn.normalize_item_matrix(tm, explicit=False)
    np.testing.assert_array_equal(tn.values, jn.values)
    lens = np.diff(tm.rowptr)
    np.testing.assert_allclose(tn.values, np.repeat(1 / np.sqrt(np.maximum(lens, 1)), lens), rtol=1e-6)


# dense path; Gram path (max_dense_bytes forces it) without and with user_major
PATHS = {"dense": {}, "gram": {"max_dense_bytes": 20_000}, "gram_user_major": {"max_dense_bytes": 20_000, "um": True}}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("k", [16, 64])
def test_similarity_topk_matches_jax(path, explicit, k):
    jm, tm = _both(_iu(3))
    jn, _ = jax_knn.normalize_item_matrix(jm, explicit=explicit)
    tn, _ = knn.normalize_item_matrix(tm, explicit=explicit)
    kw = dict(PATHS[path])
    um = kw.pop("um", False)
    jt = jax_knn.similarity_topk(jn, k, 1e-6, tile=48, **kw)
    timings = {}
    tt = knn.similarity_topk(tn, k, 1e-6, tile=48, user_major=tm.transpose() if um else None, timings=timings, device=CPU, **kw)
    _assert_tables_agree(jt, tt)
    assert (timings["chunks"] >= 1) if path != "dense" else not timings


@pytest.mark.parametrize("user_major", [False, True])
@pytest.mark.parametrize("explicit", [True, False])
def test_gram_path_in_several_user_chunks(user_major, explicit):
    """2,500 users: a budget of 1,024 users a chunk (the least) gives 3 chunks."""
    jm, tm = _both(_iu(4, n_items=180, n_users=2_500, density=0.02))
    jn, _ = jax_knn.normalize_item_matrix(jm, explicit=explicit)
    tn, _ = knn.normalize_item_matrix(tm, explicit=explicit)
    jt = jax_knn.similarity_topk(jn, 20, 1e-6, max_dense_bytes=10_000)
    timings = {}
    um = tm.transpose() if user_major else None
    tt = knn.similarity_topk(tn, 20, 1e-6, max_dense_bytes=10_000, user_major=um, timings=timings, device=CPU)
    assert timings["chunks"] == 3 and timings["user_chunk"] == 834
    _assert_tables_agree(jt, tt)
    dense = knn.similarity_topk(tn, 20, 1e-6, device=CPU)
    np.testing.assert_allclose(tt.sims.numpy(), dense.sims.numpy(), rtol=0, atol=1e-6)


def test_gram_path_bf16_chunks_sum_in_float32():
    """bf16 chunks, float32 sums: within 1e-6 of float64 sums of the
    bf16-rounded values, and of the JAX package's bf16 Gram within 1e-4 (XLA's
    CPU product of bf16 slabs lies farther from those float64 sums)."""
    jm, tm = _both(_iu(5, n_users=2_100, density=0.02))
    jn, _ = jax_knn.normalize_item_matrix(jm, explicit=True)
    tn, _ = knn.normalize_item_matrix(tm, explicit=True)
    tt = knn.similarity_topk(tn, 20, 1e-6, max_dense_bytes=10_000, bf16=True, device=CPU)
    rounded = torch.from_numpy(tn.values).bfloat16().double().numpy()
    A = sps.csr_array((rounded, tn.colind, tn.rowptr), shape=tn.shape).toarray()
    S = A @ A.T
    np.fill_diagonal(S, 0.0)
    S[S < 1e-6] = 0.0
    oracle = knn.NeighborTable(*(torch.from_numpy(a) for a in _np_topk(S, 20)))
    _assert_tables_agree(oracle, tt, tol=1e-6)
    jt = jax_knn.similarity_topk(jn, 20, 1e-6, max_dense_bytes=10_000, bf16=True, approx=False)
    np.testing.assert_allclose(tt.sims.numpy(), np.asarray(jt.sims), rtol=0, atol=1e-4)
    f32 = knn.similarity_topk(tn, 20, 1e-6, max_dense_bytes=10_000, bf16=False, device=CPU)
    assert np.abs(tt.sims.numpy() - f32.sims.numpy()).max() > 1e-5  # the bf16 rounding shows


def _np_topk(S, k):
    idx = np.argsort(-S, axis=1, kind="stable")[:, :k]
    return idx.astype(np.int32), np.take_along_axis(S, idx, axis=1).astype(np.float32)


def test_bf16_default_follows_the_environment(monkeypatch):
    monkeypatch.delenv("LKT_KNN_BF16_GRAM", raising=False)
    assert knn.knn_bf16_default() is False
    monkeypatch.setenv("LKT_KNN_BF16_GRAM", "1")
    assert knn.knn_bf16_default() is True
    monkeypatch.setenv("LKT_KNN_BF16_GRAM", "false")
    assert knn.knn_bf16_default() is False


@pytest.mark.parametrize("n_items,k,want", [(200, 500, 199), (200, 199, 199), (1, 5, 1), (2, 64, 1)])
def test_k_is_clamped(n_items, k, want):
    m = _iu(6, n_items=n_items, n_users=60, density=0.5, empty_items=0, empty_users=0)
    jm, tm = _both(m)
    jn, _ = jax_knn.normalize_item_matrix(jm, explicit=False)
    tn, _ = knn.normalize_item_matrix(tm, explicit=False)
    tt = knn.similarity_topk(tn, k, device=CPU)
    jt = jax_knn.similarity_topk(jn, k)
    assert tt.k == want == np.asarray(jt.indices).shape[1]
    np.testing.assert_allclose(tt.sims.numpy(), np.asarray(jt.sims), atol=1e-5)


@pytest.mark.parametrize("min_sim", [0.05, 0.2])
@pytest.mark.parametrize("path", ["dense", "gram"])
def test_min_sim_threshold(min_sim, path):
    jm, tm = _both(_iu(7))
    jn, _ = jax_knn.normalize_item_matrix(jm, explicit=True)
    tn, _ = knn.normalize_item_matrix(tm, explicit=True)
    kw = PATHS[path]
    jt = jax_knn.similarity_topk(jn, 40, min_sim, **kw)
    tt = knn.similarity_topk(tn, 40, min_sim, device=CPU, **kw)
    _assert_tables_agree(jt, tt)
    s = tt.sims.numpy()
    assert not ((s > 0) & (s < min_sim)).any()
    assert (s == 0).any()  # the threshold leaves padding
    np.testing.assert_array_equal(tt.counts().numpy(), np.asarray(jt.counts()))


def test_user_major_structure_is_cached_and_swept():
    _, tm = _both(_iu(8))
    tn, _ = knn.normalize_item_matrix(tm, explicit=False)
    um = tm.transpose()
    invalidate_device_cache()
    knn.similarity_topk(tn, 10, max_dense_bytes=20_000, user_major=um, device=CPU)
    assert len(knn._resident_struct) == 1
    hit = knn._resident_struct.get(um, extra="cpu")
    t2 = knn.similarity_topk(tn, 10, max_dense_bytes=20_000, user_major=um, device=CPU)
    assert knn._resident_struct.get(um, extra="cpu") is hit
    assert t2.counts().sum() > 0
    invalidate_device_cache()
    assert len(knn._resident_struct) == 0
    # the same shape and entry count, one entry moved to the next user
    rowptr = um.rowptr.copy()
    rowptr[np.flatnonzero(np.diff(rowptr) > 0)[0] + 1] -= 1
    with pytest.raises(ValueError, match="structure"):
        knn.similarity_topk(tn, 10, max_dense_bytes=20_000, user_major=CSR(rowptr, um.colind, None, um.shape), device=CPU)


def _table(explicit, seed=9, k=30):
    jm, _ = _both(_iu(seed))
    jn, means = jax_knn.normalize_item_matrix(jm, explicit=explicit)
    jt = jax_knn.similarity_topk(jn, k, 1e-6)
    tt = knn.NeighborTable(torch.from_numpy(np.asarray(jt.indices)), torch.from_numpy(np.asarray(jt.sims)))
    return jt, tt, means


def _assert_scores_agree(a, b):
    np.testing.assert_array_equal(np.isnan(b[0]), np.isnan(a[0]))
    np.testing.assert_allclose(b[0], a[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(b[1], a[1])
    assert b[0].dtype == np.float32 and b[1].dtype == np.int32


@pytest.mark.parametrize("max_nbrs,min_nbrs", [(5, 1), (20, 2), (3, 3), (50, 1)])
@pytest.mark.parametrize("n_rated", [1, 12, 70])
def test_score_items_explicit(max_nbrs, min_nbrs, n_rated):
    jt, tt, means = _table(True)
    rng = np.random.default_rng(n_rated)
    rated = rng.choice(200, n_rated, replace=False).astype(np.int32)
    vals = (rng.integers(1, 11, n_rated) / 2.0).astype(np.float32)
    targets = rng.permutation(200)[:150].astype(np.int32)
    want = jax_knn.score_items_explicit(jt, targets, rated, vals, means, max_nbrs, min_nbrs)
    got = knn.score_items_explicit(tt, targets, rated, vals, means, max_nbrs, min_nbrs)
    _assert_scores_agree(want, got)
    assert np.isnan(got[0]).any() and (np.isfinite(got[0]).any() or min_nbrs > n_rated)


@pytest.mark.parametrize("max_nbrs,min_nbrs", [(5, 1), (20, 2), (3, 3)])
@pytest.mark.parametrize("n_rated", [1, 12, 70])
def test_score_items_implicit(max_nbrs, min_nbrs, n_rated):
    jt, tt, _ = _table(False)
    rng = np.random.default_rng(100 + n_rated)
    rated = rng.choice(200, n_rated, replace=False).astype(np.int32)
    targets = np.arange(200, dtype=np.int32)
    want = jax_knn.score_items_implicit(jt, targets, rated, max_nbrs, min_nbrs)
    got = knn.score_items_implicit(tt, targets, rated, max_nbrs, min_nbrs)
    _assert_scores_agree(want, got)


def test_score_items_empty_history_and_targets():
    jt, tt, means = _table(True)
    empty = np.zeros(0, dtype=np.int32)
    got = knn.score_items_explicit(tt, np.arange(5, dtype=np.int32), empty, np.zeros(0, np.float32), means, 20, 1)
    want = jax_knn.score_items_explicit(jt, np.arange(5, dtype=np.int32), empty, np.zeros(0, np.float32), means, 20, 1)
    _assert_scores_agree(want, got)
    assert np.isnan(got[0]).all()
    s, c = knn.score_items_implicit(tt, empty, np.array([3, 4], np.int32), 20, 1)
    assert s.shape == c.shape == (0,)


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("max_nbrs,min_nbrs", [(5, 1), (20, 3)])
def test_score_users_bucket(average, max_nbrs, min_nbrs):
    from lkpy_tpu.ops.sparse import bucket_rows as jax_bucket_rows

    rng = np.random.default_rng(11)
    m = _iu(12)
    jm = JaxCSR.from_scipy(m)
    sims = rng.uniform(-0.2, 1.0, m.shape[1]).astype(np.float32)
    sims[sims < 0.1] = 0.0
    for b in jax_bucket_rows(jm, field="rating"):
        want = jax_knn.score_users_bucket(b.cols, b.values, b.mask, sims, max_nbrs, min_nbrs, average)
        cols, vals, mask = (torch.tensor(np.asarray(a)) for a in (b.cols, b.values, b.mask))
        got = knn.score_users_bucket(cols, vals, mask, torch.from_numpy(sims), max_nbrs, min_nbrs, average)
        _assert_scores_agree([np.asarray(w) for w in want], [g.numpy() for g in got])


def test_sparse_matvec():
    m = _iu(13).tocoo()
    x = np.random.default_rng(13).standard_normal(m.shape[1]).astype(np.float32)
    rows, cols = m.row.astype(np.int32), m.col.astype(np.int32)
    want = np.asarray(jax_knn.sparse_matvec(rows, cols, m.data, x, n_rows=m.shape[0]))
    got = knn.sparse_matvec(*(torch.from_numpy(a) for a in (rows, cols, m.data, x)), n_rows=m.shape[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_cooccurrence_gram_equals_scipy_to_the_bit():
    ui = _iu(14, n_items=300, n_users=1_500, density=0.03).T.tocsr()
    X = ui.copy()
    X.data[:] = 1.0
    want = np.asarray((X.T @ X).todense(), dtype=np.float32)
    got = knn.cooccurrence_gram(CSR.from_scipy(ui), max_dense_bytes=100_000, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _both(_iu(15))
    tn, _ = knn.normalize_item_matrix(tm, explicit=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        knn.similarity_topk(tn, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        knn.cooccurrence_gram(tm)
    assert knn.similarity_topk(tn, 10, device=CPU).sims.device.type == "cpu"
