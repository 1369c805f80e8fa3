"""On-card tests of the port's kernels and of its serving, training, retrieval
and explicit slices.

Every test here needs a CUDA device and skips without one.  The file imports
neither JAX nor ``lkpy_tpu``, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu_torch.batch.device import device_recommend
from lkpy_tpu_torch.data import from_interactions_df
from lkpy_tpu_torch.models.als import BiasedMFScorer, ImplicitMFScorer
from lkpy_tpu_torch.ops import als as als_ops
from lkpy_tpu_torch.ops.als import implicit_otor
from lkpy_tpu_torch.ops.gather_rows import gather_rows, vector_width
from lkpy_tpu_torch.ops.mips_topk import INT32_MAX, _launch as launch_topk
from lkpy_tpu_torch.ops.mips_topk import _merge_lists, _merge_lists_plain, choose_splits, mips_topk, mips_topk_plain, range_items
from lkpy_tpu_torch.ops.sparse import bucket_rows
from lkpy_tpu_torch.ops.spd_solve import fold_mappings, fold_route, spd_solve, spd_solve_plain
from lkpy_tpu_torch.ops.spd_solve import _launch as launch_fold
from lkpy_tpu_torch.ops.spd_solve_chunked import _launch as launch_chunked
from lkpy_tpu_torch.ops.spd_solve_chunked import solve_route, spd_solve_chunked, spd_solve_chunked_plain
from lkpy_tpu_torch.ops.topk import FUSED_RETRIEVAL_MIN_ITEMS, fused_route, retrieval_topk
from lkpy_tpu_torch.training import TrainingOptions

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spd_batch(rng, B, k, reg=2.0):
    X = rng.standard_normal((B, k, k)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1) + reg * np.eye(k, dtype=np.float32)
    y = rng.standard_normal((B, k)).astype(np.float32)
    return A, y


@pytest.mark.parametrize("B,k", [(1024, 64), (1000, 50), (7, 8), (333, 128), (64, 256), (3, 1)])
def test_kernel_matches_plain(cuda, B, k):
    rng = np.random.default_rng(B + k)
    A, y = (torch.from_numpy(a).to(cuda) for a in _spd_batch(rng, B, k))
    before = spd_solve.launches
    x = spd_solve(A, y)
    torch.cuda.synchronize()
    assert spd_solve.launches == before + 1
    _assert_fold_agrees(x, spd_solve_plain(A, y), A, y, fold_route(B, k)[0])


def _assert_fold_agrees(x, plain, A, y, route):
    if route == "shared":
        # the same f32 operations in the same order on both sides
        torch.testing.assert_close(x, plain, rtol=1e-5, atol=1e-6)
    else:
        _assert_solves_agree(x, plain, A, y)


@pytest.mark.parametrize("k", [8, 50, 63, 64, 65, 128, 129, 256])
@pytest.mark.parametrize("B", [1, 37, 1001])  # 37 and 1001: no multiple of the two or four systems a block
def test_fold_mappings_match_plain_and_float64(cuda, B, k):
    rng = np.random.default_rng(1000 * B + k)
    A, y = (torch.from_numpy(a).to(cuda) for a in _spd_batch(rng, B, k))
    plain = spd_solve_plain(A, y)
    mappings = fold_mappings(k)
    assert fold_route(B, k) in mappings
    for route, threads in mappings:
        before = spd_solve.launches
        x = launch_fold(A, y, route, threads)
        torch.cuda.synchronize()
        assert spd_solve.launches == before + 1
        _assert_fold_agrees(x, plain, A, y, route)
    with pytest.raises(ValueError):
        launch_fold(A, y, "registers", 96)


@pytest.mark.parametrize("k,offset", [(64, 1), (64, 2), (50, 1), (50, 2), (63, 1), (8, 3)])
def test_fold_misaligned_inputs_take_the_narrow_loads(cuda, k, offset):
    # A starting `offset` floats into its storage is aligned to 4 or 8 bytes, not 16: the kernel loads it
    # float by float or in 8-byte halves, and the result is the aligned one's to the bit
    rng = np.random.default_rng(k + offset)
    A, y = (torch.from_numpy(a).to(cuda) for a in _spd_batch(rng, 50, k))
    shifted = torch.empty(A.numel() + offset, device=cuda)[offset:].view_as(A).copy_(A)
    y_shifted = torch.empty(y.numel() + 1, device=cuda)[1:].view_as(y).copy_(y)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    for route, threads in fold_mappings(k):
        assert torch.equal(launch_fold(shifted, y_shifted, route, threads), launch_fold(A, y, route, threads))


@pytest.mark.parametrize("k", [50, 64, 96, 128, 129])
def test_fold_zero_systems_leave_their_neighbours_alone(cuda, k):
    # the explicit fold-in of a user without history has A = 0
    rng = np.random.default_rng(8)
    A, y = (torch.from_numpy(a).to(cuda) for a in _spd_batch(rng, 21, k))
    A0 = A.clone()
    A0[[3, 4, 11, 20]] = 0.0
    A0[7] = -A0[7]
    bad = torch.zeros(21, dtype=torch.bool, device=cuda)
    bad[[3, 4, 7, 11, 20]] = True
    for route, threads in fold_mappings(k):
        clean, x = launch_fold(A, y, route, threads), launch_fold(A0, y, route, threads)
        assert not torch.isfinite(x[bad]).any()
        assert torch.equal(x[~bad], clean[~bad])


def test_fold_register_route_reads_the_lower_triangle_only(cuda):
    rng = np.random.default_rng(3)
    A, y = (torch.from_numpy(a).to(cuda) for a in _spd_batch(rng, 50, 50))
    junk = A.clone()
    junk[:, torch.triu(torch.ones(50, 50, dtype=torch.bool, device=cuda), 1)] = float("nan")
    for route, threads in fold_mappings(50):
        assert torch.equal(launch_fold(junk, y, route, threads), launch_fold(A, y, route, threads))


def test_kernel_zero_diagonal_is_nonfinite(cuda):
    rng = np.random.default_rng(6)
    A, y = _spd_batch(rng, 3, 64)
    A[1] = 0.0
    x = spd_solve(torch.from_numpy(A).to(cuda), torch.from_numpy(y).to(cuda)).cpu().numpy()
    assert not np.isfinite(x[1]).any()
    assert np.isfinite(x[[0, 2]]).all()


def test_serving_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(11)
    n_users, n_items, k = 300, 500, 32
    u = np.repeat(np.arange(n_users), rng.integers(1, 150, size=n_users))
    i = rng.integers(0, n_items, size=len(u))
    ds = from_interactions_df(pd.DataFrame({"user_id": u, "item_id": i}))
    items = rng.standard_normal((ds.item_count, k)).astype(np.float32) * 0.3
    params = {
        "user_embeddings": rng.standard_normal((ds.user_count, k)).astype(np.float32) * 0.3,
        "item_embeddings": items,
        "_OtOr": implicit_otor(torch.from_numpy(items), 0.1).numpy(),
    }
    users = np.concatenate([ds.users.ids[::2], [-5]])
    out = {}
    for dev in ("cpu", cuda):
        scorer = ImplicitMFScorer.from_numpy(params, {"features": k}, ds.users, ds.items, device=dev)
        before = spd_solve.launches
        out[str(dev)] = device_recommend(scorer, users, 20, ds.interaction_matrix(), chunk=64, device=dev)
        if dev == cuda:
            assert spd_solve.launches > before
    for (key, il_cpu), (key2, il_gpu) in zip(out["cpu"].items(), out["cuda"].items()):
        assert key == key2
        assert len(il_cpu) == len(il_gpu)
        np.testing.assert_allclose(il_gpu.scores(), il_cpu.scores(), rtol=1e-4, atol=1e-4)
    assert len(out["cuda"].lookup(-5)) == 0


@pytest.mark.parametrize("N,k", [(30024, 64), (16384, 64), (1000, 50), (7, 8), (333, 128), (64, 256), (40, 1)])
def test_chunked_kernel_matches_plain(cuda, N, k):
    rng = np.random.default_rng(N + k)
    A, y = (torch.from_numpy(a).to(cuda) for a in _spd_batch(rng, N, k))
    before = spd_solve_chunked.launches
    x = spd_solve_chunked(A, y)
    torch.cuda.synchronize()
    assert spd_solve_chunked.launches == before + 1
    _assert_solves_agree(x, spd_solve_chunked_plain(A, y), A, y)


def _assert_solves_agree(x, plain, A, y):
    """Kernel against plain.  The shared-memory route does the plain version's
    operations in its order; the register route eliminates without the square
    root, with fmaf and a reciprocal of the pivot, so the two round
    differently and differ by the conditioning times f32's epsilon (these
    systems: X Xᵀ + 2 I, condition number up to about 2k).  Both are held to
    a float64 solve, and to each other at the size of their own error."""
    x64 = torch.linalg.solve(A.double(), y.double()[:, :, None])[:, :, 0]
    scale = x64.abs().amax(dim=1, keepdim=True)
    err_plain = float(((plain.double() - x64).abs() / scale).max())
    err_kernel = float(((x.double() - x64).abs() / scale).max())
    assert err_kernel <= max(2 * err_plain, 1e-6)
    assert float(((x - plain).abs() / scale).max()) <= max(3 * err_plain, 1e-6)


@pytest.mark.parametrize("k", [1, 7, 8, 31, 32, 33, 50, 64, 65, 96, 128, 129, 256])
@pytest.mark.parametrize("N", [1, 7, 1000])
def test_chunked_routes_match_plain(cuda, N, k):
    rng = np.random.default_rng(1000 * N + k)
    A, y = (torch.from_numpy(a).to(cuda) for a in _spd_batch(rng, N, k))
    plain = spd_solve_chunked_plain(A, y)
    routes = dict.fromkeys([solve_route(k), "shared"])  # the route the wrapper takes, and the general one
    assert ("registers" in routes) == (k <= 128)
    for route in routes:
        before = spd_solve_chunked.launches
        x = launch_chunked(A, y, route)
        torch.cuda.synchronize()
        assert spd_solve_chunked.launches == before + 1
        if route == "shared":
            # the same f32 operations in the same order on both sides
            torch.testing.assert_close(x, plain, rtol=1e-5, atol=1e-6)
        else:
            _assert_solves_agree(x, plain, A, y)
    if k > 128:
        with pytest.raises(ValueError):
            launch_chunked(A, y, "registers")


@pytest.mark.parametrize("k", [50, 64, 96, 129])
def test_chunked_kernel_zero_systems_are_nonfinite(cuda, k):
    rng = np.random.default_rng(8)
    A, y = _spd_batch(rng, 20, k)
    A0 = A.copy()
    A0[[3, 11]] = 0.0
    A0[7] = -A0[7]
    clean = spd_solve_chunked(torch.from_numpy(A).to(cuda), torch.from_numpy(y).to(cuda)).cpu().numpy()
    x = spd_solve_chunked(torch.from_numpy(A0).to(cuda), torch.from_numpy(y).to(cuda)).cpu().numpy()
    assert not np.isfinite(x[[3, 7, 11]]).any()
    # the neighbours of a singular system come out as without it, to the bit
    np.testing.assert_array_equal(np.delete(x, [3, 7, 11], axis=0), np.delete(clean, [3, 7, 11], axis=0))


def test_chunked_register_route_reads_the_lower_triangle_only(cuda):
    rng = np.random.default_rng(3)
    A, y = (torch.from_numpy(a).to(cuda) for a in _spd_batch(rng, 50, 50))
    junk = A.clone()
    junk[:, torch.triu(torch.ones(50, 50, dtype=torch.bool, device=cuda), 1)] = float("nan")
    assert torch.equal(spd_solve_chunked(junk, y), spd_solve_chunked(A, y))


def _interaction_csr(rng, n_users=400, n_items=150, mode="implicit"):
    from lkpy_tpu_torch.data.matrix import CSR

    lens = np.minimum(rng.zipf(1.5, size=n_users) + 2, n_items // 2)
    u = np.repeat(np.arange(n_users), lens)
    i = np.concatenate([rng.choice(n_items, size=n, replace=False) for n in lens])
    r = (rng.integers(1, 11, size=len(u)) / 2.0).astype(np.float32)
    vals = r * 40.0 if mode == "implicit" else r - r.mean()
    return CSR.from_coo(u, i, vals, (n_users, n_items))


@pytest.mark.parametrize("mode", ["implicit", "explicit"])
def test_als_epochs_on_card_match_cpu(cuda, mode):
    rng = np.random.default_rng(21)
    ui = _interaction_csr(rng, mode=mode)
    iu = ui.transpose()
    k = 24
    tabs = [(rng.standard_normal((n, k)) * 0.1).astype(np.float32) ** 2 for n in ui.shape]
    out = {}
    for dev in ("cpu", cuda):
        ub = als_ops.chunk_buckets(bucket_rows(ui, ratio=1.35), entries=2000, device=dev)
        ib = als_ops.chunk_buckets(bucket_rows(iu, ratio=1.35), entries=2000, device=dev)
        u, i = (torch.from_numpy(t).to(dev) for t in tabs)
        before = spd_solve_chunked.launches
        for _ in range(2):
            u, i, du, di = als_ops.als_epoch(ub, ib, u, i, 0.1, 0.1, mode=mode)
        if dev == cuda:
            assert spd_solve_chunked.launches > before
        out[str(dev)] = (u.cpu().double(), i.cpu().double(), float(du), float(di))
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        assert float((a - b).norm() / b.norm()) <= 1e-4
    np.testing.assert_allclose(out["cuda"][2:], out["cpu"][2:], rtol=1e-4)


def test_train_defaults_to_the_card(cuda):
    rng = np.random.default_rng(5)
    u = rng.integers(0, 200, 4000)
    i = rng.integers(0, 90, 4000)
    ds = from_interactions_df(pd.DataFrame({"user_id": u, "item_id": i}))
    scorer = ImplicitMFScorer(features=16, epochs=2)
    before = spd_solve_chunked.launches
    scorer.train(ds, TrainingOptions(rng=3))
    assert spd_solve_chunked.launches > before
    for t in (scorer.user_embeddings, scorer.item_embeddings, scorer._OtOr):
        assert t.device.type == "cuda" and torch.isfinite(t).all()
    cpu = ImplicitMFScorer(features=16, epochs=2)
    cpu.train(ds, TrainingOptions(rng=3, device="cpu"))
    # the card's bmm sums in another order than the CPU's: compare whole tables
    diff = (scorer.item_embeddings.cpu() - cpu.item_embeddings).norm() / cpu.item_embeddings.norm()
    assert float(diff) <= 1e-3


def _assert_topk_close(got, want, scores=None):
    """Kernel against plain: values rtol/atol 1e-5 (the kernel sums over D in
    order, the product of the plain version does not), the same empty slots,
    indices equal wherever the neighbouring ranks are more than 1e-4 away."""
    (gv, gi), (wv, wi) = got, want
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    finite = torch.isfinite(wv)
    assert torch.equal(torch.isfinite(gv), finite)
    torch.testing.assert_close(gv[finite], wv[finite], rtol=1e-5, atol=1e-5)
    assert (gi[~finite] == INT32_MAX).all() and (gv[~finite] == -torch.inf).all()
    w = torch.where(finite, wv, torch.zeros_like(wv))
    gap = (w[:, :-1] - w[:, 1:]).abs()
    clear = torch.ones_like(finite)
    clear[:, :-1] &= gap > 1e-4
    clear[:, 1:] &= gap > 1e-4
    clear[:, -1] = False  # the cut-off may fall inside a near tie
    clear &= finite
    assert torch.equal(gi[clear], wi[clear])


def _topk_inputs(cuda, seed, B, N, D):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32) * 0.35).to(cuda)
    items = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32) * 0.35).to(cuda)
    return rng, q, items


@pytest.mark.parametrize(
    "B,N,D,k", [(256, 500_000, 64, 10), (256, 500_000, 64, 64), (1024, 27_000, 64, 10), (37, 1001, 48, 7), (5, 300, 50, 64)]
)
@pytest.mark.parametrize("variant", ["plain", "bias", "exclude"])
def test_mips_topk_kernel_matches_plain(cuda, B, N, D, k, variant):
    rng, q, items = _topk_inputs(cuda, B + N + k, B, N, D)
    bias = torch.from_numpy(rng.standard_normal(N, dtype=np.float32) * 0.3).to(cuda) if variant == "bias" else None
    excl = (torch.rand((B, N), device=cuda) < 0.01).to(torch.int8) if variant == "exclude" else None
    before = mips_topk.launches
    got = mips_topk(q, items, k, i_bias=bias, exclude=excl)
    torch.cuda.synchronize()
    assert mips_topk.launches == before + 1
    _assert_topk_close(got, mips_topk_plain(q, items, k, i_bias=bias, exclude=excl))
    if excl is not None:
        assert not excl.gather(1, got[1].long()).any()


def _splits_there(B, N, D):
    """Every S the wrapper can choose for a catalog of N items: 1 up to the
    count of shortest ranges, thinned where there are many."""
    most = max(1, N // 1024)
    picks = {1, 2, 3, most, choose_splits(B, N, torch.cuda.get_device_properties(0).multi_processor_count, 32)}
    picks |= set(np.linspace(1, most, 6).astype(int).tolist())
    return sorted(s for s in picks if 1 <= s <= most)


@pytest.mark.parametrize("B", [1, 37, 64, 1024])
@pytest.mark.parametrize("N,D", [(9_000, 64), (2_049, 48), (70_001, 64)])  # ragged against the 256-item tile and the ranges
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("product", [0, 1])
def test_mips_topk_every_split_matches_plain(cuda, B, N, D, k, product):
    rng, q, items = _topk_inputs(cuda, B + N + k, B, N, D)
    items[N // 2 : N // 2 + 200] = items[:200]  # equal scores in far-apart ranges
    excl = (torch.rand((B, N), device=cuda) < 0.02).to(torch.int8)
    excl[0] = 1  # a row with nothing scoreable
    want = mips_topk_plain(q, items, k, exclude=excl)
    seen = set()
    for forced in [None, *_splits_there(B, N, D)]:
        before = mips_topk.launches
        got = launch_topk(q, items, k, None, excl, splits=forced, product=product)
        torch.cuda.synchronize()
        assert mips_topk.launches == before + 1  # one call is one launch, whatever S is
        S = mips_topk.last_splits
        assert S == -(-N // range_items(N, S))
        seen.add(S)
        _assert_topk_close(got, want)
        assert (got[1][0] == INT32_MAX).all()
        tied = torch.isfinite(got[0][:, 1:]) & (got[0][:, :-1] == got[0][:, 1:])
        assert (got[1][:, :-1] < got[1][:, 1:])[tied].all()
    assert len(seen) > 1


@pytest.mark.parametrize("product", [0, 1])
def test_mips_topk_k_past_the_catalog_under_splits(cuda, product):
    _, q, items = _topk_inputs(cuda, 4, 37, 3000, 32)
    for n, forced in [(5, None), (3000, 2), (1500, 1)]:
        got = launch_topk(q, items[:n].contiguous(), 64, splits=forced, product=product)
        _assert_topk_close(got, mips_topk_plain(q, items[:n].contiguous(), 64))
        assert (got[1][:, min(n, 64) :] == INT32_MAX).all()


@pytest.mark.parametrize("B,S,k", [(1, 2, 1), (37, 7, 10), (64, 66, 10), (300, 3, 64), (5, 200, 64)])
def test_merge_kernel_matches_plain(cuda, B, S, k):
    g = torch.Generator(device=cuda).manual_seed(B * S + k)
    v = torch.randint(0, 3 * k, (B, S, k), device=cuda, generator=g).float().sort(dim=2, descending=True).values
    i = torch.rand((B, S, 500), device=cuda, generator=g).argsort(dim=2)[:, :, :k].sort(dim=2).values.int()
    i += 500 * torch.arange(S, device=cuda, dtype=torch.int32)[None, :, None]
    empty = torch.arange(k, device=cuda)[None, None, :] >= torch.randint(0, k + 1, (B, S, 1), device=cuda, generator=g)
    v[empty], i[empty] = -torch.inf, INT32_MAX
    before = mips_topk.launches
    got = _merge_lists(v.contiguous(), i.contiguous())
    torch.cuda.synchronize()
    assert mips_topk.launches == before  # the merge alone is no launch of mips_topk
    want = _merge_lists_plain(v, i)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mips_topk_ties_and_empty_slots(cuda):
    rng, q, items = _topk_inputs(cuda, 9, 40, 3000, 32)
    items[1500:] = items[:1500]  # item 1500 + j scores bit-equal to item j
    v, i = mips_topk(q, items, 20)
    pv, pi = mips_topk_plain(q, items, 20)
    assert torch.equal(i, pi)
    assert torch.equal(i[:, 1::2], i[:, 0::2] + 1500) and torch.equal(v[:, 1::2], v[:, 0::2])
    # a row wholly excluded, a row with 3 scoreable items, k past the catalog
    excl = torch.zeros((40, 3000), dtype=torch.bool, device=cuda)
    excl[0] = True
    excl[1, 3:] = True
    v, i = mips_topk(q, items, 8, exclude=excl)
    assert (v[0] == -torch.inf).all() and (i[0] == INT32_MAX).all()
    assert torch.isfinite(v[1, :3]).all() and (v[1, 3:] == -torch.inf).all() and (i[1, 3:] == INT32_MAX).all()
    assert sorted(i[1, :3].tolist()) == [0, 1, 2]
    _assert_topk_close((v, i), mips_topk_plain(q, items, 8, exclude=excl))
    _assert_topk_close(mips_topk(q, items[:5], 9), mips_topk_plain(q, items[:5], 9))


def test_mips_topk_refuses_what_the_kernel_does_not_take(cuda):
    _, q, items = _topk_inputs(cuda, 1, 8, 100, 16)
    with pytest.raises(ValueError):
        mips_topk(q, items.T.contiguous().T, 5)
    with pytest.raises(ValueError):
        mips_topk(q, items.cpu(), 5)
    with pytest.raises(ValueError):
        mips_topk(q, items, 65)


def test_retrieval_topk_dispatch(cuda):
    rng, q, big = _topk_inputs(cuda, 2, 64, FUSED_RETRIEVAL_MIN_ITEMS, 16)
    bias = torch.from_numpy(rng.standard_normal(len(big), dtype=np.float32) * 0.3).to(cuda)
    small = big[: FUSED_RETRIEVAL_MIN_ITEMS - 1]
    for items, k, exact, launches in [(big, 10, True, 1), (big, 64, False, 1), (big, 65, True, 0), (small, 10, True, 0)]:
        b = bias[: len(items)]
        before = mips_topk.launches
        v, i = retrieval_topk(q, items, k, i_bias=b, exact=exact, chunk=16)
        assert mips_topk.launches == before + launches == before + int(fused_route("cuda", 64, len(items), k))
        assert i.dtype == torch.int32 and v.shape == (64, k)
        pv, pi = torch.topk(q @ items.T + b, k)
        torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
        assert (i != pi).float().mean() < 0.01  # near ties only


def _ratings_dataset(rng, n_users=300, n_items=120):
    lens = np.minimum(rng.zipf(1.5, size=n_users) + 3, n_items // 2)
    u = np.repeat(np.arange(n_users), lens)
    i = np.concatenate([rng.choice(n_items, size=n, replace=False) for n in lens])
    r = np.clip(3.5 + rng.normal(0, 0.5, n_items)[i] + rng.normal(0, 0.5, len(u)), 0.5, 5.0).astype(np.float32)
    return from_interactions_df(pd.DataFrame({"user_id": u, "item_id": i, "rating": r}))


def test_explicit_family_on_card_matches_cpu(cuda):
    ds = _ratings_dataset(np.random.default_rng(13))
    out = {}
    for dev in ("cpu", cuda):
        scorer = BiasedMFScorer(features=50, epochs=2)
        b1, b2 = spd_solve_chunked.launches, spd_solve.launches
        scorer.train(ds, TrainingOptions(rng=3, device=dev))
        assert (spd_solve_chunked.launches > b1) == (dev == cuda)  # explicit training runs the training solve
        recs = device_recommend(scorer, ds.users.ids, 10, ds.interaction_matrix(), chunk=64, device=dev)
        assert (spd_solve.launches > b2) == (dev == cuda)  # explicit fold-in runs the fold-in solve
        out[str(dev)] = (scorer, recs)
    cpu, gpu = out["cpu"][0], out["cuda"][0]
    assert gpu.item_embeddings.device.type == "cuda"
    assert float((gpu.item_embeddings.cpu() - cpu.item_embeddings).norm() / cpu.item_embeddings.norm()) <= 1e-3
    np.testing.assert_allclose(gpu.bias.item_biases, cpu.bias.item_biases, rtol=1e-4, atol=1e-5)
    for (key, il_cpu), (key2, il_gpu) in zip(out["cpu"][1].items(), out["cuda"][1].items()):
        assert key == key2 and len(il_cpu) == len(il_gpu) == 10
        np.testing.assert_allclose(il_gpu.scores(), il_cpu.scores(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("K", [1, 3, 50, 63, 64, 65, 128, 256])
@pytest.mark.parametrize("M", [0, 1, 37, 65_536])
def test_gather_rows_kernel_equals_index_select(cuda, K, M):
    rng = np.random.default_rng(K * 7 + M)
    n = 5_000
    table = torch.from_numpy(rng.standard_normal((n, K), dtype=np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, n, M).astype(np.int32)).to(cuda)
    if M:
        idx[-1] = n - 1  # the last row
        idx[0] = 0  # the padding slots' column
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + (M > 0)
    assert got.shape == (M, K) and torch.equal(got, table.index_select(0, idx.long()))


@pytest.mark.parametrize("K", [50, 64, 128])
def test_gather_rows_views_and_int64(cuda, K):
    rng = np.random.default_rng(K)
    base = torch.from_numpy(rng.standard_normal(400 * (K + 3) + 1, dtype=np.float32)).to(cuda)
    table = base[1 : 1 + 400 * K].view(400, K)  # a view 4 bytes past an aligned start
    wide = base[: 400 * (K + 3)].view(400, K + 3)[:, 2 : 2 + K]  # rows K + 3 apart, at an offset
    idx = torch.from_numpy(rng.integers(0, 400, (6, 37))).to(cuda)  # int64, 2-D
    for t in (table, wide):
        got = gather_rows(t, idx)
        torch.cuda.synchronize()
        assert got.shape == (6, 37, K) and torch.equal(got, t[idx])
    assert vector_width(table, torch.empty((1, K), device=cuda)) == 1  # 4 bytes off: scalar loads
    assert torch.equal(gather_rows(table, idx.int()), table[idx])


def test_gather_rows_out_of_range_is_a_device_assertion(cuda):
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch\n"
        "from lkpy_tpu_torch.ops.gather_rows import gather_rows\n"
        "t = torch.zeros((100, 64), device='cuda')\n"
        "i = torch.tensor([3, 100], dtype=torch.int32, device='cuda')\n"
        "try:\n"
        "    gather_rows(t, i)\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised', 'assert' in str(e).lower())\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300
    )
    assert "raised True" in out.stdout, (out.stdout, out.stderr)


def test_als_gather_runs_the_kernel(cuda):
    rng = np.random.default_rng(3)
    right = torch.from_numpy(rng.standard_normal((90, 50), dtype=np.float32)).to(cuda)
    cols = torch.from_numpy(rng.integers(0, 90, (16, 7)).astype(np.int32)).to(cuda)
    before = gather_rows.launches
    G = als_ops._gather(right, cols)
    assert gather_rows.launches == before + 1 and torch.equal(G, right[cols.long()])


def test_quick_measure_model_on_card_matches_cpu(cuda):
    from lkpy_tpu_torch.metrics import quick_measure_model

    rng = np.random.default_rng(17)
    ds = from_interactions_df(pd.DataFrame({"user_id": rng.integers(0, 400, 9000), "item_id": rng.integers(0, 250, 9000)}))
    before = (spd_solve_chunked.launches, gather_rows.launches, spd_solve.launches)
    on_card = quick_measure_model(ImplicitMFScorer(features=16, epochs=3), ds, n_recs=10, rng=5)
    # B1 and P train; the per-query runner folds each user in on the card (P and B2)
    assert spd_solve_chunked.launches > before[0] and gather_rows.launches > before[1]
    assert spd_solve.launches - before[2] == len(on_card.split.test)
    on_cpu = quick_measure_model(ImplicitMFScorer(features=16, epochs=3), ds, n_recs=10, rng=5, device="cpu")
    assert list(on_card.split.test.keys()) == list(on_cpu.split.test.keys())
    np.testing.assert_allclose(on_card.global_metrics().to_numpy(), on_cpu.global_metrics().to_numpy(), rtol=0, atol=2e-3)


@pytest.mark.parametrize("family", ["implicit", "explicit"])
def test_per_query_scoring_on_card_matches_cpu(cuda, family):
    # one query on the card: P gathers the history, B2 solves the fold-in, P
    # gathers the candidates, and only the scores come back
    import copy

    from lkpy_tpu_torch.data import ItemList, RecQuery

    ds = _ratings_dataset(np.random.default_rng(23))
    scorer = ImplicitMFScorer(features=16, epochs=2) if family == "implicit" else BiasedMFScorer(features=50, epochs=2)
    scorer.train(ds, TrainingOptions(rng=4, device="cpu"))
    on_card = copy.deepcopy(scorer).to(cuda)
    items = ItemList(item_ids=ds.items.ids)
    for user in ds.users.ids[:5]:
        query = RecQuery(user_id=user, user_items=ds.interaction_matrix().row_items(user))
        before = (gather_rows.launches, spd_solve.launches)
        got = on_card(query, items).scores()
        assert (gather_rows.launches - before[0], spd_solve.launches - before[1]) == (2, 1)
        np.testing.assert_allclose(got, scorer(query, items).scores(), rtol=1e-4, atol=1e-4)
    assert on_card.item_embeddings.device.type == "cuda"
