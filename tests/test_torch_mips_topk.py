"""The port's fused MIPS top-k (``lkpy_tpu_torch.ops.mips_topk``) against the
JAX package's Pallas kernel, which runs here in interpret mode.  On the CPU
the port's wrapper takes the kernel's plain version.

Values: rtol 1e-6 / atol 1e-6, the JAX package's own test tolerance (the two
f32 products sum in different orders); indices equal.
"""

import numpy as np
import pytest
import torch

from lkpy_tpu.ops.pallas_topk import MAX_FUSED_K as JAX_MAX_FUSED_K
from lkpy_tpu.ops.pallas_topk import mips_topk as jax_mips_topk
from lkpy_tpu_torch.ops.mips_topk import (
    INT32_MAX,
    MAX_FUSED_K,
    MIN_RANGE_ITEMS,
    RANGE_QUANTUM,
    _merge_lists_plain,
    _partial_lists_plain,
    _scores_tf32_plain,
    _tf32_round,
    choose_product,
    choose_splits,
    mips_topk,
    mips_topk_plain,
    range_items,
)

torch.set_num_threads(1)


def _inputs(seed, B, N, D):
    rng = np.random.default_rng(seed)
    return rng, rng.standard_normal((B, D)).astype(np.float32), rng.standard_normal((N, D)).astype(np.float32)


def _both(Q, I, k, bias=None, excl=None):
    jv, ji = jax_mips_topk(Q, I, k, i_bias=bias, exclude=excl)
    before = mips_topk.launches
    tv, ti = mips_topk(
        torch.from_numpy(Q),
        torch.from_numpy(I),
        k,
        i_bias=None if bias is None else torch.from_numpy(bias),
        exclude=None if excl is None else torch.from_numpy(excl),
    )
    assert mips_topk.launches == before  # CPU tensors take the plain version
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32 and tv.shape == ti.shape == (Q.shape[0], k)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def test_cap_is_the_jax_packages():
    assert MAX_FUSED_K == JAX_MAX_FUSED_K == 64


@pytest.mark.parametrize("B,N,D,k", [(37, 1000, 48, 10), (128, 513, 64, 20), (5, 100, 16, 7), (64, 2048, 32, MAX_FUSED_K)])
def test_matches_jax(B, N, D, k):
    _, Q, I = _inputs(B * 1000 + N, B, N, D)
    jv, ji, tv, ti = _both(Q, I, k)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti, ji)
    assert (np.diff(tv, axis=1) <= 0).all()


@pytest.mark.parametrize("mask_dtype", [np.int8, np.bool_, np.uint8])
def test_bias_and_exclusion(mask_dtype):
    rng, Q, I = _inputs(7, 33, 777, 40)
    bias = rng.standard_normal(777).astype(np.float32)
    excl = (rng.random((33, 777)) < 0.2).astype(mask_dtype)
    jv, ji, tv, ti = _both(Q, I, 12, bias, excl)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti, ji)
    for b in range(33):
        assert not excl[b, ti[b]].any()


def test_all_excluded():
    _, Q, I = _inputs(3, 4, 50, 8)
    excl = np.ones((4, 50), dtype=np.int8)
    jv, _, tv, ti = _both(Q, I, 5, excl=excl)
    assert np.isneginf(jv).all() and np.isneginf(tv).all()
    # the port keeps the documented contract for the index of an empty slot
    assert (ti == INT32_MAX).all()


def test_fewer_scoreable_items_than_k():
    _, Q, I = _inputs(4, 6, 40, 8)
    excl = np.ones((6, 40), dtype=np.int8)
    excl[:, [3, 17, 29]] = 0
    jv, ji, tv, ti = _both(Q, I, 5, excl=excl)
    finite = np.isfinite(jv)
    assert (finite.sum(axis=1) == 3).all()
    np.testing.assert_array_equal(np.isfinite(tv), finite)
    np.testing.assert_allclose(tv[finite], jv[finite], rtol=1e-6, atol=1e-6)
    # indices are compared where the value is finite: the Pallas kernel
    # leaves an item number in an empty slot, the port INT32_MAX
    np.testing.assert_array_equal(ti[finite], ji[finite])
    assert (ti[~finite] == INT32_MAX).all()


def test_k_larger_than_catalog():
    _, Q, I = _inputs(5, 3, 6, 4)
    jv, ji, tv, ti = _both(Q, I, 10)
    finite = np.isfinite(tv)
    assert (finite.sum(axis=1) == 6).all() and finite[:, :6].all()
    np.testing.assert_allclose(tv[:, :6], jv[:, :6], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti[:, :6], ji[:, :6])
    assert np.isneginf(jv[:, 6:]).all() and (ti[:, 6:] == INT32_MAX).all()


def test_ties_go_to_the_smaller_index():
    # duplicated item rows score bit-equal: both packages list the copy with
    # the smaller index first
    _, Q, I = _inputs(6, 9, 60, 16)
    I = np.concatenate([I, I[:30]])  # item 60 + j duplicates item j
    jv, ji, tv, ti = _both(Q, I, 20)
    np.testing.assert_array_equal(ti, ji)
    for row_v, row_i in zip(tv, ti):
        for a in range(19):
            if row_v[a] == row_v[a + 1]:
                assert row_i[a] < row_i[a + 1]
    dup = (ti[:, :-1] < 30) & (ti[:, 1:] == ti[:, :-1] + 60)
    assert dup.any()


def test_k_cap_raises():
    q, i = torch.zeros((4, 8)), torch.zeros((16, 8))
    with pytest.raises(ValueError):
        mips_topk(q, i, MAX_FUSED_K + 1)
    with pytest.raises(ValueError):
        jax_mips_topk(q.numpy(), i.numpy(), MAX_FUSED_K + 1)
    with pytest.raises(ValueError):
        mips_topk(q, i, 0)


@pytest.mark.parametrize(
    "make,error",
    [
        (lambda q, i: dict(queries=q.double(), items=i), TypeError),
        (lambda q, i: dict(queries=q, items=i.to(torch.float16)), TypeError),
        (lambda q, i: dict(queries=q, items=i[:, :7]), ValueError),
        (lambda q, i: dict(queries=q[0], items=i), ValueError),
        (lambda q, i: dict(queries=q, items=i.T.contiguous().T), ValueError),  # not contiguous
        (lambda q, i: dict(queries=q, items=i, i_bias=torch.zeros(15)), ValueError),
        (lambda q, i: dict(queries=q, items=i, i_bias=torch.zeros(16, dtype=torch.float64)), ValueError),
        (lambda q, i: dict(queries=q, items=i, exclude=torch.zeros((4, 16))), ValueError),  # float mask
        (lambda q, i: dict(queries=q, items=i, exclude=torch.zeros((16, 4), dtype=torch.bool)), ValueError),
        (lambda q, i: dict(queries=q, items=i.to("meta")), ValueError),  # devices differ
    ],
)
def test_argument_errors(make, error):
    q, i = torch.zeros((4, 8)), torch.zeros((16, 8))
    kw = make(q, i)
    with pytest.raises(error):
        mips_topk(k=3, **kw)
    with pytest.raises(error):
        mips_topk_plain(k=3, **kw)


def test_plain_slabs_agree_with_one_pass(monkeypatch):
    # the plain version scores the queries in slabs: the slab size changes nothing
    import lkpy_tpu_torch.ops.mips_topk as mod

    rng, Q, I = _inputs(8, 23, 300, 12)
    excl = torch.from_numpy(rng.random((23, 300)) < 0.1)
    q, i = torch.from_numpy(Q), torch.from_numpy(I)
    whole = mips_topk_plain(q, i, 9, exclude=excl)
    monkeypatch.setattr(mod, "_PLAIN_SLAB_ENTRIES", 300 * 4)
    slabbed = mips_topk_plain(q, i, 9, exclude=excl)
    # a product over fewer rows may sum in another order
    torch.testing.assert_close(slabbed[0], whole[0], rtol=1e-6, atol=1e-6)
    assert torch.equal(slabbed[1], whole[1])


# --- the split over the items and the merge pass ---------------------------------------------


def _assert_lists_close(got, want, jax=None):
    """Values rtol/atol 1e-6 (products over slices of the items may sum in
    another order), the same empty slots, indices equal where the score is
    finite and both neighbouring ranks are more than 1e-4 away."""
    (gv, gi), (wv, wi) = ((np.asarray(a) for a in pair) for pair in (got, want))
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=1e-6, atol=1e-6)
    assert (gi[~finite] == INT32_MAX).all() and np.isneginf(gv[~finite]).all()
    w = np.where(finite, wv, 0.0)
    gap = np.abs(w[:, :-1] - w[:, 1:])
    clear = finite.copy()
    clear[:, :-1] &= gap > 1e-4
    clear[:, 1:] &= gap > 1e-4
    np.testing.assert_array_equal(gi[clear], wi[clear])


def _split_case(seed, B, N, D, dup=0, biased=False, masked=False):
    rng, Q, I = _inputs(seed, B, N, D)
    if dup:
        I[N - dup :] = I[:dup]  # item N - dup + j scores bit-equal to item j: ties across ranges
    bias = rng.standard_normal(N).astype(np.float32) if biased else None
    if bias is not None and dup:
        bias[N - dup :] = bias[:dup]
    excl = (rng.random((B, N)) < 0.15) if masked else None
    return Q, I, bias, excl


@pytest.mark.parametrize("S", [1, 2, 3, 7])
@pytest.mark.parametrize("variant", ["bare", "bias", "exclude", "bias+exclude"])
def test_merge_of_split_lists_matches_unsplit_and_jax(S, variant):
    Q, I, bias, excl = _split_case(40 + S, 21, 2000, 24, dup=300, biased="bias" in variant, masked="exclude" in variant)
    k = 12
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    part = _partial_lists_plain(t(Q), t(I), k, S, i_bias=t(bias), exclude=t(excl))
    assert part[0].shape == (21, -(-2000 // range_items(2000, S)), k)
    merged = _merge_lists_plain(*part)
    unsplit = mips_topk_plain(t(Q), t(I), k, i_bias=t(bias), exclude=t(excl))
    _assert_lists_close(merged, unsplit)
    jv, ji = jax_mips_topk(Q, I, k, i_bias=bias, exclude=None if excl is None else excl.astype(np.int8))
    _assert_lists_close(merged, (jv, ji))
    # equal values: the smaller index first, across range boundaries too
    mv, mi = merged[0].numpy(), merged[1].numpy()
    tied = mv[:, :-1] == mv[:, 1:]
    assert tied.any() and (mi[:, :-1] < mi[:, 1:])[tied].all()


@pytest.mark.parametrize("S", [2, 3, 7])
def test_merge_orders_a_tie_astride_a_range_boundary(S):
    Q, I, _, _ = _split_case(50, 9, 3000, 16)
    per = range_items(3000, S)
    I[per] = I[per - 1]  # neighbours on the two sides of the first boundary
    I[per - 1 : per + 1] *= 5.0
    q, i = torch.from_numpy(Q), torch.from_numpy(I)
    mv, mi = _merge_lists_plain(*_partial_lists_plain(q, i, 6, S))
    wv, wi = mips_topk_plain(q, i, 6)
    assert torch.equal(mi, wi)
    both = (wi == per - 1).any(1) & (wi == per).any(1)
    assert both.any()
    for row in mi[both].numpy():
        a = list(row).index(per - 1)
        assert row[a + 1] == per


@pytest.mark.parametrize("S", [1, 2, 3, 7])
def test_merge_with_fewer_scoreable_items_than_k(S):
    _, Q, I = _inputs(60, 6, 1800, 8)
    excl = np.ones((6, 1800), dtype=bool)
    excl[:, [3, 700, 1799]] = False  # one scoreable item in each of three far-apart ranges
    excl[0] = True  # and a row with none
    q, i, e = torch.from_numpy(Q), torch.from_numpy(I), torch.from_numpy(excl)
    mv, mi = _merge_lists_plain(*_partial_lists_plain(q, i, 5, S, exclude=e))
    _assert_lists_close((mv, mi), mips_topk_plain(q, i, 5, exclude=e))
    assert (mi[0] == INT32_MAX).all() and torch.isneginf(mv[0]).all()
    assert (torch.isfinite(mv[1:]).sum(1) == 3).all() and (mi[1:, 3:] == INT32_MAX).all()
    assert sorted(mi[1, :3].tolist()) == [3, 700, 1799]
    jv, ji = jax_mips_topk(Q, I, 5, exclude=excl.astype(np.int8))
    fin = np.isfinite(np.asarray(jv))
    np.testing.assert_array_equal(mi.numpy()[fin], np.asarray(ji)[fin])


def test_merge_takes_lists_in_any_range_order_of_values():
    # the merge decides by (value descending, index ascending), not by the order of the lists
    v = torch.tensor([[[5.0, 1.0, -np.inf], [5.0, 5.0, 2.0], [7.0, -np.inf, -np.inf]]])
    i = torch.tensor([[[4, 9, INT32_MAX], [12, 17, 11], [25, INT32_MAX, INT32_MAX]]], dtype=torch.int32)
    mv, mi = _merge_lists_plain(v, i)
    assert mv.tolist() == [[7.0, 5.0, 5.0]] and mi.tolist() == [[25, 4, 12]]
    mv, mi = _merge_lists_plain(torch.full((2, 3, 4), -np.inf), torch.full((2, 3, 4), INT32_MAX, dtype=torch.int32))
    assert torch.isneginf(mv).all() and (mi == INT32_MAX).all()


@pytest.mark.parametrize(
    "B,N,sms,qpb,want",
    [
        (4096, 500_000, 132, 32, 1),  # a block of queries per SM already
        (64, 500_000, 132, 32, 66),  # two blocks of queries: one wave of 132 blocks
        (1024, 500_000, 132, 32, 4),
        (1024, 27_000, 132, 32, 4),
        (64, 27_000, 132, 32, 22),  # as many as ranges of whole tiles allow
        (37, 1001, 132, 32, 1),  # shorter than the shortest range
        (5, 0, 132, 32, 1),
        (1, 10_000_000, 132, 32, 132),  # one block of queries: one wave
    ],
)
def test_choose_splits_is_a_pure_rule(B, N, sms, qpb, want):
    S = choose_splits(B, N, sms, qpb)
    assert S == want == choose_splits(B, N, sms, qpb)
    per = range_items(N, S)
    assert per % RANGE_QUANTUM == 0 and -(-max(N, 1) // per) == S  # no empty range
    if S > 1:
        assert per >= MIN_RANGE_ITEMS


@pytest.mark.parametrize(
    "B,N,D,k,product",
    [
        (4096, 500_000, 64, 10, 1),  # the retrieval path: the tensor cores
        (4096, 500_000, 64, 64, 1),
        (4096, 200_000, 64, 10, 1),
        (4096, 200_000, 64, 64, 0),  # longer lists need twice the work
        (1024, 500_000, 64, 10, 0),
        (64, 500_000, 64, 10, 0),
        (16384, 50_000, 128, 10, 1),
        (16384, 500_000, 129, 10, 0),  # deeper than the tensor-core kernel keeps
    ],
)
def test_choose_product_is_a_pure_rule_of_the_shape(B, N, D, k, product):
    assert choose_product(B, N, D, k) == product


def test_range_items_are_whole_tiles():
    assert range_items(500_000, 66) == 7680 and range_items(0, 3) == RANGE_QUANTUM
    assert range_items(1001, 1) == 1024 and range_items(27_000, 4) == 6912


# --- the three-pass TF32 product: why three passes ----------------------------------------------


def test_tf32_round_keeps_ten_mantissa_bits_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, -(1.0 + 2.0**-11), 3.0e-5, 0.0, 1.0 + 2.0**-11 - 2.0**-20])
    r = _tf32_round(x)
    assert r.tolist()[:4] == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10)]
    assert r[5] == 0.0 and r[6] == 1.0
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x - r).abs() <= x.abs() * 2.0**-11).all()


@pytest.mark.parametrize("D", [48, 64, 128])
def test_three_pass_tf32_keeps_f32_accuracy_and_one_pass_does_not(D):
    _, Q, I = _inputs(70 + D, 64, 4096, D)
    q, i = torch.from_numpy(Q * 0.35), torch.from_numpy(I * 0.35)
    exact = q.double() @ i.double().T
    scale = q.double().abs() @ i.double().abs().T  # the sum of |q_d i_d|: what a product's rounding scales with
    err3 = ((_scores_tf32_plain(q, i, 3).double() - exact).abs() / scale).max().item()
    err1 = ((_scores_tf32_plain(q, i, 1).double() - exact).abs() / scale).max().item()
    errf = (((q @ i.T).double() - exact).abs() / scale).max().item()
    # three passes drop small·small, under 2^-22 of each product, and sum in f32: guaranteed within 1e-6 of
    # the sum of |q_d i_d|, in practice a few 1e-7 (the f32 product itself: about 1e-7)
    assert err3 <= 1e-6 and errf <= 1e-6
    assert err3 <= 8 * max(errf, 5e-8)
    # one pass keeps 11 bits of each operand: far outside the port's 1e-5
    assert err1 > 1e-5
    top = exact.abs().max().item()
    assert (_scores_tf32_plain(q, i, 3).double() - exact).abs().max().item() <= 1e-5 * top
    assert (_scores_tf32_plain(q, i, 1).double() - exact).abs().max().item() > 1e-5 * top
