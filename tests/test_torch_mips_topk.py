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
from lkpy_tpu_torch.ops.mips_topk import INT32_MAX, MAX_FUSED_K, mips_topk, mips_topk_plain

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
