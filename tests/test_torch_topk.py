"""The port's top-k utilities (``lkpy_tpu_torch.ops.topk``) against
``lkpy_tpu.ops.topk`` on the CPU, where both packages take the plain route
of ``retrieval_topk``.

Values: rtol 1e-6 / atol 1e-6 (two f32 products that sum in different
orders); indices equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lkpy_tpu.ops as jax_ops
import lkpy_tpu.ops.topk as jax_topk
import lkpy_tpu_torch.ops as ops
import lkpy_tpu_torch.ops.topk as topk
from lkpy_tpu_torch.ops.mips_topk import mips_topk

torch.set_num_threads(1)


def test_exports_and_threshold_match_the_jax_package():
    # the row-chunking point is the JAX package's; the fused kernel's own point was measured on the card
    assert topk.LARGE_CATALOG_ITEMS == jax_topk.FUSED_RETRIEVAL_MIN_ITEMS == 200_000
    assert topk.FUSED_RETRIEVAL_MIN_ITEMS == 27_000
    assert set(jax_topk.__all__) <= set(topk.__all__)
    for name in ("masked_top_k", "top_n_indices", "segment_sum", "segment_count", "segment_mean"):
        assert name in jax_ops.__all__ and name in ops.__all__ and callable(getattr(ops, name))


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k", [5, 100])
def test_retrieval_topk_matches_jax(biased, exact, k):
    rng = np.random.default_rng(11 + k)
    Q = rng.standard_normal((9, 24)).astype(np.float32)
    I = rng.standard_normal((300, 24)).astype(np.float32)
    bias = rng.standard_normal(300).astype(np.float32) if biased else None
    jv, ji = jax_topk.retrieval_topk(
        jnp.asarray(Q), jnp.asarray(I), k, i_bias=None if bias is None else jnp.asarray(bias), exact=exact
    )
    before = mips_topk.launches
    tv, ti = topk.retrieval_topk(
        torch.from_numpy(Q), torch.from_numpy(I), k, i_bias=None if bias is None else torch.from_numpy(bias), exact=exact
    )
    assert mips_topk.launches == before
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k,chunk", [(10, 512), (70, 3)])
def test_retrieval_topk_large_catalog_matches_jax(k, chunk):
    # past the fused threshold the CPU still takes the plain route, in row chunks
    rng = np.random.default_rng(5)
    n = max(topk.FUSED_RETRIEVAL_MIN_ITEMS, topk.LARGE_CATALOG_ITEMS) + 17
    Q = rng.standard_normal((4, 8)).astype(np.float32)
    I = rng.standard_normal((n, 8)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    jv, ji = jax_topk.retrieval_topk(jnp.asarray(Q), jnp.asarray(I), k, i_bias=jnp.asarray(bias))
    tv, ti = topk.retrieval_topk(
        torch.from_numpy(Q), torch.from_numpy(I), k, i_bias=torch.from_numpy(bias), chunk=chunk, exact=False
    )
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_masked_top_k_matches_jax():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((6, 40)).astype(np.float32)
    v[rng.random((6, 40)) < 0.1] = np.nan
    mask = rng.random((6, 40)) < 0.7
    mask[3] = False  # a row with nothing valid
    for m in (mask, None):
        jv, ji = jax_topk.masked_top_k(jnp.asarray(v), None if m is None else jnp.asarray(m), 8)
        tv, ti = topk.masked_top_k(torch.from_numpy(v), None if m is None else torch.from_numpy(m), 8)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        finite = np.isfinite(np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy()[finite], np.asarray(ji)[finite])
    assert np.isneginf(topk.masked_top_k(torch.from_numpy(v), torch.from_numpy(mask), 8)[0][3].numpy()).all()


def test_top_n_indices_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((5, 30)).astype(np.float32)
    v[0, 4] = np.nan
    got = topk.top_n_indices(torch.from_numpy(v), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_topk.top_n_indices(jnp.asarray(v), 6)))
    np.testing.assert_array_equal(
        topk.top_n_indices(torch.from_numpy(v[1]), 4).numpy(), np.asarray(jax_topk.top_n_indices(jnp.asarray(v[1]), 4))
    )


@pytest.mark.parametrize("n", [None, 3, 0, 50, -1])
def test_argtopn_matches_jax(n):
    scores = np.array([0.5, np.nan, 2.0, 0.5, -1.0, 2.0, np.nan, 0.5], dtype=np.float32)
    got = topk.argtopn(scores, n)
    np.testing.assert_array_equal(got, jax_topk.argtopn(scores, n))
    # NaN excluded; equal scores keep their positions' order
    assert not np.isnan(scores[got]).any()
    full = topk.argtopn(scores)
    np.testing.assert_array_equal(full, [2, 5, 0, 3, 7, 4])
    assert len(got) == (6 if n is None or n < 0 else min(n, 6))


@pytest.mark.parametrize(
    "device_type,B,N,k,fused",
    [
        ("cuda", 64, 500_000, 10, True),
        ("cuda", 4096, 500_000, 64, True),
        ("cuda", 64, 27_000, 10, True),  # the batch plays no part
        ("cuda", 1, 27_000, 1, True),
        ("cuda", 4096, 26_999, 10, False),  # below the smallest catalog measured
        ("cuda", 4096, 500_000, 65, False),  # a list longer than the kernel keeps
        ("cuda", 4096, 500_000, 0, False),
        ("cpu", 4096, 500_000, 10, False),  # CPU tensors always take the plain route
        ("meta", 64, 500_000, 10, False),
    ],
)
def test_fused_route_is_a_pure_rule(device_type, B, N, k, fused):
    assert topk.fused_route(device_type, B, N, k) is fused


def test_cpu_tensors_take_the_plain_route_at_every_size():
    rng = np.random.default_rng(4)
    Q = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    for n in (topk.FUSED_RETRIEVAL_MIN_ITEMS - 1, topk.FUSED_RETRIEVAL_MIN_ITEMS, topk.LARGE_CATALOG_ITEMS):
        I = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
        before = mips_topk.launches
        v, i = topk.retrieval_topk(Q, I, 5)
        assert mips_topk.launches == before
        ref = torch.topk(Q @ I.T, 5)
        assert torch.equal(v, ref.values) and torch.equal(i, ref.indices.to(torch.int32))
