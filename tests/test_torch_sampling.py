"""The port's negative sampling (``lkpy_tpu_torch.ops.sampling``) against the
JAX package's on the CPU.

Both packages get the same CSR, made with numpy from a seed (300 users × 180
items, 10 items without any user) plus one row that holds every column.
Everything here is integer work, so everything is held equal: the Bloom
words bit for bit, the hash bit positions for every pair (products past
2³¹ included), membership on every positive and 10,000 random pairs, and
the chosen negatives on the same candidates, which the test draws with
``jax.random.randint`` and the JAX sampler's key.  The port's own
generator is held to its contract instead: no accepted positive except
where every attempt was rejected, and frequencies that pass a chi-square
test at p = 1e-6 (the uniform and the popularity weighting).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from lkpy_tpu.data.matrix import CSR as JaxCSR
from lkpy_tpu.ops import sampling as jax_sampling
from lkpy_tpu_torch.data import CSR
from lkpy_tpu_torch.ops import sampling
from lkpy_tpu_torch.ops.sampling import DeviceCSRIndex, choose_negatives, csr_contains, draw_candidates, sample_negatives

torch.set_num_threads(1)

N_USERS, N_ITEMS, EMPTY_ITEMS = 300, 180, 10
FULL_ROW = N_USERS  # the last row holds every column


def _coo(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, size=N_USERS) + 3, 60)
    rows = np.repeat(np.arange(N_USERS), lens)
    cols = np.concatenate([rng.choice(N_ITEMS - EMPTY_ITEMS, size=n, replace=False) for n in lens])
    rows = np.concatenate([rows, np.full(N_ITEMS, FULL_ROW)])
    cols = np.concatenate([cols, np.arange(N_ITEMS)])
    return rows, cols, (N_USERS + 1, N_ITEMS)


@pytest.fixture(scope="module")
def csrs():
    rows, cols, shape = _coo()
    return JaxCSR.from_coo(rows, cols, None, shape), CSR.from_coo(rows, cols, None, shape)


@pytest.fixture(scope="module", params=[True, False], ids=["bloom", "exact"])
def indexes(request, csrs):
    jcsr, tcsr = csrs
    return (
        jax_sampling.DeviceCSRIndex.from_csr(jcsr, bloom=request.param),
        DeviceCSRIndex.from_csr(tcsr, bloom=request.param, device="cpu"),
    )


def test_bloom_words_equal_jax(csrs):
    jcsr, tcsr = csrs
    want, want_bits = jax_sampling._build_bloom(jcsr.rowptr, jcsr.colind, jcsr.nrows)
    got, got_bits = sampling._build_bloom(tcsr.rowptr, tcsr.colind, tcsr.nrows)
    assert got_bits == want_bits and got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    index = DeviceCSRIndex.from_csr(tcsr, device="cpu")
    assert index.log2_bits == want_bits
    np.testing.assert_array_equal(index.bloom.numpy().view(np.uint32), np.asarray(jax_sampling.DeviceCSRIndex.from_csr(jcsr).bloom))


@pytest.mark.parametrize("log2_bits", [10, 17, 28, 32])
def test_bit_positions_equal_jax(log2_bits):
    rng = np.random.default_rng(log2_bits)
    rows = np.concatenate([rng.integers(0, 2**31, 10_000), [0, 1, 2**31 - 1, 65_535, 65_536, 138_000]]).astype(np.int32)
    cols = np.concatenate([rng.integers(0, 2**31, 10_000), [0, 2**31 - 1, 1, 65_536, 65_535, 27_000]]).astype(np.int32)
    want = jax_sampling._bloom_bit_positions(jnp.asarray(rows), jnp.asarray(cols), log2_bits, jnp)
    got = sampling._bloom_bit_positions(torch.from_numpy(rows), torch.from_numpy(cols), log2_bits, torch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    host = sampling._bloom_bit_positions(rows, cols, log2_bits, np)
    for h, w in zip(host, want):
        np.testing.assert_array_equal(h, np.asarray(w))


def test_csr_contains_equal_jax(csrs, indexes):
    jcsr, tcsr = csrs
    jidx, tidx = indexes
    rng = np.random.default_rng(1)
    pos_rows = np.repeat(np.arange(tcsr.nrows), tcsr.row_lengths()).astype(np.int32)
    rows = np.concatenate([pos_rows, rng.integers(0, tcsr.nrows, 10_000)]).astype(np.int32)
    cols = np.concatenate([tcsr.colind, rng.integers(0, N_ITEMS, 10_000)]).astype(np.int32)
    want = np.asarray(jax_sampling.csr_contains(jidx, jnp.asarray(rows), jnp.asarray(cols)))
    got = csr_contains(tidx, torch.from_numpy(rows), torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[: len(pos_rows)].all()
    truth = np.isin(rows * N_ITEMS + cols, pos_rows.astype(np.int64) * N_ITEMS + tcsr.colind)
    np.testing.assert_array_equal(got, truth)


@pytest.mark.parametrize("weighting", ["uniform", "popularity"])
@pytest.mark.parametrize("max_attempts", [1, 16])
@pytest.mark.parametrize("n", [1, 3])
def test_chosen_negatives_equal_jax(csrs, indexes, weighting, max_attempts, n):
    jcsr, tcsr = csrs
    jidx, tidx = indexes
    rows = np.concatenate([np.arange(tcsr.nrows), np.arange(tcsr.nrows)[::-1], [FULL_ROW] * 5]).astype(np.int32)
    key = jax.random.key(7)
    want = np.asarray(
        jax_sampling.sample_negatives(key, jidx, jnp.asarray(rows), n=n, weighting=weighting, max_attempts=max_attempts)
    )
    # the candidates the JAX sampler drew from the same key
    shape = (len(rows), n, max_attempts)
    if weighting == "popularity":
        cands = np.array(jidx.colind)[np.asarray(jax.random.randint(key, shape, 0, jcsr.nnz))]
    else:
        cands = np.array(jax.random.randint(key, shape, 0, N_ITEMS, dtype=jnp.int32))
    got = choose_negatives(tidx, torch.from_numpy(rows), torch.from_numpy(cands)).numpy()
    np.testing.assert_array_equal(got, want)
    # the full row rejects every attempt and keeps its last draw
    np.testing.assert_array_equal(got[rows == FULL_ROW], cands[rows == FULL_ROW][:, :, -1])


@pytest.mark.parametrize("weighting", ["uniform", "popularity"])
def test_own_generator_accepts_positives_only_when_every_attempt_hit(csrs, weighting):
    _, tcsr = csrs
    index = DeviceCSRIndex.from_csr(tcsr, device="cpu")
    exact = DeviceCSRIndex.from_csr(tcsr, bloom=False, device="cpu")
    rows = torch.arange(tcsr.nrows).repeat(20)
    gen = torch.Generator().manual_seed(3)
    cands = draw_candidates(gen, index, len(rows), 2, 16, weighting)
    picks = choose_negatives(index, rows, cands)
    np.testing.assert_array_equal(
        sample_negatives(torch.Generator().manual_seed(3), index, rows, n=2, weighting=weighting).numpy(), picks.numpy()
    )
    positive = csr_contains(exact, rows[:, None], picks)
    all_hit = sampling._bloom_contains(index, rows[:, None, None], cands).all(dim=2)
    assert not (positive & ~all_hit).any()
    assert bool(positive[rows == FULL_ROW].all())
    print(f"accepted positives outside the full row: {int(positive[rows != FULL_ROW].sum())}")


@pytest.mark.parametrize("weighting", ["uniform", "popularity"])
def test_own_generator_frequencies(csrs, weighting):
    """One row's negatives, 40,000 draws: uniform over its negative columns,
    or proportional to their interaction counts (chi-square, p = 1e-6)."""
    _, tcsr = csrs
    index = DeviceCSRIndex.from_csr(tcsr, bloom=False, device="cpu")
    row = int(np.argmax(tcsr.row_lengths()[:N_USERS]))
    draws = 40_000
    negs = sample_negatives(
        torch.Generator().manual_seed(11), index, torch.full((draws,), row), n=1, weighting=weighting
    ).numpy()[:, 0]
    positives = tcsr.row_cols(row)
    assert not np.isin(negs, positives).any()
    weight = np.bincount(tcsr.colind, minlength=N_ITEMS).astype(np.float64) if weighting == "popularity" else np.ones(N_ITEMS)
    weight[positives] = 0
    support = weight > 0
    expected = draws * weight[support] / weight.sum()
    observed = np.bincount(negs, minlength=N_ITEMS)[support]
    assert observed.sum() == draws
    stat = float(((observed - expected) ** 2 / expected).sum())
    assert stat < scipy.stats.chi2.ppf(1 - 1e-6, support.sum() - 1)
