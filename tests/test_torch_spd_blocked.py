"""Parity tests for the blocked route of the port's two SPD solves
(``csrc/spd_blocked.cuh``, 128 < k ≤ 256) on the CPU.

``spd_solve_blocked_plain`` walks the kernel's panel order in PyTorch: the
diagonal block a column at a time with a reciprocal square root of each
pivot, the rows below it and z's rows solved against it, the rank-nb update
of the trailing triangle, then both substitutions.  It is held against the
JAX package's own CPU solve (``lkpy_tpu.ops.als.batched_spd_solve``:
Cholesky and ``cho_solve``), a float64 solve and the port's ``spd_solve_plain``;
then an implicit ALS epoch at k = 136 runs through the port on the CPU, with
its solves as they are and with the blocked panel order in their place,
against the JAX package's epoch.  The kernel itself is held against these
plain versions in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  The
Pallas kernel is not run at these widths: in interpret mode it takes tens of
seconds a call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lkpy_tpu.data.matrix import CSR as JaxCSR
from lkpy_tpu.ops import als as jax_als
from lkpy_tpu.ops import sparse as jax_sparse
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.ops import als as torch_als
from lkpy_tpu_torch.ops import sparse as torch_sparse
from lkpy_tpu_torch.ops import spd_solve_chunked as chunked_module
from lkpy_tpu_torch.ops.spd_solve import BLOCK, spd_solve_blocked_plain, spd_solve_plain

torch.set_num_threads(1)


def _spd_batch(rng, N, k, reg=2.0):
    X = rng.standard_normal((N, k, k)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1) + reg * np.eye(k, dtype=np.float32)
    y = rng.standard_normal((N, k)).astype(np.float32)
    return A, y


def _float64(A, y):
    return np.linalg.solve(A.astype(np.float64), y.astype(np.float64)[:, :, None])[:, :, 0]


CASES = [(k, nb, N) for k, N in [(129, 1), (136, 3), (160, 2), (200, 5), (255, 4), (256, 2)] for nb in (16, BLOCK)]


@pytest.mark.parametrize("k,nb,N", CASES)
def test_blocked_plain_matches_jax_solve(k, nb, N):
    rng = np.random.default_rng(k * 100 + nb + N)
    A, y = _spd_batch(rng, N, k)
    ref = np.asarray(jax_als.batched_spd_solve(jnp.asarray(A), jnp.asarray(y)))
    x = spd_solve_blocked_plain(torch.from_numpy(A), torch.from_numpy(y), nb).numpy()
    # tolerance of tests/ops/test_pallas_solve.py::test_batched_spd_solve_dispatch
    np.testing.assert_allclose(x, ref, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("k,nb,N", CASES)
def test_blocked_plain_matches_float64_and_plain(k, nb, N):
    rng = np.random.default_rng(k * 10 + nb + N)
    A, y = _spd_batch(rng, N, k)
    x = spd_solve_blocked_plain(torch.from_numpy(A), torch.from_numpy(y), nb).numpy().astype(np.float64)
    plain = spd_solve_plain(torch.from_numpy(A), torch.from_numpy(y)).numpy().astype(np.float64)
    x64 = _float64(A, y)
    assert np.abs(x - x64).max() / np.abs(x64).max() < 1e-4
    # tests/test_torch_cuda.py::_assert_solves_agree: each row at the scale of its float64 solution, the panel
    # order within twice the plain version's own error of float64, and within three times it of the plain version
    scale = np.abs(x64).max(axis=1, keepdims=True)
    err_plain = (np.abs(plain - x64) / scale).max()
    assert (np.abs(x - x64) / scale).max() <= max(2 * err_plain, 1e-6)
    assert (np.abs(x - plain) / scale).max() <= max(3 * err_plain, 1e-6)


@pytest.mark.parametrize("k,nb", [(40, 16), (129, BLOCK), (256, BLOCK)])
def test_blocked_plain_zero_systems_are_nonfinite_in_their_rows_only(k, nb):
    # explicit ALS's padding rows have A = 0; a negative pivot spoils its own row too
    rng = np.random.default_rng(k)
    A, y = (torch.from_numpy(a) for a in _spd_batch(rng, 5, k))
    A0 = A.clone()
    A0[[1, 3]] = 0.0
    A0[4] = -A0[4]
    clean, got = spd_solve_blocked_plain(A, y, nb), spd_solve_blocked_plain(A0, y, nb)
    assert not torch.isfinite(got[[1, 3, 4]]).any()
    np.testing.assert_array_equal(got[[0, 2]].numpy(), clean[[0, 2]].numpy())


def test_blocked_plain_reads_the_lower_triangle_only():
    rng = np.random.default_rng(9)
    A, y = (torch.from_numpy(a) for a in _spd_batch(rng, 3, 140))
    junk = A.clone()
    junk[:, torch.triu(torch.ones(140, 140, dtype=torch.bool), 1)] = float("nan")
    np.testing.assert_array_equal(spd_solve_blocked_plain(junk, y).numpy(), spd_solve_blocked_plain(A, y).numpy())


#: more users and items than tests/test_torch_training.py's 300 x 120: with
#: fewer items than features the normal equations are singular but for the
#: regularization, and the two packages' rounding parts by 8 % there
N_USERS, N_ITEMS, WIDE_K = 1200, 800, 136


def _wide_epoch_inputs():
    """``tests/test_torch_training.py``'s implicit data (skewed interactions,
    confidences 40 · rating) and squared normal tables, at k = 136."""
    rng = np.random.default_rng(0)
    lens = np.minimum(rng.zipf(1.5, size=N_USERS) + 2, N_ITEMS // 2)
    lens[::17] = 0
    pop = 1.0 / np.arange(1, N_ITEMS + 1) ** 0.7
    pop[-5:] = 0.0
    pop /= pop.sum()
    users = np.repeat(np.arange(N_USERS), lens)
    items = np.concatenate([rng.choice(N_ITEMS, size=n, replace=False, p=pop) for n in lens])
    vals = (rng.integers(1, 11, size=len(users)) / 2.0).astype(np.float32) * 40.0
    j = JaxCSR.from_coo(users, items, vals, (N_USERS, N_ITEMS))
    t = CSR.from_coo(users, items, vals, (N_USERS, N_ITEMS))
    trng = np.random.default_rng(1)
    tables = [(trng.standard_normal((n, WIDE_K)) * 0.1).astype(np.float32) ** 2 for n in (N_USERS, N_ITEMS)]
    return (j, j.transpose()), (t, t.transpose()), tables


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def wide_epoch():
    """The inputs, and the JAX package's epoch from them (most of its time is
    compiling the bucket programs, so both cases share it)."""
    (ju, ji), torch_csrs, tables = _wide_epoch_inputs()
    jub = jax_als.chunk_buckets(jax_sparse.bucket_rows(ju, ratio=1.35))
    jib = jax_als.chunk_buckets(jax_sparse.bucket_rows(ji, ratio=1.35))
    ref = jax_als.als_epoch(jub, jib, jnp.asarray(tables[0]), jnp.asarray(tables[1]), 0.1, 0.1, mode="implicit")
    return torch_csrs, tables, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("solver", ["plain", "blocked"])
def test_wide_implicit_epoch_matches_jax(solver, wide_epoch, monkeypatch):
    """One implicit epoch at k = 136 (the blocked route's widths) through the
    port on the CPU, its chunk solves the plain version or the blocked panel
    order, against the JAX package's epoch from the same tables."""
    (tu, ti), (u0, i0), (ju_t, ji_t, jdu, jdi) = wide_epoch
    solved = []
    if solver == "blocked":

        def blocked(A, y):
            solved.append(y.shape)
            return spd_solve_blocked_plain(A, y)

        monkeypatch.setattr(torch_als, "spd_solve_chunked", blocked)
    tub = torch_als.chunk_buckets(torch_sparse.bucket_rows(tu, ratio=1.35), device="cpu")
    tib = torch_als.chunk_buckets(torch_sparse.bucket_rows(ti, ratio=1.35), device="cpu")
    before = chunked_module.spd_solve_chunked.launches
    tu_t, ti_t, tdu, tdi = torch_als.als_epoch(tub, tib, torch.from_numpy(u0), torch.from_numpy(i0), 0.1, 0.1, mode="implicit")
    assert chunked_module.spd_solve_chunked.launches == before  # CPU tensors launch nothing
    assert (len(solved) == len(tub) + len(tib)) == (solver == "blocked")
    assert all(s[1] == WIDE_K for s in solved)
    assert _rel(tu_t.numpy(), ju_t) <= 1e-4
    assert _rel(ti_t.numpy(), ji_t) <= 1e-4
    np.testing.assert_allclose([float(tdu), float(tdi)], [float(jdu), float(jdi)], rtol=1e-4)
