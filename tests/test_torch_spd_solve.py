"""Parity tests for the port's batched SPD solve (``lkpy_tpu_torch.ops.spd_solve``).

The plain PyTorch version is held against the JAX package's Pallas kernel,
run in interpret mode on the CPU as ``tests/ops/test_pallas_solve.py`` runs
it, and against LAPACK.  The CUDA kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from lkpy_tpu.ops.pallas_solve import spd_solve as jax_spd_solve
from lkpy_tpu_torch import resolve_device
from lkpy_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain

torch.set_num_threads(1)


def _spd_batch(rng, B, k, reg=2.0):
    X = rng.standard_normal((B, k, k)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1) + reg * np.eye(k, dtype=np.float32)
    y = rng.standard_normal((B, k)).astype(np.float32)
    return A, y


def _oracle(A, y):
    return np.stack([sla.cho_solve(sla.cho_factor(A[i].astype(np.float64)), y[i]) for i in range(len(y))])


@pytest.mark.parametrize("B,k", [(37, 64), (100, 50), (8, 8), (5, 96), (1, 32)])
def test_plain_matches_pallas(B, k):
    rng = np.random.default_rng(B * 100 + k)
    A, y = _spd_batch(rng, B, k)
    ref = np.asarray(jax_spd_solve(jnp.asarray(A), jnp.asarray(y)))
    x = spd_solve(torch.from_numpy(A), torch.from_numpy(y)).numpy()
    # tolerance of tests/ops/test_pallas_solve.py::test_batched_spd_solve_dispatch:
    # Gauss-Jordan and Cholesky round differently in f32
    np.testing.assert_allclose(x, ref, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("B,k", [(37, 64), (100, 50), (8, 8), (5, 96), (1, 32), (2, 256)])
def test_plain_matches_lapack(B, k):
    rng = np.random.default_rng(B * 100 + k)
    A, y = _spd_batch(rng, B, k)
    x = spd_solve_plain(torch.from_numpy(A), torch.from_numpy(y)).numpy()
    ref = _oracle(A, y)
    err = np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-9)
    assert err < 2e-3


def test_ill_conditioned():
    # the case of tests/ops/test_pallas_solve.py::test_spd_solve_ill_conditioned
    rng = np.random.default_rng(9)
    B, k = 20, 64
    A, y = _spd_batch(rng, B, k, reg=0.01)
    A = A * np.logspace(0, 3, B).astype(np.float32)[:, None, None]
    x = spd_solve(torch.from_numpy(A), torch.from_numpy(y)).numpy()
    ref = _oracle(A, y)
    resid = np.abs(np.einsum("bij,bj->bi", A, x) - y).max()
    resid_ref = np.abs(np.einsum("bij,bj->bi", A, ref) - y).max()
    assert resid < max(10 * resid_ref, 1e-2)


def test_zero_diagonal_is_nonfinite():
    rng = np.random.default_rng(5)
    A, y = _spd_batch(rng, 3, 16)
    A[1] = 0.0
    x = spd_solve(torch.from_numpy(A), torch.from_numpy(y)).numpy()
    assert not np.isfinite(x[1]).any()
    assert np.isfinite(x[[0, 2]]).all()


def test_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(1)
    A, y = (torch.from_numpy(a) for a in _spd_batch(rng, 4, 12))
    before = spd_solve.launches
    np.testing.assert_array_equal(spd_solve(A, y).numpy(), spd_solve_plain(A, y).numpy())
    assert spd_solve.launches == before


@pytest.mark.parametrize(
    "A_shape,y_shape,dtype,err",
    [
        ((2, 4, 4), (2, 4), torch.float64, TypeError),
        ((2, 4, 5), (2, 4), torch.float32, ValueError),
        ((2, 257, 257), (2, 257), torch.float32, ValueError),
    ],
)
def test_rejects_bad_input(A_shape, y_shape, dtype, err):
    with pytest.raises(err):
        spd_solve(torch.zeros(A_shape, dtype=dtype), torch.zeros(y_shape, dtype=dtype))


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
