"""Parity tests for the port's training solve (``lkpy_tpu_torch.ops.spd_solve_chunked``).

The plain PyTorch version is held against the JAX package's blocked
Gauss-Jordan Pallas kernel (``spd_solve_lanes_chunked``), run in interpret
mode on the CPU as ``tests/ops/test_pallas_gj.py`` runs it, and against a
float64 solve.  The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lkpy_tpu.ops.pallas_gj import spd_solve_lanes_chunked
from lkpy_tpu_torch.ops.spd_solve import spd_solve_plain
from lkpy_tpu_torch.ops.spd_solve_chunked import spd_solve_chunked, spd_solve_chunked_plain

torch.set_num_threads(1)


def _spd_batch(rng, N, k, reg=2.0):
    X = rng.standard_normal((N, k, k)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1) + reg * np.eye(k, dtype=np.float32)
    y = rng.standard_normal((N, k)).astype(np.float32)
    return A, y


@pytest.mark.parametrize("C,B,k", [(3, 20, 8), (2, 37, 24), (2, 9, 64)])
def test_plain_matches_pallas_gj(C, B, k):
    rng = np.random.default_rng(C * 1000 + B * 10 + k)
    A, y = _spd_batch(rng, C * B, k)
    # the TPU kernel's layout: A (C, k, k, B), y (C, k, B), batch last
    A_l = np.ascontiguousarray(np.transpose(A.reshape(C, B, k, k), (0, 2, 3, 1)))
    y_l = np.ascontiguousarray(np.transpose(y.reshape(C, B, k), (0, 2, 1)))
    ref = np.transpose(np.asarray(spd_solve_lanes_chunked(jnp.asarray(A_l), jnp.asarray(y_l))), (0, 2, 1))
    x = spd_solve_chunked(torch.from_numpy(A), torch.from_numpy(y)).numpy().reshape(C, B, k)
    # tolerance of tests/ops/test_pallas_solve.py::test_batched_spd_solve_dispatch:
    # Gauss-Jordan and Cholesky round differently in f32
    np.testing.assert_allclose(x, ref, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("N,k", [(40, 1), (25, 50), (3, 256)])
def test_plain_matches_float64(N, k):
    # k need not be a multiple of 8: the port pads nothing
    rng = np.random.default_rng(N + k)
    A, y = _spd_batch(rng, N, k)
    x = spd_solve_chunked(torch.from_numpy(A), torch.from_numpy(y)).numpy()
    ref = np.linalg.solve(A.astype(np.float64), y.astype(np.float64)[:, :, None])[:, :, 0]
    assert np.abs(x - ref).max() / np.abs(ref).max() < 1e-4


def test_zero_systems_are_nonfinite_in_their_rows_only():
    # explicit ALS's padding rows have A = 0
    rng = np.random.default_rng(5)
    A, y = _spd_batch(rng, 6, 16)
    A[[1, 4]] = 0.0
    x = spd_solve_chunked(torch.from_numpy(A), torch.from_numpy(y)).numpy()
    assert not np.isfinite(x[[1, 4]]).any()
    assert np.isfinite(x[[0, 2, 3, 5]]).all()


def test_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(1)
    A, y = (torch.from_numpy(a) for a in _spd_batch(rng, 10, 12))
    before = spd_solve_chunked.launches
    x = spd_solve_chunked(A, y)
    assert spd_solve_chunked.launches == before
    # the kernel's operation order is the fold-in kernel's: one plain version
    np.testing.assert_array_equal(x.numpy(), spd_solve_chunked_plain(A, y).numpy())
    np.testing.assert_array_equal(x.numpy(), spd_solve_plain(A, y).numpy())
    assert spd_solve_chunked(A[:0], y[:0]).shape == (0, 12)


@pytest.mark.parametrize(
    "A_shape,y_shape,dtype,err",
    [
        ((2, 4, 4), (2, 4), torch.float64, TypeError),
        ((2, 4, 5), (2, 4), torch.float32, ValueError),
        ((3, 4, 4), (2, 4), torch.float32, ValueError),
        ((2, 1, 4, 4), (2, 1, 4), torch.float32, ValueError),
        ((2, 257, 257), (2, 257), torch.float32, ValueError),
        ((2, 0, 0), (2, 0), torch.float32, ValueError),
    ],
)
def test_rejects_bad_input(A_shape, y_shape, dtype, err):
    with pytest.raises(err):
        spd_solve_chunked(torch.zeros(A_shape, dtype=dtype), torch.zeros(y_shape, dtype=dtype))


def test_rejects_other_devices():
    A = torch.eye(4, device="meta").expand(2, 4, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        spd_solve_chunked(A, torch.zeros(2, 4, device="meta"))
