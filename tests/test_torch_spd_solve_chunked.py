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
from lkpy_tpu_torch.ops.spd_solve_chunked import (
    MAX_REGISTER_K,
    REGISTER_WIDTHS,
    padded_width,
    solve_route,
    spd_solve_chunked,
    spd_solve_chunked_plain,
)

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


@pytest.mark.parametrize(
    "k,route",
    [(1, "registers"), (32, "registers"), (50, "registers"), (64, "registers"), (65, "registers"), (96, "registers"),
     (128, "registers"), (129, "shared"), (200, "shared"), (256, "shared")],
)  # fmt: skip
def test_route_is_chosen_from_k_alone(k, route):
    assert solve_route(k) == route
    assert (k <= MAX_REGISTER_K) == (route == "registers")


@pytest.mark.parametrize("k", [0, -3, 257])
def test_route_rejects_widths_outside_the_contract(k):
    with pytest.raises(ValueError):
        solve_route(k)


@pytest.mark.parametrize("k,width", [(1, 32), (7, 32), (32, 32), (33, 64), (50, 64), (64, 64), (65, 96), (96, 96), (97, 128), (128, 128)])
def test_padded_width_is_the_next_template_width(k, width):
    assert padded_width(k) == width and width in REGISTER_WIDTHS
    assert REGISTER_WIDTHS[-1] == MAX_REGISTER_K
    with pytest.raises(ValueError):
        padded_width(MAX_REGISTER_K + 1)


@pytest.mark.parametrize("k,width", [(50, 64), (7, 32), (33, 64), (70, 96)])
def test_identity_padding_leaves_the_solution_unchanged(k, width):
    # what the register route does inside the kernel, shown on the plain version: bordering A with an
    # identity block and y with zeros solves to the unpadded solution, bit for bit, then zeros
    rng = np.random.default_rng(k)
    A, y = (torch.from_numpy(a) for a in _spd_batch(rng, 9, k))
    Ap = torch.eye(width).repeat(9, 1, 1)
    Ap[:, :k, :k] = A
    yp = torch.zeros(9, width)
    yp[:, :k] = y
    x, xp = spd_solve_chunked_plain(A, y), spd_solve_chunked_plain(Ap, yp)
    np.testing.assert_array_equal(xp[:, :k].numpy(), x.numpy())
    assert (xp[:, k:] == 0).all()


@pytest.mark.parametrize("k", [50, 64, 129])
def test_singular_systems_among_regular_ones_leave_the_regular_rows_unchanged(k):
    rng = np.random.default_rng(100 + k)
    A, y = (torch.from_numpy(a) for a in _spd_batch(rng, 12, k))
    A0 = A.clone()
    A0[[0, 5, 6, 11]] = 0.0
    A0[3] = -A0[3]  # a negative pivot spoils its own row too
    clean, got = spd_solve_chunked(A, y), spd_solve_chunked(A0, y)
    bad = [0, 3, 5, 6, 11]
    good = [i for i in range(12) if i not in bad]
    assert not torch.isfinite(got[bad]).any()
    np.testing.assert_array_equal(got[good].numpy(), clean[good].numpy())


def test_only_the_lower_triangle_is_read():
    rng = np.random.default_rng(9)
    A, y = (torch.from_numpy(a) for a in _spd_batch(rng, 5, 20))
    upper = torch.triu(torch.ones(20, 20, dtype=torch.bool), 1)
    junk = A.clone()
    junk[:, upper] = 1e9
    np.testing.assert_array_equal(spd_solve_chunked(junk, y).numpy(), spd_solve_chunked(A, y).numpy())
