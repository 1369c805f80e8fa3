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
from lkpy_tpu_torch.ops import _build
from lkpy_tpu_torch.ops.spd_solve import (
    BLOCKED_THREADS,
    MAX_REGISTER_K,
    REGISTER_THREADS,
    SPREAD_MAX_WARPS,
    _launch,
    fold_mappings,
    fold_route,
    spd_solve,
    spd_solve_plain,
)

torch.set_num_threads(1)


def _spd_batch(rng, B, k, reg=2.0):
    X = rng.standard_normal((B, k, k)).astype(np.float32)
    A = X @ X.transpose(0, 2, 1) + reg * np.eye(k, dtype=np.float32)
    y = rng.standard_normal((B, k)).astype(np.float32)
    return A, y


def _oracle(A, y):
    return np.stack([sla.cho_solve(sla.cho_factor(A[i].astype(np.float64)), y[i]) for i in range(len(y))])


@pytest.mark.parametrize(
    "B,k", [(37, 64), (100, 50), (8, 8), (5, 96), (1, 32), (1, 50), (37, 50), (1, 64), (1, 96), (37, 96)]
)
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


# the grid chip_smoke.py times the mappings on, and both sides of every boundary of the width
@pytest.mark.parametrize(
    "B,k,route",
    [(B, k, ("registers", 32)) for B in (1, 64, 256, 512, 1024, 4096, 16384) for k in (1, 8, 32)]
    + [(B, k, ("registers", 128)) for B in (1, 64, 132) for k in (33, 50, 64)]
    + [(B, k, ("registers", 64)) for B in (133, 256, 512, 528) for k in (33, 50, 64)]
    + [(B, k, ("registers", 32)) for B in (529, 1024, 4096, 16384) for k in (33, 50, 64)]
    + [(B, k, ("registers", 64)) for B in (1, 1024, 16384) for k in (65, 96)]
    + [(B, k, ("registers", 128)) for B in (1, 1024, 16384) for k in (97, 128)]
    + [(B, k, ("blocked", 512)) for B in (1, 64, 132) for k in (129, 160, 192)]
    + [(B, k, ("blocked", 256)) for B in (133, 1024, 16384) for k in (129, 160, 192)]
    + [(B, k, ("blocked", 512)) for B in (1, 1024, 16384) for k in (193, 200, 256)],
)
def test_fold_route_is_chosen_from_the_shape_alone(B, k, route):
    assert fold_route(B, k) == route
    assert (k <= MAX_REGISTER_K) == (route[0] == "registers")
    assert route in fold_mappings(k)


@pytest.mark.parametrize("B,k", [(1, 0), (1, -3), (1, 257), (1024, 257), (0, 64), (-1, 64)])
def test_fold_route_rejects_shapes_outside_the_contract(B, k):
    with pytest.raises(ValueError):
        fold_route(B, k)


@pytest.mark.parametrize("k", [33, 50, 64])
def test_fold_route_spreads_a_system_while_the_warps_fit(k):
    # more threads a system only while the launch's warps stay within the mapping's budget
    last = 128
    for B in range(1, 2000):
        route, threads = fold_route(B, k)
        assert route == "registers" and threads <= last
        assert threads == 32 or B * threads // 32 <= SPREAD_MAX_WARPS[threads]
        last = threads
    assert last == 32


def test_every_mapping_is_whole_warps_in_ascending_order():
    for width, threads in REGISTER_THREADS.items():
        assert list(threads) == sorted(threads) and all(t % 32 == 0 for t in threads)
    assert set(SPREAD_MAX_WARPS) == {t for ts in REGISTER_THREADS.values() for t in ts[1:]}
    assert max(REGISTER_THREADS) == MAX_REGISTER_K
    assert fold_mappings(64) == [("registers", 32), ("registers", 64), ("registers", 128)]
    assert fold_mappings(65) == [("registers", 64)]
    assert fold_mappings(129) == [("blocked", 256), ("blocked", 512)]
    assert fold_mappings(256) == [("blocked", t) for t in BLOCKED_THREADS]


def test_launch_takes_cuda_tensors_only():
    A, y = (torch.from_numpy(a) for a in _spd_batch(np.random.default_rng(2), 3, 8))
    for route, threads in [("registers", 32), ("blocked", 256), ("blocked", 512)]:
        with pytest.raises(ValueError, match="cuda or cpu"):
            _launch(A, y, route, threads)
    meta = torch.eye(4, device="meta").expand(2, 4, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        spd_solve(meta, torch.zeros(2, 4, device="meta"))
    assert spd_solve(A[:0], y[:0]).shape == (0, 8)


@pytest.mark.parametrize("k", [50, 64, 129])
def test_singular_systems_among_regular_ones_leave_the_regular_rows_unchanged(k):
    # the explicit fold-in of a user without history gives A = 0
    rng = np.random.default_rng(200 + k)
    A, y = (torch.from_numpy(a) for a in _spd_batch(rng, 9, k))
    A0 = A.clone()
    A0[[0, 4, 8]] = 0.0
    A0[2] = -A0[2]
    clean, got = spd_solve(A, y), spd_solve(A0, y)
    assert not torch.isfinite(got[[0, 2, 4, 8]]).any()
    np.testing.assert_array_equal(got[[1, 3, 5, 6, 7]].numpy(), clean[[1, 3, 5, 6, 7]].numpy())


def test_only_the_lower_triangle_is_read():
    rng = np.random.default_rng(9)
    A, y = (torch.from_numpy(a) for a in _spd_batch(rng, 5, 20))
    junk = A.clone()
    junk[:, torch.triu(torch.ones(20, 20, dtype=torch.bool), 1)] = 1e9
    np.testing.assert_array_equal(spd_solve(junk, y).numpy(), spd_solve(A, y).numpy())


def test_a_kernel_source_is_hashed_with_the_headers_it_includes(tmp_path, monkeypatch):
    # the two solves share csrc/spd_blocked.cuh and csrc/spd_register.cuh; the top-k kernel includes no header of the port
    for name in ("spd_solve", "spd_solve_chunked"):
        assert [p.name for p in _build.source_files(name)] == [f"{name}.cu", "spd_blocked.cuh", "spd_register.cuh"]
    assert [p.name for p in _build.source_files("mips_topk")] == ["mips_topk.cu"]
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n  # include "b.cuh"\n// #include "not_a_directive.cuh"\n')
    (tmp_path / "b.cuh").write_text('#include "c.cuh"\n#include "b.cuh"\n')
    (tmp_path / "c.cuh").write_text("// leaf\n")
    assert [p.name for p in _build.source_files("a")] == ["a.cu", "b.cuh", "c.cuh"]
    before = _build.library_path("a")
    assert before == _build.library_path("a") and before.name.startswith("liba-")
    (tmp_path / "c.cuh").write_text("// leaf, edited\n")
    assert _build.library_path("a") != before
    (tmp_path / "c.cuh").unlink()
    with pytest.raises(FileNotFoundError, match="c.cuh"):
        _build.library_path("a")
