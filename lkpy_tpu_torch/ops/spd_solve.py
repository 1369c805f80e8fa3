"""
Batched small-SPD solve: the ALS fold-in solver.

Port of ``lkpy_tpu/ops/pallas_solve.py::spd_solve``, whose Pallas kernel
(``_gj_kernel``, Gauss-Jordan in VMEM) becomes the hand-written CUDA kernel
``csrc/spd_solve.cu``: one thread block per system, a packed lower triangle
in shared memory, Cholesky with the forward substitution folded in, then the
back substitution.  k is taken as it is (1 ≤ k ≤ 256): no padding.

:func:`spd_solve` launches the kernel for CUDA tensors and runs
:func:`spd_solve_plain`, the same arithmetic written out in PyTorch, for CPU
tensors.  ``spd_solve.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["spd_solve", "spd_solve_plain"]

#: the largest k the kernel's shared-memory layout takes
MAX_K = 256

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from lkpy_tpu_torch.ops._build import load

        fn = load("spd_solve").lkt_spd_solve_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(A: torch.Tensor, y: torch.Tensor) -> tuple[int, int]:
    if A.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"spd_solve takes float32 (got A {A.dtype}, y {y.dtype})")
    if y.ndim != 2 or A.shape != (y.shape[0], y.shape[1], y.shape[1]):
        raise ValueError(f"spd_solve needs A (B, k, k) and y (B, k), got {tuple(A.shape)} and {tuple(y.shape)}")
    B, k = y.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"spd_solve takes 1 <= k <= {MAX_K}, got k={k}")
    if A.device != y.device:
        raise ValueError(f"A and y lie on different devices ({A.device}, {y.device})")
    return B, k


def spd_solve(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """
    Solve a batch of small SPD systems ``A[i] x[i] = y[i]``.

    Args:
        A: (B, k, k) f32 symmetric positive definite matrices, 1 ≤ k ≤ 256;
            only the lower triangle is read.
        y: (B, k) f32 right-hand sides.

    Returns:
        (B, k) f32 solutions.  A zero or negative pivot gives non-finite
        values (the contract of LAPACK ``sposv`` and of the TPU kernel).

    CUDA tensors go to the kernel (contiguous inputs required); CPU tensors
    go to :func:`spd_solve_plain`.
    """
    B, k = _check(A, y)
    if A.device.type == "cpu":
        return spd_solve_plain(A, y)
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve runs on cuda or cpu, not {A.device}")
    if not (A.is_contiguous() and y.is_contiguous()):
        raise ValueError("spd_solve's kernel takes contiguous A and y")
    x = torch.empty_like(y)
    if B == 0:
        return x
    fn = _kernel()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), y.data_ptr(), x.data_ptr(), B, k, stream)
    if err != 0:
        raise RuntimeError(f"spd_solve kernel launch failed with CUDA error {err} (B={B}, k={k})")
    spd_solve.launches += 1
    return x


spd_solve.launches = 0


def spd_solve_plain(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: right-looking Cholesky over the
    columns with the forward substitution folded in, then the back
    substitution; each product and difference rounded once, as the kernel
    does.  Works on any device."""
    _check(A, y)
    k = y.shape[1]
    L = A.clone()
    z = y.clone()
    for j in range(k):
        d = torch.sqrt(L[:, j, j])
        col = L[:, j + 1 :, j] / d[:, None]
        zj = z[:, j] / d
        z[:, j] = zj
        L[:, j + 1 :, j] = col
        L[:, j + 1 :, j + 1 :] -= col[:, :, None] * col[:, None, :]
        z[:, j + 1 :] -= col * zj[:, None]
        L[:, j, j] = d
    x = torch.empty_like(z)
    for j in reversed(range(k)):
        xj = z[:, j] / L[:, j, j]
        x[:, j] = xj
        z[:, :j] -= L[:, j, :j] * xj[:, None]
    return x
