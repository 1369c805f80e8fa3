"""
Batched small-SPD solve for ALS training: the epoch's row solves.

Port of ``lkpy_tpu/ops/pallas_gj.py::spd_solve_lanes_chunked``, whose Pallas
kernel (``_gj_block_kernel``, blocked Gauss-Jordan with the batch on the
TPU's lanes) becomes the hand-written CUDA kernel
``csrc/spd_solve_chunked.cu``: one warp per system, as many systems per
thread block as shared memory holds, a packed lower triangle in shared
memory, Cholesky with the forward substitution folded in, then the back
substitution.  The batch comes first, with the TPU kernel's C chunks of B
systems flattened into N = C·B, and k is taken as it is (1 ≤ k ≤ 256).

:func:`spd_solve_chunked` launches the kernel for CUDA tensors and runs
:func:`spd_solve_chunked_plain` for CPU tensors.
``spd_solve_chunked.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from lkpy_tpu_torch.ops.spd_solve import spd_solve_plain

__all__ = ["spd_solve_chunked", "spd_solve_chunked_plain"]

#: the largest k the kernel's shared-memory layout takes
MAX_K = 256

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from lkpy_tpu_torch.ops._build import load

        fn = load("spd_solve_chunked").lkt_spd_solve_chunked_f32
        fn.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(A: torch.Tensor, y: torch.Tensor) -> tuple[int, int]:
    if A.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"spd_solve_chunked takes float32 (got A {A.dtype}, y {y.dtype})")
    if y.ndim != 2 or A.shape != (y.shape[0], y.shape[1], y.shape[1]):
        raise ValueError(
            f"spd_solve_chunked needs A (N, k, k) and y (N, k), got {tuple(A.shape)} and {tuple(y.shape)}"
        )
    N, k = y.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"spd_solve_chunked takes 1 <= k <= {MAX_K}, got k={k}")
    if A.device != y.device:
        raise ValueError(f"A and y lie on different devices ({A.device}, {y.device})")
    return N, k


def spd_solve_chunked(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """
    Solve the training path's batch of small SPD systems ``A[i] x[i] = y[i]``.

    Args:
        A: (N, k, k) f32 symmetric positive definite matrices, 1 ≤ k ≤ 256;
            only the lower triangle is read.  N is the chunk's systems (the
            TPU kernel's C chunks of B systems, flattened).
        y: (N, k) f32 right-hand sides.

    Returns:
        (N, k) f32 solutions.  A zero or negative pivot gives non-finite
        values in that system's row only (LAPACK ``sposv``'s contract and
        the TPU kernel's).

    CUDA tensors go to the kernel (contiguous inputs required); CPU tensors
    go to :func:`spd_solve_chunked_plain`.
    """
    N, k = _check(A, y)
    if A.device.type == "cpu":
        return spd_solve_chunked_plain(A, y)
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve_chunked runs on cuda or cpu, not {A.device}")
    if not (A.is_contiguous() and y.is_contiguous()):
        raise ValueError("spd_solve_chunked's kernel takes contiguous A and y")
    x = torch.empty_like(y)
    if N == 0:
        return x
    fn = _kernel()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), y.data_ptr(), x.data_ptr(), N, k, stream)
    if err != 0:
        raise RuntimeError(f"spd_solve_chunked kernel launch failed with CUDA error {err} (N={N}, k={k})")
    spd_solve_chunked.launches += 1
    return x


spd_solve_chunked.launches = 0


def spd_solve_chunked_plain(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch.  The warp kernel walks the same
    operations in the same order as B2's kernel (right-looking Cholesky
    over the columns with the forward substitution folded in, then the back
    substitution, each product, difference and quotient rounded once), so
    the plain version is :func:`~lkpy_tpu_torch.ops.spd_solve.spd_solve_plain`.
    Works on any device."""
    _check(A, y)
    return spd_solve_plain(A, y)
