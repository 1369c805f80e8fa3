"""
Batched small-SPD solve for ALS training: the epoch's row solves.

Port of ``lkpy_tpu/ops/pallas_gj.py::spd_solve_lanes_chunked``, whose Pallas
kernel (``_gj_block_kernel``, blocked Gauss-Jordan with the batch on the
TPU's lanes) becomes the hand-written CUDA kernels of
``csrc/spd_solve_chunked.cu``.  The batch comes first, with the TPU kernel's
C chunks of B systems flattened into N = C·B, and k is taken as it is
(1 ≤ k ≤ 256).  Two routes are chosen from k alone (:func:`solve_route`):

- ``"registers"``, k ≤ 128: a warp (two or four warps from k = 65 on) holds
  the system's lower triangle in registers through an LDLᵀ elimination and
  both substitutions (``csrc/spd_register.cuh``, which the fold-in solve
  shares); k is padded to 32, 64, 96 or 128 inside the kernel.
  It uses fused multiply-adds and a reciprocal of the pivot, so it agrees
  with the plain version to rounding, not to the bit.
- ``"blocked"``, 128 < k ≤ 256: a blocked Cholesky, one block a system, 256
  threads up to k = 192 (two blocks an SM) and 512 above
  (``csrc/spd_blocked.cuh``, shared with the fold-in solve): the lower
  triangle in 32 × 32 tiles of shared memory, each panel's diagonal tile
  factored by one warp in registers, the rows below it and z's rows solved
  against it, the trailing triangle updated by register micro-tiles, then
  the back substitution a panel at a time.  A reciprocal square root of each
  pivot and fused multiply-adds: agrees with the plain version to rounding.
  At (29936, 256), the tuner's widest chunk, the operations bound it: 5.72
  Mflop a system, 2.56 ms at the card's f32 rate.

:func:`spd_solve_chunked` launches the kernel for CUDA tensors and runs
:func:`spd_solve_chunked_plain` for CPU tensors.
``spd_solve_chunked.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from lkpy_tpu_torch.ops.spd_solve import MAX_K, MAX_REGISTER_K, REGISTER_THREADS, padded_width, spd_solve_plain

__all__ = ["MAX_REGISTER_K", "spd_solve_chunked", "spd_solve_chunked_plain", "solve_route"]

#: the padded widths the register route is compiled for (the fold-in solve's too)
REGISTER_WIDTHS = tuple(REGISTER_THREADS)

_fns: dict[str, object] = {}


def solve_route(k: int) -> str:
    """The kernel route a width takes on the card: ``"registers"`` up to
    :data:`MAX_REGISTER_K`, ``"blocked"`` above it."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"spd_solve_chunked takes 1 <= k <= {MAX_K}, got k={k}")
    return "registers" if k <= MAX_REGISTER_K else "blocked"


def _kernel(route: str):
    fn = _fns.get(route)
    if fn is None:
        from lkpy_tpu_torch.ops._build import load

        lib = load("spd_solve_chunked")
        fn = {
            "registers": lib.lkt_spd_solve_chunked_reg_f32,
            "blocked": lib.lkt_spd_solve_chunked_blocked_f32,
        }[route]
        fn.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[route] = fn
    return fn


def register_route_info(k: int) -> dict:
    """Registers a thread, static shared memory and threads a block, and
    spilled bytes a thread of the register route's instance for ``k``, as
    compiled (needs the card's toolkit)."""
    from lkpy_tpu_torch.ops._build import load

    fn = load("spd_solve_chunked").lkt_spd_solve_chunked_reg_info
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(4)]
    err = fn(padded_width(k), *(ctypes.byref(o) for o in out))
    if err != 0:
        raise RuntimeError(f"spd_solve_chunked: reading the kernel's attributes failed with CUDA error {err}")
    regs, smem, threads, local = (o.value for o in out)
    return dict(width=padded_width(k), registers=regs, shared_bytes=smem, threads=threads, local_bytes=local)


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

    CUDA tensors go to the kernel of :func:`solve_route` (contiguous inputs
    required); CPU tensors go to :func:`spd_solve_chunked_plain`.
    """
    N, k = _check(A, y)
    if A.device.type == "cpu":
        return spd_solve_chunked_plain(A, y)
    return _launch(A, y, solve_route(k))


spd_solve_chunked.launches = 0


def _launch(A: torch.Tensor, y: torch.Tensor, route: str) -> torch.Tensor:
    """Launch the kernel of ``route`` on CUDA tensors (``"blocked"`` takes
    any k, so the routes can be timed side by side at one shape)."""
    N, k = _check(A, y)
    if route not in ("registers", "blocked"):
        raise ValueError(f"spd_solve_chunked has the routes 'registers' and 'blocked', not {route!r}")
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve_chunked runs on cuda or cpu, not {A.device}")
    if route == "registers" and k > MAX_REGISTER_K:
        raise ValueError(f"the register route takes k <= {MAX_REGISTER_K}, got k={k}")
    if not (A.is_contiguous() and y.is_contiguous()):
        raise ValueError("spd_solve_chunked's kernel takes contiguous A and y")
    x = torch.empty_like(y)
    if N == 0:
        return x
    fn = _kernel(route)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), y.data_ptr(), x.data_ptr(), N, k, stream)
    if err != 0:
        raise RuntimeError(f"spd_solve_chunked kernel ({route}) launch failed with CUDA error {err} (N={N}, k={k})")
    spd_solve_chunked.launches += 1
    return x


def spd_solve_chunked_plain(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference arithmetic in PyTorch: right-looking Cholesky over the
    columns with the forward substitution folded in, then the back
    substitution, each product, difference and quotient rounded once
    (:func:`~lkpy_tpu_torch.ops.spd_solve.spd_solve_plain`).  The register
    route eliminates the same columns without the square root and with fused
    multiply-adds, the blocked route in panels
    (:func:`~lkpy_tpu_torch.ops.spd_solve.spd_solve_blocked_plain`), and
    both agree to rounding.  Works on any device."""
    _check(A, y)
    return spd_solve_plain(A, y)
