"""
Batched small-SPD solve: the ALS fold-in solver.

Port of ``lkpy_tpu/ops/pallas_solve.py::spd_solve``, whose Pallas kernel
(``_gj_kernel``, Gauss-Jordan in VMEM) becomes the hand-written CUDA kernels
of ``csrc/spd_solve.cu``.  k is taken as it is (1 ≤ k ≤ 256) and B likewise:
no padding in device memory.  Two routes, chosen from (B, k) alone
(:func:`fold_route`):

- ``"registers"``, k ≤ 128: the system's lower triangle lives in the
  registers of 32, 64 or 128 threads through an LDLᵀ elimination and both
  substitutions (``csrc/spd_register.cuh``, shared with the training solve);
  k is padded to 32, 64, 96 or 128 inside the kernel.  A serving block of a
  thousand systems is less than one wave of the card, so its time is one
  system's chain of 2k dependent steps: a small batch spreads each system
  over more threads, a large one takes one warp a system.  Fused
  multiply-adds and a reciprocal of the pivot: agrees with the plain version
  to rounding, not to the bit.
- ``"shared"``, 128 < k ≤ 256: one thread block per system, a packed lower
  triangle in shared memory, Cholesky with the forward substitution folded
  in, then the back substitution, in the plain version's operation order
  (equal to it to the bit).

:func:`spd_solve` launches the kernel for CUDA tensors and runs
:func:`spd_solve_plain` for CPU tensors.  ``spd_solve.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["MAX_REGISTER_K", "fold_mappings", "fold_route", "spd_solve", "spd_solve_plain"]

#: the largest k the shared-memory route's layout takes
MAX_K = 256
#: the largest k the register route has a template instance for
MAX_REGISTER_K = 128
#: threads a system of the register route's compiled mappings, by padded width
REGISTER_THREADS = {32: (32,), 64: (32, 64, 128), 96: (64,), 128: (128,)}
#: warps of a launch (B · threads / 32) up to which a system of width 33–64
#: spreads over ``threads`` threads, set from the grid ``chip_smoke.py``
#: measures on an H100 (132 SMs): four warps a system while each system has
#: an SM to itself, two up to eight warps an SM; past that the mapping with
#: fewer threads a system was the faster
SPREAD_MAX_WARPS = {128: 528, 64: 1056}

_lib = None


def padded_width(k: int) -> int:
    """The template width the register route pads ``k`` to inside the kernel."""
    if not 1 <= k <= MAX_REGISTER_K:
        raise ValueError(f"the register route takes 1 <= k <= {MAX_REGISTER_K}, got k={k}")
    return next(w for w in REGISTER_THREADS if k <= w)


def fold_mappings(k: int) -> list[tuple[str, int]]:
    """Every compiled (route, threads a system) that takes width ``k``: the
    register route's mappings, narrowest first, then the shared-memory route
    (one block of 128 or 256 threads a system)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"spd_solve takes 1 <= k <= {MAX_K}, got k={k}")
    regs = [("registers", t) for t in REGISTER_THREADS[padded_width(k)]] if k <= MAX_REGISTER_K else []
    return regs + [("shared", 128 if k <= 64 else 256)]


def fold_route(B: int, k: int) -> tuple[str, int]:
    """The kernel route a batch of ``B`` systems of width ``k`` takes on the
    card, and the threads that hold one system: ``("registers", 32 | 64 |
    128)`` up to :data:`MAX_REGISTER_K`, ``("shared", 256)`` above it.  Of
    the mappings compiled for the width, the widest whose launch stays
    within :data:`SPREAD_MAX_WARPS` warps is taken, else the narrowest."""
    if B < 1:
        raise ValueError(f"spd_solve's kernel takes B >= 1, got B={B}")
    choices = fold_mappings(k)
    for route, threads in reversed(choices[1:-1]):
        if B * threads // 32 <= SPREAD_MAX_WARPS[threads]:
            return route, threads
    return choices[0]


def _library():
    global _lib
    if _lib is None:
        from lkpy_tpu_torch.ops._build import load

        lib = load("spd_solve")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lkt_spd_solve_reg_f32.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.lkt_spd_solve_shared_f32.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
        lib.lkt_spd_solve_reg_info.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 4
        for fn in (lib.lkt_spd_solve_reg_f32, lib.lkt_spd_solve_shared_f32, lib.lkt_spd_solve_reg_info):
            fn.restype = i32
        _lib = lib
    return _lib


def register_route_info(k: int, threads: int) -> dict:
    """Registers a thread, static shared memory and threads a block, and
    spilled bytes a thread of the register route's instance for ``k`` and
    ``threads`` a system, as compiled (needs the card's toolkit)."""
    out = [ctypes.c_int(0) for _ in range(4)]
    err = _library().lkt_spd_solve_reg_info(padded_width(k), threads, *(ctypes.byref(o) for o in out))
    if err != 0:
        raise RuntimeError(f"spd_solve: no register-route instance for k={k}, threads={threads} (CUDA error {err})")
    regs, smem, block, local = (o.value for o in out)
    return dict(
        width=padded_width(k), threads=threads, registers=regs, shared_bytes=smem, block_threads=block, local_bytes=local
    )


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
        values in that system's row only (the contract of LAPACK ``sposv``
        and of the TPU kernel).

    CUDA tensors go to the kernel of :func:`fold_route` (contiguous inputs
    required); CPU tensors go to :func:`spd_solve_plain`.
    """
    B, k = _check(A, y)
    if A.device.type == "cpu":
        return spd_solve_plain(A, y)
    if B == 0:
        return torch.empty_like(y)
    return _launch(A, y, *fold_route(B, k))


spd_solve.launches = 0


def _launch(A: torch.Tensor, y: torch.Tensor, route: str, threads: int) -> torch.Tensor:
    """Launch the kernel of ``route`` on CUDA tensors with ``threads`` threads
    a system (``"shared"`` takes any k and sets its own threads, so the routes
    and mappings can be timed side by side at one shape)."""
    B, k = _check(A, y)
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve runs on cuda or cpu, not {A.device}")
    if route == "registers" and (route, threads) not in fold_mappings(k):
        raise ValueError(f"the register route has no instance for k={k} over {threads} threads a system")
    if not (A.is_contiguous() and y.is_contiguous()):
        raise ValueError("spd_solve's kernel takes contiguous A and y")
    x = torch.empty_like(y)
    if B == 0:
        return x
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if route == "registers":
            err = lib.lkt_spd_solve_reg_f32(A.data_ptr(), y.data_ptr(), x.data_ptr(), B, k, threads, stream)
        elif route == "shared":
            err = lib.lkt_spd_solve_shared_f32(A.data_ptr(), y.data_ptr(), x.data_ptr(), B, k, stream)
        else:
            raise ValueError(f"spd_solve has the routes 'registers' and 'shared', not {route!r}")
    if err != 0:
        raise RuntimeError(f"spd_solve kernel ({route}, {threads} threads) launch failed with CUDA error {err} (B={B}, k={k})")
    spd_solve.launches += 1
    return x


def spd_solve_plain(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference arithmetic in PyTorch: right-looking Cholesky over the
    columns with the forward substitution folded in, then the back
    substitution; each product, difference and quotient rounded once.  The
    shared-memory route walks the same operations in the same order and
    equals it to the bit; the register route eliminates the same columns
    without the square root and with fused multiply-adds, and agrees to
    rounding.  Works on any device."""
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
