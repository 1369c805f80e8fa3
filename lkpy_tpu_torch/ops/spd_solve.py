"""
Batched small-SPD solve: the ALS fold-in solver.

Port of ``lkpy_tpu/ops/pallas_solve.py::spd_solve``, whose Pallas kernel
(``_gj_kernel``, Gauss-Jordan in VMEM) becomes the hand-written CUDA kernels
of ``csrc/spd_solve.cu``.  k is taken as it is (1 ≤ k ≤ 256) and B likewise:
no padding in device memory.  Two routes are chosen from (B, k) alone
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
- ``"blocked"``, 128 < k ≤ 256: a blocked Cholesky, one block of 256 or 512
  threads a system (``csrc/spd_blocked.cuh``, shared with the training
  solve): the lower triangle in 32 × 32 tiles of shared memory, each panel's
  diagonal tile factored by one warp in registers, the rows below it solved
  against it with z riding along, the trailing triangle updated by register
  micro-tiles, then the back substitution a panel at a time.  A reciprocal
  square root of each pivot and fused multiply-adds: agrees with the plain
  version to rounding.  :func:`spd_solve_blocked_plain` is its panel order
  in PyTorch.

:func:`spd_solve` launches the kernel for CUDA tensors and runs
:func:`spd_solve_plain` for CPU tensors.  ``spd_solve.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["MAX_REGISTER_K", "fold_mappings", "fold_route", "spd_solve", "spd_solve_blocked_plain", "spd_solve_plain"]

#: the largest k the kernels take (the blocked route's eight tiles of 32)
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
#: threads a system of the blocked route's compiled mappings
BLOCKED_THREADS = (256, 512)
#: the blocked route's tile width, and a panel's
BLOCK = 32
#: systems up to which a system of width 129–192 takes 512 threads, and the
#: width from which every batch does (where one block fills an SM's shared
#: memory): set from the grid of B ∈ {1, 64, 1024, 16384} × k ∈ {129, 160,
#: 192, 256} that ``chip_smoke.py`` measures on an H100, where 512 threads
#: were 1–3 % faster up to B = 64 and at every B at k = 256, and 256 threads
#: (two blocks an SM) 1.4–1.5× faster from B = 1,024 at k ≤ 192
BLOCKED_SPREAD_MAX_B = 132
BLOCKED_SPREAD_FROM_K = 193

_lib = None


def padded_width(k: int) -> int:
    """The template width the register route pads ``k`` to inside the kernel."""
    if not 1 <= k <= MAX_REGISTER_K:
        raise ValueError(f"the register route takes 1 <= k <= {MAX_REGISTER_K}, got k={k}")
    return next(w for w in REGISTER_THREADS if k <= w)


def fold_mappings(k: int) -> list[tuple[str, int]]:
    """Every (route, threads a system) that ``fold_route`` may take at width
    ``k``: the register route's mappings, narrowest first, up to
    :data:`MAX_REGISTER_K`, the blocked route's above it."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"spd_solve takes 1 <= k <= {MAX_K}, got k={k}")
    if k <= MAX_REGISTER_K:
        return [("registers", t) for t in REGISTER_THREADS[padded_width(k)]]
    return [("blocked", t) for t in BLOCKED_THREADS]


def fold_route(B: int, k: int) -> tuple[str, int]:
    """The kernel route a batch of ``B`` systems of width ``k`` takes on the
    card, and the threads that hold one system: ``("registers", 32 | 64 |
    128)`` up to :data:`MAX_REGISTER_K`, ``("blocked", 256 | 512)`` above it.
    Of the register mappings compiled for the width, the widest whose launch
    stays within :data:`SPREAD_MAX_WARPS` warps is taken, else the
    narrowest; a blocked system takes 512 threads from
    :data:`BLOCKED_SPREAD_FROM_K` on or up to :data:`BLOCKED_SPREAD_MAX_B`
    systems, else 256."""
    if B < 1:
        raise ValueError(f"spd_solve's kernel takes B >= 1, got B={B}")
    choices = fold_mappings(k)
    if k > MAX_REGISTER_K:
        return ("blocked", 512 if k >= BLOCKED_SPREAD_FROM_K or B <= BLOCKED_SPREAD_MAX_B else 256)
    for route, threads in reversed(choices[1:]):
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
        lib.lkt_spd_solve_blocked_f32.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.lkt_spd_solve_reg_info.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 4
        lib.lkt_spd_solve_blocked_info.argtypes = [i32] + [ctypes.POINTER(i32)] * 2
        for fn in (
            lib.lkt_spd_solve_reg_f32, lib.lkt_spd_solve_blocked_f32,
            lib.lkt_spd_solve_reg_info, lib.lkt_spd_solve_blocked_info,
        ):  # fmt: skip
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


def blocked_route_info(threads: int) -> dict:
    """Registers and spilled bytes a thread of the blocked route's instance
    over ``threads`` threads a system, as compiled (needs the card's
    toolkit)."""
    out = [ctypes.c_int(0) for _ in range(2)]
    err = _library().lkt_spd_solve_blocked_info(threads, *(ctypes.byref(o) for o in out))
    if err != 0:
        raise RuntimeError(f"spd_solve: no blocked-route instance over {threads} threads (CUDA error {err})")
    return dict(threads=threads, registers=out[0].value, local_bytes=out[1].value)


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
    a system (``"blocked"`` takes any k, so the routes and mappings can be
    timed side by side at one shape)."""
    B, k = _check(A, y)
    if route not in ("registers", "blocked"):
        raise ValueError(f"spd_solve has the routes 'registers' and 'blocked', not {route!r}")
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve runs on cuda or cpu, not {A.device}")
    if route == "registers" and (route, threads) not in fold_mappings(k):
        raise ValueError(f"the register route has no instance for k={k} over {threads} threads a system")
    if route == "blocked" and threads not in BLOCKED_THREADS:
        raise ValueError(f"the blocked route has instances over {BLOCKED_THREADS} threads a system, not {threads}")
    if not (A.is_contiguous() and y.is_contiguous()):
        raise ValueError("spd_solve's kernel takes contiguous A and y")
    x = torch.empty_like(y)
    if B == 0:
        return x
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        fn = lib.lkt_spd_solve_reg_f32 if route == "registers" else lib.lkt_spd_solve_blocked_f32
        err = fn(A.data_ptr(), y.data_ptr(), x.data_ptr(), B, k, threads, stream)
    if err != 0:
        raise RuntimeError(f"spd_solve kernel ({route}, {threads} threads) launch failed with CUDA error {err} (B={B}, k={k})")
    spd_solve.launches += 1
    return x


def spd_solve_plain(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference arithmetic in PyTorch: right-looking Cholesky over the
    columns with the forward substitution folded in, then the back
    substitution; each product, difference and quotient rounded once.  The
    register route eliminates the same columns without the square root and
    with fused multiply-adds, the blocked route in panels
    (:func:`spd_solve_blocked_plain`), and both agree to rounding.  Works on
    any device."""
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


def _solve_block_rows(rows: torch.Tensor, D: torch.Tensor, dinv: torch.Tensor) -> torch.Tensor:
    """Rows (B, m, w) solved against the factored diagonal block D (B, w, w)
    in place, as the kernel solves a panel row: x_c = a_c / L[c][c], then
    a_c' -= x_c L[c'][c] for c' > c."""
    for c in range(D.shape[1]):
        xc = rows[:, :, c] * dinv[:, c, None]
        rows[:, :, c] = xc
        rows[:, :, c + 1 :] -= xc[:, :, None] * D[:, None, c + 1 :, c]
    return rows


def spd_solve_blocked_plain(A: torch.Tensor, y: torch.Tensor, nb: int = BLOCK) -> torch.Tensor:
    """The blocked route's panel order in PyTorch, panels of ``nb`` columns
    (the last one narrower where ``nb`` does not divide k; the kernel pads
    with an identity block instead, which changes nothing): the diagonal
    block factored a column at a time with a reciprocal square root of each
    pivot, the rows below it and z's rows solved against it, the rank-``nb``
    update of the trailing triangle and of z; then each diagonal block's
    inverse (its identity rows solved against it) and the back substitution
    with Lᵀ a panel at a time from the last, a product with the inverse's
    transpose.  Only the lower triangle of ``A`` is read; a pivot that is not
    positive gives NaN, which fills that system's row.  Works on any device;
    the tests hold it against the JAX package's solve and the kernel's
    rounding is its own."""
    _check(A, y)
    B, k = y.shape
    L = torch.tril(A)
    z = y.clone()
    dinv = torch.empty_like(y)
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    starts = range(0, k, nb)
    for p0 in starts:
        p1 = min(p0 + nb, k)
        for j in range(p0, p1):
            piv = L[:, j, j]
            inv = torch.where(piv > 0, torch.rsqrt(piv), nan)
            dinv[:, j] = inv
            L[:, j:p1, j] *= inv[:, None]
            col = L[:, j + 1 : p1, j]
            L[:, j + 1 : p1, j + 1 : p1] -= col[:, :, None] * col[:, None, :]
        # the rows below the diagonal block, and z's panel rows as one more row
        rows = torch.cat([L[:, p1:, p0:p1], z[:, None, p0:p1]], dim=1)
        _solve_block_rows(rows, L[:, p0:p1, p0:p1], dinv[:, p0:p1])
        L[:, p1:, p0:p1] = rows[:, :-1]
        z[:, p0:p1] = rows[:, -1]
        L21 = L[:, p1:, p0:p1]
        L[:, p1:, p1:] -= L21 @ L21.transpose(1, 2)
        z[:, p1:] -= (L21 @ z[:, p0:p1, None])[:, :, 0]
    for p0 in reversed(starts):
        p1 = min(p0 + nb, k)
        w = p1 - p0
        # row c of inv_t: the solve of e_c, column c of the block's inverse
        inv_t = _solve_block_rows(torch.eye(w, dtype=A.dtype, device=A.device).repeat(B, 1, 1), L[:, p0:p1, p0:p1], dinv[:, p0:p1])
        r = z[:, p0:p1] - (L[:, p1:, p0:p1].transpose(1, 2) @ z[:, p1:, None])[:, :, 0]
        z[:, p0:p1] = (inv_t @ r[:, :, None])[:, :, 0]
    return z
