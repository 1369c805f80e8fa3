"""
Fused maximum-inner-product top-k: the large-catalog retrieval kernel.

Port of ``lkpy_tpu/ops/pallas_topk.py`` (``mips_topk``), whose Pallas kernel
(``_topk_kernel``: score tile on the MXU, k rounds of max-extraction into a
running top-k in VMEM) becomes the hand-written CUDA kernel
``csrc/mips_topk.cu``: a register-tiled f32 product with a per-query sorted
top-k in shared memory that a score enters only past the current k-th value.
Nothing here is Pallas, hence the module's name.  The (B, N) score matrix
never reaches device memory.

:func:`mips_topk` launches the kernel for CUDA tensors and runs
:func:`mips_topk_plain`, the same function in plain PyTorch, for CPU tensors.
``mips_topk.launches`` counts kernel launches.  The kernel takes B, N and D
as they come and masks its own ragged edges, so the TPU kernel's ``qb`` and
``nt`` tiling arguments have no counterpart.

The kernel sums each product over D in order with fused multiply-adds; the
plain version leaves the order to ``torch.matmul``.  Only agreement to a
tolerance (about 1e-5 relative) is promised, not to the bit, though runs on
an H100 showed no difference at all (PERF.md).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["MAX_FUSED_K", "mips_topk", "mips_topk_plain"]

#: the largest k the kernel's shared-memory lists hold (the TPU kernel's cap)
MAX_FUSED_K = 64

#: the index of a slot beyond the number of scoreable items
INT32_MAX = int(np.iinfo(np.int32).max)

# the plain version scores this many entries at a time: a (rows, N) f32 slab of 1 GiB
_PLAIN_SLAB_ENTRIES = 1 << 28

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from lkpy_tpu_torch.ops._build import load

        fn = load("mips_topk").lkt_mips_topk_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(queries, items, k: int, i_bias, exclude) -> tuple[int, int, int]:
    if k > MAX_FUSED_K:
        raise ValueError(f"fused top-k supports k <= {MAX_FUSED_K}, got {k}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if queries.dtype != torch.float32 or items.dtype != torch.float32:
        raise TypeError(f"mips_topk takes float32 (got queries {queries.dtype}, items {items.dtype})")
    if queries.ndim != 2 or items.ndim != 2 or queries.shape[1] != items.shape[1] or queries.shape[1] < 1:
        raise ValueError(
            f"mips_topk needs queries (B, D) and items (N, D), got {tuple(queries.shape)} and {tuple(items.shape)}"
        )
    B, D = queries.shape
    N = items.shape[0]
    if N > INT32_MAX - 256:
        raise ValueError(f"mips_topk takes fewer than 2**31 - 256 items, got {N}")
    tensors = [queries, items]
    if i_bias is not None:
        if i_bias.dtype != torch.float32 or i_bias.shape != (N,):
            raise ValueError(f"i_bias must be float32 of shape ({N},), got {i_bias.dtype} {tuple(i_bias.shape)}")
        tensors.append(i_bias)
    if exclude is not None:
        if exclude.dtype not in (torch.bool, torch.int8, torch.uint8) or exclude.shape != (B, N):
            raise ValueError(
                f"exclude must be bool, int8 or uint8 of shape ({B}, {N}), got {exclude.dtype} {tuple(exclude.shape)}"
            )
        tensors.append(exclude)
    for t in tensors[1:]:
        if t.device != queries.device:
            raise ValueError(f"mips_topk's arguments lie on different devices ({queries.device}, {t.device})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mips_topk takes contiguous tensors")
    return B, N, D


def mips_topk(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    *,
    i_bias: torch.Tensor | None = None,
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """
    Exact top-k maximum-inner-product search.

    Args:
        queries: (B, D) f32 query vectors.
        items: (N, D) f32 item vectors.
        k: list length (≤ :data:`MAX_FUSED_K`); may exceed N.
        i_bias: optional (N,) f32 additive item bias.
        exclude: optional (B, N) bool/int8/uint8: nonzero entries are
            excluded (scored −inf).

    Returns:
        (values (B, k) f32 descending, indices (B, k) int32).  Equal scores
        come smaller index first; slots beyond the number of scoreable
        items hold (−inf, INT32_MAX).

    CUDA tensors go to the kernel; CPU tensors go to :func:`mips_topk_plain`.
    """
    B, N, D = _check(queries, items, k, i_bias, exclude)
    dev = queries.device
    if dev.type == "cpu":
        return mips_topk_plain(queries, items, k, i_bias=i_bias, exclude=exclude)
    if dev.type != "cuda":
        raise ValueError(f"mips_topk runs on cuda or cpu, not {dev}")
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, idx
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            queries.data_ptr(),
            items.data_ptr(),
            None if i_bias is None else i_bias.data_ptr(),
            None if exclude is None else exclude.data_ptr(),
            vals.data_ptr(),
            idx.data_ptr(),
            B,
            N,
            D,
            k,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"mips_topk kernel launch failed with CUDA error {err} (B={B}, N={N}, D={D}, k={k})")
    mips_topk.launches += 1
    return vals, idx


mips_topk.launches = 0


def mips_topk_plain(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    *,
    i_bias: torch.Tensor | None = None,
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device: score a slab of
    queries against all items, then a stable descending sort, which keeps
    equal scores in index order (``torch.topk`` promises no order among
    ties).  The queries are scored in slabs so that no (rows, N) matrix
    over 1 GiB is made."""
    B, N, _ = _check(queries, items, k, i_bias, exclude)
    dev = queries.device
    vals = torch.full((B, k), -torch.inf, dtype=torch.float32, device=dev)
    idx = torch.full((B, k), INT32_MAX, dtype=torch.int32, device=dev)
    kk = min(k, N)
    if kk == 0:
        return vals, idx
    rows = max(1, _PLAIN_SLAB_ENTRIES // N)
    for lo in range(0, B, rows):
        s = queries[lo : lo + rows] @ items.T
        if i_bias is not None:
            s += i_bias
        if exclude is not None:
            s.masked_fill_(exclude[lo : lo + rows] != 0, -torch.inf)
        v, i = torch.sort(s, dim=1, descending=True, stable=True)
        v, i = v[:, :kk], i[:, :kk]
        vals[lo : lo + rows, :kk] = v
        idx[lo : lo + rows, :kk] = torch.where(v == -torch.inf, INT32_MAX, i).to(torch.int32)
    return vals, idx
