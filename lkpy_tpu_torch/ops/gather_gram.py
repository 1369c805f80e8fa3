"""
Gather and ALS normal equations in one kernel.

For a bucket of B rows of P slots (column numbers ``cols``, values, a mask)
against the opposite factor table ``right`` (n, k), with
``g_p = right[cols[b, p]]`` and ``m_p = mask[b, p]``:

- implicit (``otor`` given): ``A = otor + Σ_p c_p m_p g_p g_pᵀ`` and
  ``y = Σ_p (c_p + 1) m_p g_p`` (Hu et al.; ``otor = YᵀY + λI``);
- explicit (``reg`` given): ``A = Σ_p m_p g_p g_pᵀ + reg · n_b · I`` with
  ``n_b = Σ_p m_p``, and ``y = Σ_p m_p v_p g_p``.

This is what ``lkpy_tpu/ops/als.py`` computes with an XLA gather and
einsums (``_gram_scan_implicit``, ``_gram_scan_explicit``,
``solve_*_bucket``), and what the port first computed with the row-gather
kernel (:mod:`lkpy_tpu_torch.ops.gather_rows`), a weighted copy and two
``torch.bmm``.  The hand-written CUDA kernel of ``csrc/gather_gram.cu``
reads each factor row by index straight into shared memory and sums A's
lower triangle and y in registers, so the gathered rows never reach device
memory.  The rows of a bucket too small to fill the card, or wider than
2,048 slots, are split into segments whose partial sums the last block of
a row adds in a fixed order (:func:`launch_plan`).

:func:`gather_gram` launches the kernel for CUDA tensors and runs
:func:`gather_gram_plain` (that first route: ``index_select``, the weighted
copy, two ``torch.bmm``) for CPU tensors.  ``gather_gram.launches`` counts
kernel launches.  On the card only A's lower triangle is written (the solves
read nothing else); its upper triangle is undefined.  The plain version
fills all of A.
"""

from __future__ import annotations

import ctypes

import torch

from lkpy_tpu_torch.ops.gather_rows import gather_rows_plain

__all__ = ["MAX_K", "copy_width", "gather_gram", "gather_gram_plain", "launch_plan"]

#: the widest factor row the kernel takes (the solves' limit)
MAX_K = 256

_lib = None


def _library():
    global _lib
    if _lib is None:
        from lkpy_tpu_torch.ops._build import load

        lib = load("gather_gram")
        lib.lkt_gather_gram_f32.argtypes = [
            ctypes.c_void_p,  # right
            ctypes.c_longlong,  # ld
            ctypes.c_longlong,  # n
            ctypes.c_void_p,  # cols
            ctypes.c_int,  # idx_bytes
            ctypes.c_void_p,  # vals
            ctypes.c_void_p,  # mask
            ctypes.c_longlong,  # B
            ctypes.c_int,  # P
            ctypes.c_void_p,  # otor (null: explicit)
            ctypes.c_float,  # reg
            ctypes.c_int,  # k
            ctypes.c_void_p,  # A
            ctypes.c_void_p,  # y
            ctypes.c_int,  # S
            ctypes.c_int,  # L
            ctypes.c_void_p,  # ws
            ctypes.c_void_p,  # sync
            ctypes.c_void_p,  # stream
        ]
        lib.lkt_gather_gram_f32.restype = ctypes.c_int
        lib.lkt_gather_gram_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        lib.lkt_gather_gram_plan.restype = None
        lib.lkt_gather_gram_width.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
        lib.lkt_gather_gram_width.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(cols, values, mask, right, otor, reg) -> tuple[int, int, int]:
    if right.dtype != torch.float32 or right.ndim != 2:
        raise TypeError(f"gather_gram takes a 2-D float32 factor table (got {right.dtype}, {right.ndim}-D)")
    k = right.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"gather_gram takes 1 <= k <= {MAX_K}, got k={k}")
    if cols.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_gram takes int32 or int64 column numbers (got {cols.dtype})")
    if cols.ndim != 2 or values.shape != cols.shape or mask.shape != cols.shape:
        raise ValueError(
            f"gather_gram needs cols, values and mask of one (B, P) shape, got {tuple(cols.shape)}, "
            f"{tuple(values.shape)}, {tuple(mask.shape)}"
        )
    if values.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"gather_gram takes float32 values and a bool mask (got {values.dtype}, {mask.dtype})")
    if (otor is None) == (reg is None):
        raise ValueError("gather_gram takes otor (implicit) or reg (explicit), exactly one")
    if otor is not None and (otor.shape != (k, k) or otor.dtype != torch.float32):
        raise ValueError(f"gather_gram needs otor ({k}, {k}) float32, got {tuple(otor.shape)} {otor.dtype}")
    devices = {t.device for t in (cols, values, mask, right) + (() if otor is None else (otor,))}
    if len(devices) != 1:
        raise ValueError(f"gather_gram's tensors lie on different devices ({sorted(map(str, devices))})")
    B, P = cols.shape
    return B, P, k


def gather_gram(
    cols: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    right: torch.Tensor,
    *,
    otor: torch.Tensor | None = None,
    reg: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """
    The ALS normal equations of a bucket of rows: A (B, k, k) and y (B, k).

    Args:
        cols: (B, P) int32 or int64 column numbers; those of slots whose
            mask is true lie in ``[0, n)``, the others are not read on the
            card.
        values: (B, P) f32 confidences (implicit) or ratings (explicit).
        mask: (B, P) bool, which slots are real (any pattern; the training
            buckets and serving histories give prefixes).
        right: (n, k) f32 factor table, 1 ≤ k ≤ 256, unit stride within a
            row (a view at an offset or with a longer row stride is taken
            as it is).
        otor: (k, k) f32 ``YᵀY + λI``: implicit mode.
        reg: regularization: explicit mode.

    CUDA tensors go to the kernel of ``csrc/gather_gram.cu``, which writes
    only A's lower triangle (the upper is undefined); CPU tensors go to
    :func:`gather_gram_plain`.
    """
    _check(cols, values, mask, right, otor, reg)
    if right.device.type == "cpu":
        return gather_gram_plain(cols, values, mask, right, otor=otor, reg=reg)
    return _launch(cols, values, mask, right, otor, reg)


gather_gram.launches = 0


def _launch(cols, values, mask, right, otor, reg) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors."""
    B, P, k = _check(cols, values, mask, right, otor, reg)
    if right.device.type != "cuda":
        raise ValueError(f"gather_gram runs on cuda or cpu, not {right.device}")
    n = right.shape[0]
    if k > 1 and right.stride(1) != 1:
        raise ValueError("gather_gram's kernel takes a factor table with unit stride within a row")
    A = torch.empty((B, k, k), dtype=torch.float32, device=right.device)
    y = torch.empty((B, k), dtype=torch.float32, device=right.device)
    if B == 0:
        return A, y
    if n == 0 and bool(mask.any()):
        raise IndexError("gather_gram: a real slot refers to a row of an empty table")
    cols, values, mask = cols.contiguous(), values.contiguous(), mask.contiguous()
    otor_c = None if otor is None else otor.contiguous()
    lib = _library()
    with torch.cuda.device(right.device):
        S, L, ws_floats, sync_ints = launch_plan(B, P, k)
        # rows split into S > 1 segments hand partial sums over through a workspace and counters
        ws = torch.empty(ws_floats, dtype=torch.float32, device=right.device) if S > 1 else None
        sync = torch.zeros(sync_ints, dtype=torch.int32, device=right.device) if S > 1 else None
        stream = torch.cuda.current_stream(right.device).cuda_stream
        err = lib.lkt_gather_gram_f32(
            right.data_ptr(), max(right.stride(0), k), max(n, 1), cols.data_ptr(), cols.element_size(),
            values.data_ptr(), mask.data_ptr(), B, P, None if otor_c is None else otor_c.data_ptr(),
            0.0 if reg is None else float(reg), k, A.data_ptr(), y.data_ptr(), S, L,
            None if ws is None else ws.data_ptr(), None if sync is None else sync.data_ptr(), stream,
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"gather_gram kernel launch failed with CUDA error {err} (B={B}, P={P}, k={k}, n={n})")
    gather_gram.launches += 1
    return A, y


def launch_plan(B: int, P: int, k: int) -> tuple[int, int, int, int]:
    """How the kernel launches a (B, P) bucket at width k (needs the card's
    toolkit): the segments S each row is split into, the slots L of a
    segment, and the workspace floats and int32 counters a split launch
    takes (0 and 0 for S = 1).  Rows are split where the bucket's blocks
    would not fill the card twice or a row is wider than 2,048 slots."""
    out = (ctypes.c_longlong * 4)()
    _library().lkt_gather_gram_plan(B, P, k, out)
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])


def copy_width(right: torch.Tensor) -> int:
    """The copy width in floats (4, 2 or 1) the kernel takes for this table
    (needs the card's toolkit)."""
    k = right.shape[1]
    return int(_library().lkt_gather_gram_width(right.data_ptr(), max(right.stride(0), k), k))


def gather_gram_plain(
    cols: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    right: torch.Tensor,
    *,
    otor: torch.Tensor | None = None,
    reg: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch on any device: the gathered rows
    ``G = right[cols]`` (``index_select``), the weighted copy and two
    batched products in float32, filling all of A."""
    _check(cols, values, mask, right, otor, reg)
    G = gather_rows_plain(right, cols)
    m = mask.to(right.dtype)
    if otor is not None:
        A = otor + torch.bmm((G * (values * m)[:, :, None]).transpose(1, 2), G)
        y = torch.bmm(G.transpose(1, 2), ((values + 1.0) * m)[:, :, None])[:, :, 0]
        return A, y
    Gm = G * m[:, :, None]
    k = right.shape[1]
    A = torch.bmm(Gm.transpose(1, 2), G)
    A = A + (reg * m.sum(dim=1))[:, None, None] * torch.eye(k, dtype=A.dtype, device=A.device)
    y = torch.bmm(Gm.transpose(1, 2), values[:, :, None])[:, :, 0]
    return A, y
