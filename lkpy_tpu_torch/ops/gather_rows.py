"""
Row gather: ``table[idx]`` for a float32 table and integer row numbers.

Port of ``benchmarks/probe_gather.py::make_pallas`` (the Pallas kernels
``_dma_kernel``, one DMA a row, and ``_vmem_rowcopy_kernel``, one
dynamic-slice copy a row), which asked whether a hand-written gather beats
the compiler's at the ALS factor-row shapes.  On the port's path it gathers
the rows that are wanted as rows: the candidates' item rows of a per-query
scorer call (``models/als.py::ALSBase.__call__``).  Where the gathered rows
only feed the ALS normal equations, :mod:`lkpy_tpu_torch.ops.gather_gram`
gathers them inside its own kernel.  The hand-written CUDA kernel is
``csrc/gather_rows.cu``: a flat walk of the output in 16-byte units, 1 or
4 units a thread, each unit's floats loaded in 16-, 8- or 4-byte vectors
as the table allows.

:func:`gather_rows` launches the kernel for CUDA tensors and runs
:func:`gather_rows_plain` (``index_select``) for CPU tensors; the two are
equal to the bit.  ``gather_rows.launches`` counts kernel launches.  Every
index must lie in ``[0, n)``: on the card one outside is a device
assertion, as for ``index_select`` (the JAX gather clamps instead).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["DEPTHS", "gather_rows", "gather_rows_plain", "launch_depth", "vector_width"]

#: the units a thread the kernel is compiled for
DEPTHS = (1, 4)

_lib = None


def _library():
    global _lib
    if _lib is None:
        from lkpy_tpu_torch.ops._build import load

        lib = load("gather_rows")
        lib.lkt_gather_rows_f32.argtypes = [
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.lkt_gather_rows_f32.restype = ctypes.c_int
        lib.lkt_gather_rows_depth.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.lkt_gather_rows_depth.restype = ctypes.c_int
        lib.lkt_gather_rows_width.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
        lib.lkt_gather_rows_width.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dtype != torch.float32 or table.ndim != 2:
        raise TypeError(f"gather_rows takes a 2-D float32 table (got {table.dtype}, {table.ndim}-D)")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_rows takes int32 or int64 row numbers (got {idx.dtype})")
    if table.device != idx.device:
        raise ValueError(f"table and idx lie on different devices ({table.device}, {idx.device})")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """
    Rows ``idx`` of ``table``: ``table[idx]``, of shape ``idx.shape + (K,)``.

    Args:
        table: (n, K) float32, unit stride within a row (a view at an offset
            or with a longer row stride is taken as it is).
        idx: int32 or int64 row numbers of any shape, each in ``[0, n)``.

    CUDA tensors go to the kernel of ``csrc/gather_rows.cu``; CPU tensors to
    :func:`gather_rows_plain`.
    """
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    return _launch(table, idx)


gather_rows.launches = 0


def _launch(table: torch.Tensor, idx: torch.Tensor, depth: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors, ``depth`` units a thread (one of
    :data:`DEPTHS`), or as many as :func:`launch_depth` gives for 0."""
    _check(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {table.device}")
    if depth != 0 and depth not in DEPTHS:
        raise ValueError(f"gather_rows's kernel takes {DEPTHS} units a thread, not {depth}")
    n, K = table.shape
    if K > 1 and table.stride(1) != 1:
        raise ValueError("gather_rows's kernel takes a table with unit stride within a row")
    flat = idx.reshape(-1).contiguous()
    M = flat.numel()
    out = torch.empty((M, K), dtype=table.dtype, device=table.device)
    if M > 0 and K > 0:
        if n == 0:
            raise IndexError("gather_rows: index out of range of an empty table")
        lib = _library()
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream(table.device).cuda_stream
            err = lib.lkt_gather_rows_f32(
                table.data_ptr(), max(table.stride(0), K), n, flat.data_ptr(), flat.element_size(),
                out.data_ptr(), M, K, depth, stream,
            )  # fmt: skip
        if err != 0:
            raise RuntimeError(f"gather_rows kernel launch failed with CUDA error {err} (n={n}, K={K}, M={M}, depth={depth})")
        gather_rows.launches += 1
    return out.view(*idx.shape, K)


def vector_width(table: torch.Tensor, out: torch.Tensor) -> int:
    """The width in floats (4, 2 or 1) of the kernel's table loads for this
    table; its stores are 16-byte units of ``out``, which the wrapper
    allocates aligned (needs the card's toolkit)."""
    K = table.shape[1]
    return int(_library().lkt_gather_rows_width(table.data_ptr(), max(table.stride(0), K), out.data_ptr(), K))


def launch_depth(M: int, K: int) -> int:
    """The units a thread the kernel takes for ``M`` rows of ``K`` floats
    when not told (needs the card's toolkit)."""
    return int(_library().lkt_gather_rows_depth(M, K))


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table.index_select(0, idx.reshape(-1))`` in ``idx``'s shape: the
    kernel's function, on any device."""
    _check(table, idx)
    return table.index_select(0, idx.reshape(-1)).view(*idx.shape, table.shape[1])
