"""
The operations and bytes of the gradient family's graph propagation
(``ops/graph.py::propagate`` and ``_CSRMM``, cuSPARSE's CSR SpMM) and of the
rest of a LightGCN step, for the per-layer readers of the LightGCN cell.

* One sparse product of ``edges`` stored entries with an ``(n_src, k)``
  table into an ``(n_dst, k)`` one: a multiply-add an edge and a column,
  ``2·edges·k`` operations.  Bytes: each edge's column number and value read
  once (4 + 4), each source row read once and each destination row written
  once, ``(n_src + n_dst)·k·4``.  The row pointers are not counted, which
  only lowers the bound.  Both directions of a layer have the same
  ``n_src + n_dst``, the tables' rows ``n_rows``.
* The rest of a step, per element of both tables (``n_rows·k``): the blend
  of ``layers + 1`` outputs, a multiply and an add a layer, forward and
  backward (``4·(layers + 1)``), and Adam (12: both moments, the root, the
  division and the update); per example of the batch and column, the two
  scores, the three ego norms and their gradients (20).
"""

from __future__ import annotations

from portbench.roofline.counts import bound_s

__all__ = ["other_step_ops", "spmm_bound_s", "spmm_bytes", "spmm_kernel", "spmm_ops"]


def spmm_ops(edges: float, k: int) -> float:
    return 2.0 * edges * k


def spmm_bytes(edges: float, n_rows: int, k: int) -> float:
    return 8.0 * edges + 4.0 * n_rows * k


def spmm_bound_s(products: int, edges: float, n_rows: int, k: int) -> float:
    """The least time of ``products`` products of ``edges`` edges in all
    (each as large), each the larger of its operations' and bytes' time."""
    if products <= 0:
        return 0.0
    e = edges / products
    return products * bound_s(spmm_ops(e, k), spmm_bytes(e, n_rows, k))


def other_step_ops(batch: int, n_rows: int, k: int, layers: int) -> float:
    """A LightGCN step's operations outside its sparse products."""
    return float(n_rows) * k * (4 * (layers + 1) + 12) + 20.0 * batch * k


def spmm_kernel(name: str) -> bool:
    """Whether a device activity is one of cuSPARSE's, which run the
    products (``torch.sparse.mm`` of a CSR matrix and a dense table)."""
    low = name.lower()
    return "cusparse" in low or "csrmm" in low or "spmm" in low
