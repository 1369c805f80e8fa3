"""
Graph propagation shared by LightGCN and FlexMF's convolution layers.

Port of ``lkpy_tpu/ops/graph.py`` (reference: src/lenskit/graphs/lightgcn.py:42
wraps ``torch_geometric.nn.LightGCN``; FlexMF's convolution layers reuse the
same propagation, flexmf/_model.py:18): a symmetric-normalized bipartite
SpMM, blended over layers.

Each direction of :func:`propagate` is a product of a sparse CSR matrix with
the other side's table (``torch.sparse.mm``): the row-major edges give the
user side, the column-sorted copy of :func:`sorted_conv` the item side.
:class:`_CSRMM`, a ``torch.autograd.Function``, multiplies by the other
orientation in its backward, for the reason the JAX package gives its dense
product a custom VJP: no transposed copy of the edges is built per step, and
autograd keeps only the ``(n, k)`` layer outputs, never an ``(nnz, k)``
tensor.  :func:`spmm_plain` (``index_add_`` of ``vals[:, None] *
src[idx]``, in edge chunks from :data:`_SPMM_CHUNK_MIN` edges) is the
product written out, which the tests hold the Function against.

The dense bf16 adjacency (:func:`build_dense_adjacency`,
:func:`propagate_dense` with :class:`_AdjMM`/:class:`_AdjTMM`), whole or
in user-row blocks over a mesh's ``model`` slots, is ported as the JAX
package has it; :func:`dense_adjacency_eligible` is False on every device,
as the JAX package resolves it off a TPU, so no trainer takes it.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.logging.tracing import count, span
from lkpy_tpu_torch.parallel.ops import Sharded, shard_rows

__all__ = [
    "build_dense_adjacency",
    "dense_adjacency_eligible",
    "propagate",
    "propagate_dense",
    "sorted_conv",
    "spmm_plain",
]

#: edge count from which the plain SpMM accumulates in edge chunks of
#: :data:`_SPMM_CHUNK` (the one-shot form builds an (nnz, k) tensor)
_SPMM_CHUNK_MIN = 40_000_000
_SPMM_CHUNK = 524_288


def _spmm_chunked(vals, src_idx, dst_idx, src, n_dst):
    """dst[d] += Σ v·src[s] over edges, in chunks of :data:`_SPMM_CHUNK` edges."""
    out = torch.zeros((n_dst, src.shape[1]), dtype=src.dtype, device=src.device)
    for lo in range(0, vals.shape[0], _SPMM_CHUNK):
        hi = lo + _SPMM_CHUNK
        out.index_add_(0, dst_idx[lo:hi], vals[lo:hi, None] * src[src_idx[lo:hi]])
    return out


def spmm_plain(vals, src_idx, dst_idx, src, n_dst):
    """dst[d] = Σ v·src[s] over the edges (v, s, d), any edge order: one
    ``index_add_``, or edge chunks from :data:`_SPMM_CHUNK_MIN` edges."""
    if vals.shape[0] >= _SPMM_CHUNK_MIN:
        return _spmm_chunked(vals, src_idx, dst_idx, src, n_dst)
    out = torch.zeros((n_dst, src.shape[1]), dtype=src.dtype, device=src.device)
    return out.index_add_(0, dst_idx, vals[:, None] * src[src_idx])


def _csr(dst_sorted, src_idx, vals, n_dst: int, n_src: int) -> torch.Tensor:
    """The (n_dst, n_src) CSR matrix of edges sorted by destination."""
    crow = torch.searchsorted(dst_sorted, torch.arange(n_dst + 1, dtype=dst_sorted.dtype, device=dst_sorted.device))
    with warnings.catch_warnings():
        # torch's notes that sparse CSR support is in beta and that the
        # invariant checks are off: the structure is built right here
        warnings.filterwarnings("ignore", message="Sparse", category=UserWarning)
        return torch.sparse_csr_tensor(
            crow.to(torch.int32), src_idx.to(torch.int32), vals, (n_dst, n_src), check_invariants=False
        )


def _csr_pair(conv) -> tuple[torch.Tensor, torch.Tensor]:
    """The adjacency A (users × items) and Aᵀ as CSR matrices.  The 8-tuple
    carries both orders; the 5-tuple, which promises none, is sorted here."""
    if len(conv) == 8:
        rows, cols, vals, n_users, n_items, rows_c, cols_c, vals_c = conv
    else:
        rows, cols, vals, n_users, n_items = conv
        by_row = torch.argsort(rows, stable=True)
        by_col = torch.argsort(cols, stable=True)
        rows, cols, vals, rows_c, cols_c, vals_c = rows[by_row], cols[by_row], vals[by_row], rows[by_col], cols[by_col], vals[by_col]
    return _csr(rows, cols, vals, n_users, n_items), _csr(cols_c, rows_c, vals_c, n_items, n_users)


def _count_product(edges: int) -> None:
    count("graph.spmm_products", 1)
    count("graph.spmm_edges", edges)


class _CSRMM(torch.autograd.Function):
    """``a @ x`` for a CSR matrix ``a`` whose transpose ``a_t`` is given too:
    the backward is ``a_t @ g``, a product in the orientation already held.
    Each product, forward and backward, adds one to the counter
    ``graph.spmm_products`` and its matrix's stored entries (a host integer)
    to ``graph.spmm_edges``."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        ctx.a_t = a_t
        _count_product(a._nnz())
        return torch.sparse.mm(a, x)

    @staticmethod
    def backward(ctx, g):
        _count_product(ctx.a_t._nnz())
        return torch.sparse.mm(ctx.a_t, g.contiguous()), None, None


def _blend(blend) -> list[float]:
    return [float(b) for b in np.asarray(blend, dtype=np.float32)]


def propagate(u, i, conv, blend):
    """Symmetric-normalized LightGCN propagation; the blended layer mean.

    ``conv`` is the 5-tuple ``(rows, cols, vals, n_users, n_items)`` of
    edge tensors in any order, or the 8-tuple of :func:`sorted_conv`, which
    adds a column-sorted copy ``(…, rows_c, cols_c, vals_c)`` and promises
    row-major base edges (trainers build it).  ``blend`` holds the
    ``layers + 1`` weights.  Differentiable in ``u`` and ``i``.  The forward
    is the span ``lkt.graph.propagate``; its products count in :class:`_CSRMM`."""
    with span("lkt.graph.propagate"):
        a, a_t = _csr_pair(conv)
        w = _blend(blend)
        u_acc = u * w[0]
        i_acc = i * w[0]
        for l in range(1, len(w)):
            u, i = _CSRMM.apply(i, a, a_t), _CSRMM.apply(u, a_t, a)
            u_acc = u_acc + u * w[l]
            i_acc = i_acc + i * w[l]
        return u_acc, i_acc


def sorted_conv(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, nu: int, ni: int, device: str | torch.device | None = None):
    """The 8-tuple edge form on ``device`` (the card unless ``"cpu"``):
    row-major base edges and a column-sorted copy."""
    dev = resolve_device(device)
    order_c = np.argsort(cols, kind="stable")

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return (put(rows), put(cols), put(vals), nu, ni, put(rows[order_c]), put(cols[order_c]), put(vals[order_c]))


# ---------------------------------------------------------------------------
# the dense bf16 adjacency
def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands with float32 sums: on the card the bf16
    product with a float32 output; on the CPU in float32, where the
    products of bf16 values are exact."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _AdjMM(torch.autograd.Function):
    """``adj @ x`` with the backward ``adjᵀ @ g`` taken on a transposed view
    of the resident adjacency, never a transposed copy."""

    @staticmethod
    def forward(ctx, adj, x):
        ctx.adj = adj
        return _mm_f32(adj, x.to(adj.dtype))

    @staticmethod
    def backward(ctx, g):
        return None, _mm_f32(ctx.adj.t(), g.to(ctx.adj.dtype))


class _AdjTMM(torch.autograd.Function):
    """``adjᵀ @ u`` (see :class:`_AdjMM`); the backward is ``adj @ g``."""

    @staticmethod
    def forward(ctx, adj, u):
        ctx.adj = adj
        return _mm_f32(adj.t(), u.to(adj.dtype))

    @staticmethod
    def backward(ctx, g):
        return None, _mm_f32(ctx.adj, g.to(ctx.adj.dtype))


def propagate_dense(u, i, adj, blend):
    """LightGCN propagation with a dense bf16 adjacency whose dims are at
    least the table sizes: each direction one product with float32 sums.
    The tables pad up to the adjacency's dims and the results slice back.

    ``adj`` may be the user-row blocks of :func:`build_dense_adjacency`
    over a mesh's ``model`` slots: ``adj_s @ i`` is then taken on each
    slot, and ``adjᵀ @ u`` is the sum of each slot's ``adj_sᵀ @ u_s``, taken
    on the first slot, where the results gather."""
    nu, ni = u.shape[0], i.shape[0]
    blocks = adj.parts if isinstance(adj, Sharded) else (adj,)
    nu_al, ni_al = sum(b.shape[0] for b in blocks), blocks[0].shape[1]
    home = u.device
    u = torch.nn.functional.pad(u, (0, 0, 0, nu_al - nu))
    i = torch.nn.functional.pad(i, (0, 0, 0, ni_al - ni))
    w = _blend(blend)
    u_acc = u * w[0]
    i_acc = i * w[0]
    bounds = np.cumsum([0] + [b.shape[0] for b in blocks])
    for l in range(1, len(w)):
        u_new = torch.cat([_AdjMM.apply(b, i.to(b.device)).to(home) for b in blocks])
        i = sum(_AdjTMM.apply(b, u[lo:hi].to(b.device)).to(home) for b, lo, hi in zip(blocks, bounds, bounds[1:]))
        u = u_new
        u_acc = u_acc + u * w[l]
        i_acc = i_acc + i * w[l]
    return u_acc[:nu], i_acc[:ni]


def dense_adjacency_eligible(nnz: int, n_users: int, n_items: int, mesh=None) -> bool:
    """Whether a graph propagates through the dense bf16 adjacency: never.
    The JAX package takes it only on a TPU backend (from 2 M edges, within
    8 GiB a device, times the ``model`` slots of ``mesh``), so off a TPU it
    propagates by sparse products, as the port does on every device."""
    return False


def build_dense_adjacency(rows, cols, vals, n_users: int, n_items: int, mesh=None):
    """The dense bf16 adjacency on the edges' device, its dims rounded up to
    the JAX package's tile (16 × 128).

    With ``mesh``, its user rows (aligned to 16 × ``model``, as the JAX
    package aligns them) split over the ``model`` slots: a
    :class:`~lkpy_tpu_torch.parallel.ops.Sharded` whose part on each slot
    is a ``(nu_al / model, ni_al)`` block."""
    nu_mult = 16 * (mesh.shape["model"] if mesh is not None else 1)
    nu_al = -(-n_users // nu_mult) * nu_mult
    ni_al = -(-n_items // 128) * 128
    adj = torch.zeros((nu_al, ni_al), dtype=torch.bfloat16, device=rows.device)
    adj[rows.long(), cols.long()] = vals.to(torch.bfloat16)
    if mesh is None:
        return adj
    return shard_rows(adj, mesh, "model")
