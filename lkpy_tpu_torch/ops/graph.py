"""
Graph propagation shared by LightGCN and FlexMF's convolution layers.

Port of ``lkpy_tpu/ops/graph.py`` (reference: src/lenskit/graphs/lightgcn.py:42
wraps ``torch_geometric.nn.LightGCN``; FlexMF's convolution layers reuse the
same propagation, flexmf/_model.py:18): a symmetric-normalized bipartite
SpMM, blended over layers.

Each direction of :func:`propagate` is a product of one orientation of the
adjacency with the other side's table: the row-major edges give the user
side, the column-sorted copy of :func:`sorted_conv` the item side
(:func:`_csr_pair`, built once per 8-tuple and kept).  On the card each
product is :func:`spmm`, the hand-written kernel of ``csrc/spmm.cu``, from a
plan built once per graph on the card (:class:`SpmmPlan`): the user side
gathers item rows through the read-only path, and the item side sums its
most-rated items from tiles of user rows staged in each block's shared
memory.  On the CPU it is ``torch.sparse.mm`` of the CSR.  :class:`_CSRMM`,
a ``torch.autograd.Function``, multiplies by the other orientation in its
backward, for the reason the JAX package gives
its dense product a custom VJP: no transposed copy of the edges is built per
step, and autograd keeps only the ``(n, k)`` layer outputs, never an
``(nnz, k)`` tensor.  :func:`spmm_plain` (``index_add_`` of ``vals[:, None]
* src[idx]``, in edge chunks from :data:`_SPMM_CHUNK_MIN` edges) is the
product written out, which the tests hold both against.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.logging.tracing import count, span

__all__ = [
    "propagate",
    "SpmmPlan",
    "sorted_conv",
    "spmm",
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


#: edges a work item of the kernel's plan holds at most in a long row's segment
#: (a run of short rows holds under twice as many)
_SEG = 1024
#: rows a work item holds at most: a warp sums its rows one after another
_GROUP_ROWS = 16
#: the widest column slice of one launch, by the kernel's load width in floats
_SLICE = {4: 128, 1: 32}
#: the bytes of source rows one tile of SI's wide part holds at most
_TILE_BYTES = 200 * 1024
#: edges a block of the launch from which a row is summed in SI's wide part
_WIDE_EDGES = 8
#: edges a work item of SI's wide part holds at most in a segment, smaller than
#: :data:`_SEG` so that a tile's items end together
_TILE_SEG = 256


def tile_count(n_src: int, k: int, blocks: int) -> int:
    """The first count of tiles of source rows in SI's wide part: enough
    for the table's rows at :data:`_TILE_BYTES` a tile, at the width of one
    launch, rounded up to a multiple of the ``blocks`` of the launch."""
    return blocks * max(1, -(-n_src * 4 * _width(k) // (blocks * _TILE_BYTES)))


def _width(k: int) -> int:
    """The columns of one launch at table width ``k``."""
    return min(k, _SLICE[4 if k % 4 == 0 else 1])


def _rowptr(dst_sorted: torch.Tensor, n: int) -> torch.Tensor:
    """The (n + 1) int64 row pointers of edges sorted by destination."""
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=dst_sorted.device)
    torch.cumsum(torch.bincount(dst_sorted, minlength=n)[:n], 0, out=ptr[1:])
    return ptr


def _dst(rowptr: torch.Tensor) -> torch.Tensor:
    """Each edge's row, int32 (the tables' rows are numbered in int32)."""
    n = rowptr.shape[0] - 1
    rows = torch.arange(n, dtype=torch.int32, device=rowptr.device)
    return torch.repeat_interleave(rows, rowptr.diff(), output_size=int(rowptr[-1]))


class SpmmPlan(NamedTuple):
    """One launch of the kernel of ``csrc/spmm.cu``: a part of one
    orientation of the adjacency, in the form the kernel reads.

    ``src`` and ``vals`` are the part's edges in row order, and
    ``hot_edges`` those whose source rows the kernel reads from shared
    memory (the counter ``graph.spmm_hot_edges``): all of a tiled part's,
    none of another's.  The rows are the destination rows, or, in a tiled
    part, the tile-major rows ``t·n + j`` of its ``n`` rows in each tile
    ``t`` of source rows.  The work items tile the edges: item
    ``i`` covers edges ``work_edge[i]`` to ``work_edge[i + 1]``; with
    ``work_slot[i] == -1`` they are the whole rows ``work_row[i]`` to
    ``work_row[i + 1]``, each written out (to scratch row ``row_slot[r]`` in
    a tiled part), else a segment of row ``work_row[i]``, summed into
    scratch row ``work_slot[i]``.  Output row ``red_rows[j]`` is then the
    sum of the scratch rows ``red_ptr[j]`` to ``red_ptr[j + 1]`` (of
    ``n_slots``): a long row's segments, or a row's tiles and their
    segments, in order.  ``blocks`` fixes the launch's grid (0: as many as
    fit), so that each block's share of the edges is a run of tiles.  Where
    ``tile_src`` is given, each block copies tile ``t``'s source rows
    ``tile_src[t]`` to ``tile_src[t + 1]`` (``staged`` rows at most) to
    shared memory, ``src`` counts from the tile's first row, and the tile's
    work items start at ``tile_item[t]``."""

    rowptr: torch.Tensor
    src: torch.Tensor
    vals: torch.Tensor
    hot_edges: int
    blocks: int
    work_edge: torch.Tensor
    work_row: torch.Tensor
    work_slot: torch.Tensor
    row_slot: torch.Tensor | None
    red_rows: torch.Tensor
    red_ptr: torch.Tensor
    n_slots: int
    tile_src: torch.Tensor | None = None
    tile_item: torch.Tensor | None = None
    staged: int = 0


def _part(rowptr, src, vals, n, *, hot_edges=0, blocks=0, tiles=1, out_rows=None, tile_src=None, seg=None) -> SpmmPlan:
    """A :class:`SpmmPlan` over the ``tiles · n`` rows of ``rowptr``: work
    items of runs of consecutive rows of one tile whose first edges lie in
    one window of ``seg`` edges (:data:`_SEG` unless given; and in one block
    of :data:`_GROUP_ROWS` rows), and rows of more than ``seg`` edges cut
    into segments of that many.  A tiled part's rows go to scratch rows and
    add up into ``out_rows``."""
    seg = seg or _SEG
    dev = rowptr.device
    nv = rowptr.shape[0] - 1
    start, deg = rowptr[:-1], rowptr.diff()
    long = deg > seg
    r = torch.arange(nv, device=dev)
    new = torch.ones(nv, dtype=torch.bool, device=dev)
    new[1:] = (
        long[1:] | long[:-1] | (start[1:] // seg != start[:-1] // seg)
        | (r[1:] // _GROUP_ROWS != r[:-1] // _GROUP_ROWS) | (r[1:] % max(n, 1) == 0)
    )  # fmt: skip
    heads = torch.nonzero(new).flatten()
    g_long = long[heads]
    pieces = torch.where(g_long, (deg[heads] + seg - 1) // seg, 1)
    n_work = int(pieces.sum())
    g = torch.repeat_interleave(torch.arange(heads.shape[0], device=dev), pieces, output_size=n_work)
    j = torch.arange(n_work, device=dev) - (torch.cumsum(pieces, 0) - pieces)[g]
    rows = heads[g]
    is_seg = g_long[g]
    work_edge = torch.cat([start[rows] + j * seg, rowptr[-1:]])
    work_row = torch.cat([rows, torch.full((1,), nv, dtype=torch.int64, device=dev)])
    if tiles == 1:
        work_slot = torch.where(is_seg, torch.cumsum(is_seg, 0) - 1, -1)
        row_slot, red_rows = None, heads[g_long]
        per_out = pieces[g_long]
    else:
        # every row's tiles and their segments, in order, over scratch rows
        by_row = torch.where(long, (deg + seg - 1) // seg, 1).view(tiles, n).T
        base = (torch.cumsum(by_row.reshape(-1), 0) - by_row.reshape(-1)).view(n, tiles)
        row_slot = base.T.reshape(-1)
        work_slot = torch.where(is_seg, row_slot[rows] + j, -1)
        row_slot, red_rows = row_slot.to(torch.int32), out_rows
        per_out = by_row.sum(1)
    red_ptr = torch.zeros(red_rows.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(per_out, 0, out=red_ptr[1:])
    tile_item, staged = None, 0
    if tile_src is not None:
        tile_item = torch.searchsorted(rows, torch.arange(tiles + 1, device=dev) * n)
        staged = int(tile_src.diff().max())
    return SpmmPlan(
        rowptr, src.to(torch.int32), vals, hot_edges, blocks, work_edge, work_row,
        work_slot.to(torch.int32), row_slot, red_rows, red_ptr, int(red_ptr[-1]), tile_src, tile_item, staged,
    )  # fmt: skip


def _wide_and_narrow(rowptr: torch.Tensor, src: torch.Tensor, vals: torch.Tensor, n_src: int, k: int, blocks: int) -> list[SpmmPlan]:
    """SI's two parts.  The rows of at least :data:`_WIDE_EDGES` edges a
    block (the most-rated items) are summed tile by tile: tiles of
    consecutive source rows with equal edges, a run of them a block, each
    tile's rows (:data:`_TILE_BYTES` at most) copied to the block's shared
    memory; the tiles' sums are then added up.  The other rows are summed
    whole, the wide ones left zero for the reduction to write.  One part
    where no row is wide, or where no count of tiles up to eight times the
    first keeps every tile's rows within :data:`_TILE_BYTES`.  Edge-long
    temporaries are int32 and dropped as soon as they are used: at 20 M
    edges each is 80 MB of the card's memory."""
    n = rowptr.shape[0] - 1
    tiles = tile_count(n_src, k, blocks)
    wide = rowptr.diff() >= _WIDE_EDGES * blocks
    n_wide = int(wide.sum())
    if n_wide == 0:
        return [_part(rowptr, src, vals, n)]
    dst = _dst(rowptr)
    on = wide[dst]
    narrow = _part(_rowptr(dst[~on], n), src[~on], vals[~on], n)
    j = (torch.cumsum(wide, 0, dtype=torch.int32) - 1)[dst[on]]
    del dst
    s, v = src[on].to(torch.int32), vals[on]
    del on
    per_src = torch.bincount(s, minlength=n_src)
    before = torch.cumsum(per_src, 0) - per_src
    cap = _TILE_BYTES // (4 * _width(k))
    for tiles in range(tiles, 8 * tiles + 1, blocks):
        # each source row's tile: equal edges a tile; more tiles while one holds too many rows
        of_src = before * tiles // s.shape[0]
        tile_src = torch.searchsorted(of_src, torch.arange(tiles + 1, device=s.device))
        if int(tile_src.diff().max()) <= cap:
            break
    else:
        # a run of source rows without wide edges wider than a tile: no tiles
        return [_part(rowptr, src, vals, n)]
    key = of_src.to(torch.int32 if tiles * n_wide < 2**31 else torch.int64)[s] * n_wide + j
    del j
    perm = torch.argsort(key, stable=True)
    key = key[perm]
    # columns count from the tile's first source row
    s = s[perm] - tile_src.to(torch.int32)[key // n_wide]
    v = v[perm]
    del perm
    wide_part = _part(
        _rowptr(key, tiles * n_wide), s, v, n_wide, blocks=blocks, tiles=tiles,
        out_rows=torch.nonzero(wide).flatten(), tile_src=tile_src, hot_edges=s.shape[0], seg=_TILE_SEG,
    )  # fmt: skip
    return [narrow, wide_part]


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


class _Adjacency:
    """One orientation of the adjacency, an ``(n_dst, n_src)`` matrix: the
    row pointers of its destination rows and, in CSR order, each edge's
    source row and value.  ``tiled`` marks the orientation whose source is
    the user table (SI), whose wide rows the kernel sums from tiles of source
    rows in shared memory.  The CSR tensor of the CPU's product and the
    kernel's plans (one a grid and launch width) are built at first use and
    kept."""

    def __init__(self, rowptr: torch.Tensor, src: torch.Tensor, vals: torch.Tensor, n_src: int, tiled: bool):
        self.rowptr, self.src, self.vals = rowptr, src, vals
        self.shape = (rowptr.shape[0] - 1, n_src)
        self.tiled = tiled
        self._csr = None
        self._plans: dict[tuple[int, int], list[SpmmPlan]] = {}
        self._launches: dict[int, tuple[list[tuple], int]] = {}
        self._scratch: list[torch.Tensor] = []

    def _nnz(self) -> int:
        return self.src.shape[0]

    def csr(self) -> torch.Tensor:
        """The matrix as a sparse CSR tensor (the CPU's product)."""
        if self._csr is None:
            with warnings.catch_warnings():
                # torch's notes that sparse CSR support is in beta and that the
                # invariant checks are off: the structure is built right here
                warnings.filterwarnings("ignore", message="Sparse", category=UserWarning)
                self._csr = torch.sparse_csr_tensor(
                    self.rowptr.to(torch.int32), self.src.to(torch.int32), self.vals, self.shape, check_invariants=False
                )
        return self._csr

    def launches(self, k: int) -> tuple[list[tuple], int]:
        """The kernel's calls at table width ``k`` (:meth:`plan`'s parts for
        each column slice), each as its column, width, the arguments before
        the table's as integers, the most rows a tile stages and the grid; and
        the edges a product serves from shared memory.  Built once a width,
        with each call's scratch rows, which the products of this operator
        share in their stream's order."""
        got = self._launches.get(k)
        if got is None:
            parts = self.plan(k)
            vec = 4 if k % 4 == 0 else 1
            calls = []
            for c0 in range(0, k, _SLICE[vec]):
                width = min(_SLICE[vec], k - c0)
                for p in parts:
                    partial = torch.empty((p.n_slots, width), dtype=torch.float32, device=self.rowptr.device)
                    self._scratch.append(partial)
                    head = (
                        _ptr(p.rowptr), _ptr(p.src), _ptr(p.vals), p.src.shape[0],
                        _ptr(p.work_edge), _ptr(p.work_row), _ptr(p.work_slot), p.work_slot.shape[0],
                        _ptr(p.row_slot), _ptr(p.tile_src), _ptr(p.tile_item), 0 if p.tile_src is None else p.tile_src.shape[0] - 1,
                        _ptr(p.red_rows), _ptr(p.red_ptr), p.red_rows.shape[0], _ptr(partial),
                    )  # fmt: skip
                    calls.append((c0, width, head, p.staged, p.blocks))
            got = self._launches[k] = (calls, sum(p.hot_edges for p in parts))
        return got

    def plan(self, k: int, blocks: int | None = None) -> list[SpmmPlan]:
        """The kernel's launches at table width ``k``, in order.  The item
        table's side (SU) is one launch of every row, the same at every
        ``k``; the other (SI), on the card, a launch of the narrow rows and a
        tiled one of the wide rows, for a grid of ``blocks`` (the card's SMs
        unless given; off the card one launch unless given)."""
        if blocks is None:
            dev = self.rowptr.device
            blocks = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 0
        tiled = bool(self.tiled and blocks)
        key = (blocks, _width(k)) if tiled else (0, 0)
        plan = self._plans.get(key)
        if plan is None:
            if tiled:
                plan = _wide_and_narrow(self.rowptr, self.src, self.vals, self.shape[1], k, blocks)
            else:
                plan = [_part(self.rowptr, self.src, self.vals, self.shape[0])]
            self._plans[key] = plan
        return plan


#: the orientations of each 8-tuple, by its row tensor (held weakly)
_pairs = WeakIdKeyDictionary()


def _csr_pair(conv) -> tuple[_Adjacency, _Adjacency]:
    """The adjacency A (users × items) and Aᵀ as :class:`_Adjacency`
    operators.  The 8-tuple carries both orders, and its pair is built once
    and kept for as long as its tensors live; the 5-tuple, which promises no
    order, is sorted here on every call, into the order of a CSR's edges."""
    if len(conv) == 8:
        rows, cols, vals, n_users, n_items, rows_c, cols_c, vals_c = conv
        pair = _pairs.get(rows)
        if pair is not None:
            a, a_t = pair
            if a.src is cols and a.vals is vals and a_t.src is rows_c and a_t.vals is vals_c and a.shape == (n_users, n_items):
                return pair
    else:
        rows, cols, vals, n_users, n_items = conv
        # (row, column) and (column, row) order, as sorted_conv gives a CSR's edges
        by_row = torch.argsort(cols, stable=True)
        by_row = by_row[torch.argsort(rows[by_row], stable=True)]
        by_col = torch.argsort(rows, stable=True)
        by_col = by_col[torch.argsort(cols[by_col], stable=True)]
        rows, cols, vals, rows_c, cols_c, vals_c = rows[by_row], cols[by_row], vals[by_row], rows[by_col], cols[by_col], vals[by_col]
    pair = (
        _Adjacency(_rowptr(rows, n_users), cols, vals, n_items, False),
        _Adjacency(_rowptr(cols_c, n_items), rows_c, vals_c, n_users, True),
    )
    if len(conv) == 8:
        _pairs[conv[0]] = pair
    return pair


_lib = None


def _library():
    global _lib
    if _lib is None:
        from lkpy_tpu_torch.ops._build import load

        lib = load("spmm")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.lkt_spmm_f32.argtypes = [p, p, p, i64, p, p, p, i64, p, p, p, i32, p, p, i64, p, p, i64, i32, p, i64, i32, i32, i32, p]
        lib.lkt_spmm_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def spmm(a: _Adjacency, x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``a @ x`` for a float32 table ``x`` on the card, by the kernel of
    ``csrc/spmm.cu``, and the edges whose source rows it read from shared
    memory.  Raises for a tensor elsewhere, another type or shape, or a plan
    on another device.  ``spmm.launches`` counts the kernel's launches: one
    a part of the plan (:meth:`_Adjacency.plan`) and a column slice of at
    most 128 columns (32 where ``k % 4 != 0``)."""
    if x.device.type != "cuda":
        raise ValueError(f"spmm's kernel runs on cuda tensors, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"spmm's kernel takes a float32 table (got {x.dtype})")
    if x.ndim != 2 or x.shape[0] != a.shape[1]:
        raise ValueError(f"spmm: a table of {a.shape[1]} rows for a {a.shape} matrix (got {tuple(x.shape)})")
    if a.rowptr.device != x.device:
        raise ValueError(f"spmm: the matrix lies on {a.rowptr.device}, the table on {x.device}")
    n, k = a.shape[0], x.shape[1]
    out = torch.empty((n, k), dtype=x.dtype, device=x.device)
    if n == 0 or k == 0:
        return out, 0
    if not x.is_contiguous():
        x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    calls, hot_edges = a.launches(k)
    vec = 4 if k % 4 == 0 else 1
    lib = _library()
    xp, op = x.data_ptr(), out.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for c0, width, head, staged, blocks in calls:
            err = lib.lkt_spmm_f32(*head, xp + 4 * c0, k, staged, op + 4 * c0, k, width, vec, blocks, stream)
            if err != 0:
                raise RuntimeError(f"spmm kernel launch failed with CUDA error {err} (shape {a.shape}, k={k}, staged={staged})")
            spmm.launches += 1
    return out, hot_edges


spmm.launches = 0


def _product(a: _Adjacency, x: torch.Tensor) -> torch.Tensor:
    """``a @ x``: the kernel for a CUDA table, ``torch.sparse.mm`` of the
    CSR for a CPU one.  Counts the product, its edges and the edges served
    from shared memory (0 on the CPU)."""
    if x.device.type == "cpu":
        out, hot = torch.sparse.mm(a.csr(), x), 0
    else:
        out, hot = spmm(a, x)
    count("graph.spmm_products", 1)
    count("graph.spmm_edges", a._nnz())
    count("graph.spmm_hot_edges", hot)
    return out


class _CSRMM(torch.autograd.Function):
    """``a @ x`` for an orientation ``a`` of the adjacency whose transpose
    ``a_t`` is given too: the backward is ``a_t @ g``, a product in the
    orientation already held.  Each product, forward and backward, adds one
    to the counter ``graph.spmm_products``, its matrix's stored entries (a
    host integer) to ``graph.spmm_edges`` and the edges whose rows came
    from shared memory to ``graph.spmm_hot_edges``."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        ctx.a_t = a_t
        return _product(a, x)

    @staticmethod
    def backward(ctx, g):
        return _product(ctx.a_t, g.contiguous()), None, None


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

