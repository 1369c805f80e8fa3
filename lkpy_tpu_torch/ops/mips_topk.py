"""
Fused maximum-inner-product top-k: the large-catalog retrieval kernel.

Port of ``lkpy_tpu/ops/pallas_topk.py`` (``mips_topk``), whose Pallas kernel
(``_topk_kernel``: score tile on the MXU, k rounds of max-extraction into a
running top-k in VMEM) becomes the hand-written CUDA kernel
``csrc/mips_topk.cu``: a tiled product with a per-query sorted top-k in
shared memory that a score enters only past the current k-th value.  The
grid is (blocks of queries, S ranges of items); with S > 1 the blocks write
their lists to scratch and a second hand-written kernel merges a query's S
lists by (value descending, index ascending).  Nothing here is Pallas, hence
the module's name.  The (B, N) score matrix never reaches device memory.

:func:`mips_topk` launches the kernel for CUDA tensors and runs
:func:`mips_topk_plain`, the same function in plain PyTorch, for CPU tensors.
``mips_topk.launches`` counts calls that launched the kernel (one a call,
whatever S is); ``mips_topk.last_splits`` is the S of the last one and
``mips_topk.last_product`` its product kernel: the f32 FMA product, or, for
large launches (:func:`choose_product`), the three-pass TF32 product on the
tensor cores, which keeps f32's accuracy.  The
kernel takes B, N and D as they come and masks its own ragged edges, so the
TPU kernel's ``qb`` and ``nt`` tiling arguments have no counterpart; S is
chosen from B, N and the card's SM count (:func:`choose_splits`).

The plain version leaves the order of the sum over D to ``torch.matmul``.
Only agreement to a tolerance (about 1e-5 relative) is promised, not to the
bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

__all__ = ["MAX_FUSED_K", "choose_product", "choose_splits", "mips_topk", "mips_topk_plain"]

#: the largest k the kernel's shared-memory lists hold (the TPU kernel's cap)
MAX_FUSED_K = 64

#: the index of a slot beyond the number of scoreable items
INT32_MAX = int(np.iinfo(np.int32).max)

# the plain version scores this many entries at a time: a (rows, N) f32 slab of 1 GiB
_PLAIN_SLAB_ENTRIES = 1 << 28

#: an item range is a multiple of this many items (the kernels' item tiles divide it)
RANGE_QUANTUM = 256
#: the shortest range a block is given
MIN_RANGE_ITEMS = 1024
#: what starting a range costs, in items of product work: a block's lists fill
#: by insertion over its first tiles (set from runs on an H100, PERF.md)
RANGE_START_ITEMS = 2048
#: no more waves of blocks than this are tried: the tail is small by then
MAX_WAVES = 4
#: the launcher takes at most this many ranges (the grid's second dimension)
MAX_SPLITS = 65535

#: the product kernels
PRODUCT_FMA, PRODUCT_TF32X3 = 0, 1
#: the deepest factors the tensor-core kernel keeps a block's queries for
TENSOR_CORE_MAX_D = 128
#: B·N from which the tensor-core product is taken, for k ≤ 32 and for longer
#: lists: on an H100 (PERF.md) it took 12–46 % less time on every measured
#: launch at least this large and up to 6× more on small ones, where its
#: blocks of 128 or 256 queries spend their time filling their lists
TENSOR_CORE_MIN_SCORES = 800_000_000
TENSOR_CORE_MIN_SCORES_LONG_LISTS = 1_600_000_000

_fns: dict[str, object] = {}
_sm_counts: dict[int, int] = {}


def _kernel(name: str = "lkt_mips_topk_f32"):
    fn = _fns.get(name)
    if fn is None:
        from lkpy_tpu_torch.ops._build import load

        fn = getattr(load("mips_topk"), name)
        fn.argtypes = {
            "lkt_mips_topk_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
            "lkt_mips_topk_merge_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
            "lkt_mips_topk_queries_per_block": [ctypes.c_int] * 4,
        }[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _sm_count(dev: torch.device) -> int:
    """The card's number of SMs, read once a device."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def range_items(N: int, splits: int) -> int:
    """The length of an item range when ``N`` items are cut into about
    ``splits`` ranges: a multiple of :data:`RANGE_QUANTUM`."""
    per = -(-max(N, 1) // max(splits, 1))
    return -(-per // RANGE_QUANTUM) * RANGE_QUANTUM


@functools.lru_cache(maxsize=256)
def choose_splits(B: int, N: int, sm_count: int, queries_per_block: int) -> int:
    """
    The number S of item ranges of a launch, a pure function of its
    arguments.  One block keeps an SM busy, so a grid of
    ``ceil(B / queries_per_block)`` × S blocks takes ``ceil(blocks /
    sm_count)`` rounds, each as long as a range plus
    :data:`RANGE_START_ITEMS`; S is the count with the least such time among
    those with ranges of at least :data:`MIN_RANGE_ITEMS` items and at most
    :data:`MAX_WAVES` rounds (the smallest S among equals).
    """
    q_blocks = -(-max(B, 1) // queries_per_block)
    most = max(1, min(N // MIN_RANGE_ITEMS, MAX_SPLITS, -(-MAX_WAVES * sm_count // q_blocks)))
    best, best_cost = 1, None
    for want in range(1, most + 1):
        per = range_items(N, want)
        splits = -(-max(N, 1) // per)  # ranges are whole tiles, so fewer of them may cover the catalog
        cost = -(-q_blocks * splits // sm_count) * (per + RANGE_START_ITEMS)
        if best_cost is None or cost < best_cost:
            best, best_cost = splits, cost
    return best


def choose_product(B: int, N: int, D: int, k: int) -> int:
    """The product kernel of a launch, from its shape alone: the three-pass
    TF32 product on the tensor cores where the launch scores at least
    :data:`TENSOR_CORE_MIN_SCORES` pairs (twice that for k > 32) at a depth
    the kernel takes, else the f32 FMA product.  A pure function."""
    least = TENSOR_CORE_MIN_SCORES if k <= 32 else TENSOR_CORE_MIN_SCORES_LONG_LISTS
    return PRODUCT_TF32X3 if D <= TENSOR_CORE_MAX_D and B * N >= least else PRODUCT_FMA


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
    if queries.device.type == "cpu":
        _check(queries, items, k, i_bias, exclude)
        return mips_topk_plain(queries, items, k, i_bias=i_bias, exclude=exclude)
    return _launch(queries, items, k, i_bias, exclude)


mips_topk.launches = 0
mips_topk.last_splits = 0
mips_topk.last_product = PRODUCT_FMA


def _launch(queries, items, k, i_bias=None, exclude=None, *, splits: int | None = None, product: int | None = None):
    """Launch the kernel on CUDA tensors.  ``splits`` forces the number of
    item ranges (else :func:`choose_splits`); ``product`` forces the product
    kernel (else :func:`choose_product`).  Both are for tests and
    measurements, not for callers."""
    B, N, D = _check(queries, items, k, i_bias, exclude)
    if product is None:
        product = choose_product(B, N, D, k)
    if product == PRODUCT_TF32X3 and D > TENSOR_CORE_MAX_D:
        raise ValueError(f"the tensor-core product takes D <= {TENSOR_CORE_MAX_D}, got {D}")
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"mips_topk runs on cuda or cpu, not {dev}")
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, idx
    fn = _kernel()
    if splits is None:
        splits = choose_splits(B, N, _sm_count(dev), _kernel("lkt_mips_topk_queries_per_block")(B, D, k, product))
    per = range_items(N, splits)
    S = -(-max(N, 1) // per)
    part_v = part_i = None
    if S > 1:
        part_v = torch.empty((B, S, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            queries.data_ptr(),
            items.data_ptr(),
            None if i_bias is None else i_bias.data_ptr(),
            None if exclude is None else exclude.data_ptr(),
            vals.data_ptr(),
            idx.data_ptr(),
            None if part_v is None else part_v.data_ptr(),
            None if part_i is None else part_i.data_ptr(),
            B,
            N,
            D,
            k,
            per,
            product,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"mips_topk kernel launch failed with CUDA error {err} (B={B}, N={N}, D={D}, k={k}, S={S})")
    mips_topk.launches += 1
    mips_topk.last_splits = S
    mips_topk.last_product = product
    return vals, idx


def _merge_lists(part_v: torch.Tensor, part_i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The merge kernel alone, on CUDA tensors: (B, S, k) sorted partial
    lists to (B, k).  Not counted in ``mips_topk.launches``."""
    B, S, k = part_v.shape
    if part_v.device.type != "cuda" or part_i.shape != part_v.shape or not (part_v.is_contiguous() and part_i.is_contiguous()):
        raise ValueError("the merge kernel takes contiguous CUDA tensors of one shape")
    if part_v.dtype != torch.float32 or part_i.dtype != torch.int32:
        raise TypeError("the merge kernel takes float32 values and int32 indices")
    vals = torch.empty((B, k), dtype=torch.float32, device=part_v.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=part_v.device)
    with torch.cuda.device(part_v.device):
        stream = torch.cuda.current_stream(part_v.device).cuda_stream
        err = _kernel("lkt_mips_topk_merge_f32")(
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(), B, S, k, stream
        )
    if err != 0:
        raise RuntimeError(f"mips_topk merge kernel launch failed with CUDA error {err} (B={B}, S={S}, k={k})")
    return vals, idx


def _partial_lists_plain(queries, items, k, splits: int, *, i_bias=None, exclude=None):
    """What the product kernel writes with S > 1, in plain PyTorch: the
    top-k of each item range, (B, S, k), indices counted over the catalog."""
    N = items.shape[0]
    per = range_items(N, splits)
    vs, ixs = [], []
    for lo in range(0, max(N, 1), per):
        v, i = mips_topk_plain(
            queries,
            items[lo : lo + per],
            k,
            i_bias=None if i_bias is None else i_bias[lo : lo + per],
            exclude=None if exclude is None else exclude[:, lo : lo + per].contiguous(),
        )
        vs.append(v)
        ixs.append(torch.where(i == INT32_MAX, i, i + lo))
    return torch.stack(vs, dim=1), torch.stack(ixs, dim=1)


def _merge_lists_plain(part_v: torch.Tensor, part_i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The merge kernel's function in plain PyTorch: the k first of a
    query's S·k partial entries by (value descending, index ascending).
    Empty slots (−inf, INT32_MAX) sort last."""
    B, S, k = part_v.shape
    v, i = part_v.reshape(B, S * k), part_i.reshape(B, S * k)
    by_index = torch.sort(i, dim=1, stable=True).indices
    v, i = v.gather(1, by_index), i.gather(1, by_index)
    by_value = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    return v.gather(1, by_value), i.gather(1, by_value)


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


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does: integer arithmetic on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _scores_tf32_plain(queries: torch.Tensor, items: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The tensor-core kernel's product in plain PyTorch: each operand split
    as big = tf32(x), small = tf32(x − big); three passes sum
    small·big + big·small + big·big (each product of two 11-bit values is
    exact in f32, the sum is taken in f32), one pass big·big alone."""
    qb, ib = _tf32_round(queries), _tf32_round(items)
    if passes == 1:
        return qb @ ib.T
    qs, is_ = _tf32_round(queries - qb), _tf32_round(items - ib)
    return (qs @ ib.T + qb @ is_.T) + qb @ ib.T
