"""
SLIM elastic-net training.

Port of ``lkpy_tpu/ops/slim.py`` (reference: src/accel/slim/mod.rs:58,96):
for each target item i the same convex objective as the reference's
coordinate descent,

    min_w  ½‖aᵢ − A w‖² + λ₁‖w‖₁ + ½λ₂‖w‖²   s.t.  w ≥ 0, wᵢ = 0,

solved for a block of targets at once by FISTA (accelerated proximal
gradient) with the non-negative soft-threshold prox, as in the JAX package.

Where the JAX package forms ``A @ w`` and ``Aᵀ @ r`` as segment sums over a
gather ``w[cols]`` of every interaction (at 14.2 M interactions and a block
of 256 targets, 14.5 GB a product), the port multiplies by CSR matrices of
the binary ``A`` and of its transpose (``torch.sparse.mm``, cuSPARSE on the
card).  A block's dense target columns are scattered on the device from the
item-major CSR.  The step ``1/L`` comes from the JAX package's host power
iteration, with its seed, so the two packages take the same step; the
momentum scalars are float32 on the host, as the JAX loop computes them.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.data.matrix import CSR
from lkpy_tpu_torch.ops.knn import _row_numbers

__all__ = ["device_csr", "train_slim"]


def _lipschitz(ui: CSR, n_iter: int = 20) -> float:
    """σ_max(A)² via power iteration on AᵀA (host, cheap)."""
    sp = ui.to_scipy(structural=True)
    rng = np.random.default_rng(0)
    v = rng.normal(size=sp.shape[1])
    v /= np.linalg.norm(v)
    s = 1.0
    for _ in range(n_iter):
        u = sp @ v
        v = sp.T @ u
        s = np.linalg.norm(v)
        if s == 0:
            return 1.0
        v /= s
    return float(s)


def device_csr(csr: CSR, device: torch.device, values: torch.Tensor | None = None) -> torch.Tensor:
    """``csr`` as a torch CSR matrix on ``device`` (int32 indices), with
    ``values`` or its own values (ones where it has none)."""
    if values is None:
        vals = csr.values if csr.values is not None else np.ones(csr.nnz, dtype=np.float32)
        values = torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32)).to(device)
    crow = torch.from_numpy(csr.rowptr.astype(np.int32)).to(device)
    col = torch.from_numpy(np.ascontiguousarray(csr.colind, dtype=np.int32)).to(device)
    with warnings.catch_warnings():
        # torch's note that sparse CSR support is in beta
        warnings.filterwarnings("ignore", message="Sparse", category=UserWarning)
        return torch.sparse_csr_tensor(crow, col, values, csr.shape, check_invariants=False)


def _slim_block(
    a: torch.Tensor,
    a_tr: torch.Tensor,
    targets: torch.Tensor,
    a_t: torch.Tensor,
    l1: float,
    l2: float,
    step: float,
    iters: int,
) -> torch.Tensor:
    """FISTA for a block of SLIM columns; returns (n_items, B) weights.

    Args:
        a: the binary user-item matrix A, a (n_users, n_items) CSR tensor.
        a_tr: its transpose Aᵀ, a (n_items, n_users) CSR tensor.
        targets: (B,) int64 target item numbers on A's device.
        a_t: (n_users, B) float32 dense target columns A[:, targets].
        step: the step 1/L.
    """
    n_items, B = a_tr.shape[0], targets.shape[0]
    f32 = np.float32
    shift = float(f32(step) * f32(l1))
    scale = float(f32(1.0) + f32(step) * f32(l2))
    cols = torch.arange(B, device=a_t.device)

    def prox(z):
        w = torch.clamp_min(z - shift, 0.0) / scale
        w[targets, cols] = 0.0
        return w

    w = torch.zeros((n_items, B), dtype=torch.float32, device=a_t.device)
    y = w
    t = f32(1.0)
    for _ in range(iters):
        grad = torch.sparse.mm(a_tr, torch.sparse.mm(a, y) - a_t)
        w_new = prox(y - step * grad)
        t_new = (f32(1.0) + np.sqrt(f32(1.0) + f32(4.0) * t * t)) / f32(2.0)
        y = w_new + float((t - f32(1.0)) / t_new) * (w_new - w)
        w, t = w_new, t_new
    return w


def train_slim(
    ui: CSR,
    l1: float,
    l2: float,
    max_iters: int = 100,
    block: int = 256,
    *,
    progress=None,
    device: str | torch.device | None = None,
) -> CSR:
    """
    Train the full SLIM weight matrix on ``device`` (the card unless
    ``"cpu"``).

    Returns a host CSR with rows = predictor item, cols = target item
    (the reference's transposed storage, slim.py:84 ``weights``), as the
    JAX function does.
    """
    dev = resolve_device(device)
    n_users, n_items = ui.shape
    ones = torch.ones(ui.nnz, dtype=torch.float32, device=dev)
    a = device_csr(ui, dev, ones)
    iu = ui.transpose()  # item-major: row j lists the users of item j
    a_tr = device_csr(iu, dev, ones)
    iu_users, iu_items = a_tr.col_indices().long(), _row_numbers(iu.rowptr, dev)
    step = float(np.float32(1.0 / max(_lipschitz(ui), 1e-6)))

    rows, cols, vals = [], [], []
    for lo in range(0, n_items, block):
        hi = min(lo + block, n_items)
        s, e = int(iu.rowptr[lo]), int(iu.rowptr[hi])
        a_t = torch.zeros((n_users, hi - lo), dtype=torch.float32, device=dev)
        a_t[iu_users[s:e], iu_items[s:e] - lo] = 1.0
        targets = torch.arange(lo, hi, device=dev)
        w = _slim_block(a, a_tr, targets, a_t, float(l1), float(l2), step, int(max_iters))
        nz_rows, nz_cols = torch.nonzero(w, as_tuple=True)
        rows.append(nz_rows.to(torch.int32))
        cols.append((nz_cols + lo).to(torch.int32))
        vals.append(w[nz_rows, nz_cols])
        if progress is not None:
            progress.update(hi - lo)

    # each block's entries come by predictor row and the blocks by target, so a stable sort by row
    # orders them all by (row, col); the CSR is assembled on the device and read back once
    rows, cols, vals = (torch.cat(x) if x else torch.zeros(0, dtype=t, device=dev) for x, t in
                        ((rows, torch.int32), (cols, torch.int32), (vals, torch.float32)))  # fmt: skip
    order = torch.argsort(rows, stable=True)
    rowptr = torch.zeros(n_items + 1, dtype=torch.int64, device=dev)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_items), 0)
    return CSR(rowptr.cpu().numpy(), cols[order].cpu().numpy(), vals[order].cpu().numpy(), (n_items, n_items))
