"""
Batch serving engine: fold-in, scoring, history masking and top-n for a
batch of users on the device.

Port of ``lkpy_tpu/batch/serving.py``.  The training CSR lives on the device
(uploaded once per array, see :func:`lkpy_tpu_torch.batch.device._cached_device`)
and each block's histories are gathered there.  Users sort by history length
and chunk into fixed-size blocks; each block pads its histories to a
power-of-two ladder rung (64·2^j), and consecutive blocks on one rung form a
group (:func:`plan_groups`).  Each block then runs fold-in (or a user-table
lookup), one (B, k) × (k, n_items) product, history masking and an exact
top-n, all enqueued on the current stream without a host sync; the only
readback is the (N, n) result in :meth:`PendingServe.finalize`.

What the TPU engine does for its remote transport is left out: the pieced
f16/u16 readback, resident scalars and the per-group scan programs.  Results
come back as f32 scores and int32 item numbers.  ``timings`` gets the JAX
package's keys, told of the copies between host and device: ``enqueue_s``,
``readback_s``, a ``trace`` of ``(label, seconds, bytes)`` a copy and
``tunnel_ops``, their count.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["PendingServe", "ServePlan", "enqueue_serve", "plan_groups", "serve_batch"]

#: history pad widths: powers of two from 64
_H_LADDER_BASE = 64


def _ladder_width(maxlen: int) -> int:
    w = _H_LADDER_BASE
    while w < maxlen:
        w *= 2
    return w


class ServeGroup(NamedTuple):
    width: int  # padded history width H for this group
    start: int  # first chunk index
    chunks: int  # number of B-sized chunks


class ServePlan(NamedTuple):
    order: np.ndarray  # (N,) permutation sorting users by history length
    nums_padded: np.ndarray  # (N_pad,) int32 user numbers in sorted order, -1 pad
    groups: list  # [ServeGroup]
    block: int  # chunk size B


def plan_groups(nums: np.ndarray, lens: np.ndarray, block: int) -> ServePlan:
    """Sort users by history length, chunk into ``block``-sized blocks, and
    group consecutive blocks that share a history-width ladder rung."""
    known = nums >= 0
    key = np.where(known, lens[np.maximum(nums, 0)], 0)
    order = np.argsort(key, kind="stable")
    nums_s = nums[order].astype(np.int32)
    n = len(nums_s)
    n_pad = -(-n // block) * block
    nums_padded = np.full(n_pad, -1, dtype=np.int32)
    nums_padded[:n] = nums_s
    key_s = key[order]
    groups: list[ServeGroup] = []
    for c in range(n_pad // block):
        hi = min((c + 1) * block, n)
        maxlen = int(key_s[c * block : hi].max()) if hi > c * block else 0
        w = _ladder_width(max(maxlen, 1))
        if groups and groups[-1].width == w:
            g = groups[-1]
            groups[-1] = ServeGroup(w, g.start, g.chunks + 1)
        else:
            groups.append(ServeGroup(w, c, 1))
    return ServePlan(order, nums_padded, groups, block)


def _resident_csr(csr, needs_vals: bool, device: torch.device, trace: list | None = None):
    """(rowptr int64, colind int32, values f32 or None) on the device, each
    uploaded once per host array; an upload made here is one ``trace``
    entry."""
    from lkpy_tpu_torch.batch.device import _cached_device

    t0 = time.perf_counter()
    uploads: list = []
    vals = None
    if needs_vals:
        if csr.values is None:
            raise ValueError("serving path needs rating values but the CSR has none")
        vals = _cached_device(csr.values, device, uploads).to(torch.float32)
    entry = _cached_device(csr.rowptr, device, uploads), _cached_device(csr.colind, device, uploads), vals
    if trace is not None and uploads:
        trace.append(("upload:resident_csr", time.perf_counter() - t0, sum(uploads)))
    return entry


def _history(indptr, cols, vals, users, H: int):
    """Gather padded (B, H) histories for ``users`` from the device CSR;
    the valid entries of each row are its prefix."""
    safe = users.clamp_min(0)
    start = indptr[safe]
    length = torch.where(users >= 0, indptr[safe + 1] - start, 0)
    offs = torch.arange(H, device=users.device)
    hmask = offs[None, :] < length[:, None]
    idx = torch.clamp(start[:, None] + offs[None, :], max=cols.shape[0] - 1)
    hcols = torch.where(hmask, cols[idx].long(), 0)
    hvals = None if vals is None else torch.where(hmask, vals[idx], 0.0)
    return hcols, hvals, hmask


def _topn_scores(scores, hist_cols, hist_mask, n: int):
    """Mask history and take the top n of (B, n_items) ``scores``, in place.

    Padding slots point at the row's first history item, so every write to
    a column of a row with history is −inf and the scatter has no
    conflicting writes; a row without history rewrites column 0 with its own
    score."""
    has_hist = hist_mask[:, :1]
    tgt = torch.where(hist_mask, hist_cols, hist_cols[:, :1])
    fill = torch.where(has_hist, -torch.inf, scores.gather(1, tgt))
    scores.scatter_(1, tgt, fill)
    return torch.topk(scores, n, dim=1)


def _serve_block(users, indptr, cols, vals, i_emb, i_bias, offset, u_table, u_bias, kern, kern_args, H, n):
    hcols, hvals, hmask = _history(indptr, cols, vals, users, H)
    if kern is not None:
        u_emb, ub = kern(hcols, hvals, hmask, *kern_args)
    else:
        safe = users.clamp_min(0)
        u_emb = u_table[safe]
        ub = None if u_bias is None else u_bias[safe]
    s = u_emb @ i_emb.T
    # each term is a full pass over the (B, n_items) block: add only those present
    if i_bias is not None:
        s = s + i_bias[None, :]
    if ub is not None:
        s = s + ub[:, None]
    if offset:
        s = s + offset
    return _topn_scores(s, hcols, hmask, n)


class PendingServe(NamedTuple):
    """An enqueued serving batch: device work issued, readback pending.
    ``finalize()`` returns ``(vals f32 (N, n), idx int32 (N, n), order)``
    with rows in sorted order: position ``order[i]`` -> input row, and
    fills ``timings`` (when given) with ``enqueue_s``, ``readback_s`` (host
    seconds of the readback, waiting for the device work included),
    ``trace`` and ``tunnel_ops``."""

    v: torch.Tensor  # (N_pad, n) f32 on the device
    ix: torch.Tensor  # (N_pad, n) int32 on the device
    order: np.ndarray
    n_rows: int
    t_enqueue: float = 0.0
    trace: list | None = None
    timings: dict | None = None

    def finalize(self):
        N = self.n_rows
        tr = time.perf_counter()
        v, ix = self.v[:N].cpu().numpy(), self.ix[:N].cpu().numpy()
        t_read = time.perf_counter() - tr
        if self.timings is not None:
            self.trace.append(("readback:topn", t_read, v.nbytes + ix.nbytes))
            self.timings["enqueue_s"] = self.t_enqueue
            self.timings["readback_s"] = t_read
            self.timings["tunnel_ops"] = len(self.trace)
            self.timings["trace"] = self.trace
        return v, ix, self.order


def serve_batch(nums: np.ndarray, csr, **kw):
    """Run one serving batch; see :func:`enqueue_serve` for the arguments and
    :class:`PendingServe` for the result."""
    return enqueue_serve(nums, csr, **kw).finalize()


def enqueue_serve(
    nums: np.ndarray,
    csr,
    *,
    n: int,
    n_items: int,
    i_emb: torch.Tensor,
    i_bias: torch.Tensor | None,
    offset: float,
    device: torch.device,
    kern=None,
    kern_args=(),
    needs_vals: bool = False,
    u_table: torch.Tensor | None = None,
    u_bias: torch.Tensor | None = None,
    block: int = 1024,
    timings: dict | None = None,
) -> PendingServe:
    """Issue all device work for one serving batch of user numbers ``nums``
    (−1 for unknown users) against the training ``csr``.  ``kern`` is a
    fold-in kernel (with ``kern_args``) or None to look users up in
    ``u_table``.  ``timings`` is filled by ``finalize()``."""
    trace: list | None = [] if timings is not None else None
    t0 = time.perf_counter()
    n = min(n, n_items)  # catalogs smaller than the requested list length
    plan = plan_groups(np.asarray(nums), csr.row_lengths(), block)
    indptr, colv, valv = _resident_csr(csr, needs_vals, device, trace)
    tu = time.perf_counter()
    nums_host = plan.nums_padded.astype(np.int64)
    nums_dev = torch.from_numpy(nums_host).to(device)
    if trace is not None:
        trace.append(("upload:user_nums", time.perf_counter() - tu, nums_host.nbytes))
    n_pad = len(plan.nums_padded)
    v = torch.empty((n_pad, n), dtype=torch.float32, device=device)
    ix = torch.empty((n_pad, n), dtype=torch.int32, device=device)
    B = plan.block
    for g in plan.groups:
        for c in range(g.start, g.start + g.chunks):
            lo = c * B
            users = nums_dev[lo : lo + B]
            vb, ib = _serve_block(
                users, indptr, colv, valv, i_emb, i_bias, offset, u_table, u_bias, kern, kern_args, g.width, n
            )
            v[lo : lo + B] = vb
            ix[lo : lo + B] = ib
    return PendingServe(v, ix, plan.order, len(nums), time.perf_counter() - t0, trace, timings)
