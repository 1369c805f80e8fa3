"""
The comparisons that decide ``correct``: each turns the program's outputs
and the plain reference's into one number, which the harness holds against
the configuration's limit for it.
"""

from __future__ import annotations

import math

import torch

__all__ = ["list_gaps", "relative_gap"]


def relative_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """‖prog − ref‖ / ‖ref‖ (Frobenius, in float64)."""
    ref = ref.double()
    return float(torch.linalg.norm(prog.double() - ref) / torch.linalg.norm(ref))


def list_gaps(items: torch.Tensor, scores: torch.Tensor, lengths: torch.Tensor, ref: torch.Tensor, n: int) -> tuple[float, float]:
    """Hold served top-``n`` lists against reference scores.

    ``items`` and ``scores`` are (B, n) (a short list is padded, its length in
    ``lengths``), ``ref`` the (B, n_items) reference scores with every
    history item at −inf.  Returns the widest gap by which a served item's
    reference score lies below the reference's own score at its rank, and
    the largest error of a served score, both against the row's largest
    reference score in magnitude.  A short list, an item out of range, in
    the history or twice in one list reads as an infinite gap."""
    ref = ref.double()
    finite = torch.isfinite(ref)
    due = torch.clamp(finite.sum(dim=1), max=n)
    scale = torch.where(finite, ref.abs(), 0.0).amax(dim=1).clamp_min(1e-30)
    best = torch.topk(ref, n, dim=1).values
    valid = (items >= 0) & (items < ref.shape[1])
    got = ref.gather(1, torch.where(valid, items, 0).long())
    got = torch.where(valid, got, -math.inf)
    pos = torch.arange(n, device=ref.device)[None, :]
    live = pos < due[:, None]
    gap = torch.where(live, (best - got) / scale[:, None], 0.0)
    err = torch.where(live, (scores.double() - got).abs() / scale[:, None], 0.0)
    gap_max = float(gap.max()) if gap.numel() else 0.0
    # an item twice in a list: the served places, sorted, with each empty
    # place given a number of its own below every item's
    served = torch.sort(torch.where(live, items, -1 - pos), dim=1).values
    repeated = bool((served[:, 1:] == served[:, :-1]).any())
    if bool((lengths < due).any()) or repeated or math.isnan(gap_max):
        gap_max = math.inf
    err_max = float(err.max()) if err.numel() else 0.0
    return gap_max, (math.inf if math.isnan(err_max) else err_max)
