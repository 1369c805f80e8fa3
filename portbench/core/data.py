"""
The synthetic interaction set of the benchmark, made from the seed.

It has the published counts of MovieLens 20M (GroupLens; Harper & Konstan,
ACM TiiS 2015): users, rated items and unique (user, item) pairs, with every
user at 20 interactions or more.  The ratings themselves cannot be fetched
here, so the shape of the data is assumed and written in each configuration
file under ``data``:

* history lengths: ``min_per_user`` plus the floor of a log-normal draw
  (``length_mu``, ``length_sigma``), at most ``max_per_user``, then scaled so
  that they add up to exactly ``n_pairs`` (a heavy tail, as in the data set).
  They are drawn once from ``length_seed``, so every run's set has the same
  lengths and so the same work; the run's seed deals them out to the users;
* item popularity: each item (numbered by rank) is aimed at a count of
  ``C / (rank + q)**s`` pairs, the curve through ``item_max`` at rank 1 and
  ``item_median`` at the middle rank whose counts add up to ``n_pairs``
  (:func:`item_degrees`).  Every item first gets one pair with a user drawn
  in proportion to its length, so none is left unrated; the rest are
  drawn by weight without replacement, with the popularity and planted
  groups of ``bench.py::synth_interactions``: a user's weight of an item
  is ``1 − in_group`` times its popularity weight, and the user's group
  (one of ``groups``) adds ``in_group`` times the popularity of each block
  of ``groups`` items to the group's item in it, as a draw snapped to the
  group there would.  Every user holds exactly its length of distinct
  items, so the set has exactly ``n_pairs`` unique pairs.  The popularity
  weights are fitted so that the counts expected under that draw meet the
  aim (:func:`item_weights`).

The lengths and the aimed counts come from NumPy (small arrays); the
weights are fitted and the items drawn on ``device``, by a
``torch.Generator`` in blocks of users.  The result is sorted by user,
then item.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Interactions", "history_lengths", "item_degrees", "item_weights", "make_interactions", "summary"]


@dataclass
class Interactions:
    """``users`` and ``items`` (int64, on the device), sorted by user then
    item, with ``n_users`` and ``n_items`` ids each numbered from 0."""

    users: torch.Tensor
    items: torch.Tensor
    n_users: int
    n_items: int
    lengths: np.ndarray  # (n_users,) history lengths
    slots: np.ndarray  # (n_users,) user u's place in the fixed draw of lengths

    @property
    def nnz(self) -> int:
        return int(self.users.shape[0])


def history_lengths(spec: dict, rng: np.random.Generator) -> np.ndarray:
    """Per-user history lengths: heavy-tailed, each in
    [``min_per_user``, ``max_per_user``], adding up to ``n_pairs``."""
    n, total = spec["n_users"], spec["n_pairs"]
    lo, hi = spec["min_per_user"], spec["max_per_user"]
    if not lo * n <= total <= hi * n:
        raise ValueError(f"{total} pairs cannot be spread over {n} users at {lo} to {hi} each")
    extra = np.exp(spec["length_mu"] + spec["length_sigma"] * rng.standard_normal(n))
    # scale the part above the floor so that the clipped lengths add up to the total
    lo_f, hi_f = 0.0, 1.0
    while lo + np.minimum(extra * hi_f, hi - lo).sum() / n < total / n:
        hi_f *= 2.0
    for _ in range(100):
        mid = (lo_f + hi_f) / 2
        if np.minimum(extra * mid, hi - lo).sum() < total - lo * n:
            lo_f = mid
        else:
            hi_f = mid
    lengths = lo + np.floor(np.minimum(extra * lo_f, hi - lo)).astype(np.int64)
    short = total - int(lengths.sum())
    # the rounding's remainder goes to users drawn from those below the cap
    room = np.flatnonzero(lengths < hi)
    lengths[rng.choice(room, size=short, replace=False)] += 1
    return lengths


def item_degrees(spec: dict) -> np.ndarray:
    """The aimed pair count of each item by rank: ``C / (rank + q)**s``
    through ``item_max`` at rank 1 and ``item_median`` at the middle rank,
    with ``q`` set so that the counts add up to ``n_pairs``."""
    n, total = spec["n_items"], spec["n_pairs"]
    top, med = spec["item_max"], spec["item_median"]
    if not med < total / n < top:
        raise ValueError(f"the mean count {total / n:.4g} has to lie between the median {med} and the maximum {top}")
    rank = np.arange(1, n + 1, dtype=np.float64)
    mid = (n + 1) / 2

    def curve(q: float) -> np.ndarray:
        s = np.log(top / med) / np.log((mid + q) / (1 + q))
        return top * ((1 + q) / (rank + q)) ** s

    # the sum grows with q: from a power law (q = 0) towards a flat head
    lo, hi = 0.0, 1.0
    while curve(hi).sum() < total:
        lo, hi = hi, hi * 2
        if hi > 1e12:
            raise ValueError("no curve through the maximum and the median adds up to the total")
    if curve(lo).sum() > total:
        raise ValueError("the counts through the maximum and the median exceed the total even as a power law")
    for _ in range(200):
        q = (lo + hi) / 2
        lo, hi = (q, hi) if curve(q).sum() < total else (lo, q)
    return curve((lo + hi) / 2)


def item_weights(spec: dict, lengths: np.ndarray, device: torch.device, rounds: int = 40) -> torch.Tensor:
    """Popularity weights (float64, adding up to 1) under which a draw as in
    :func:`make_interactions` gives each item its aimed count, less the one
    pair that every item gets first.

    A user who draws ``L`` distinct items by weight holds item ``j`` with
    probability about ``1 − exp(−w_j T)``, where ``T`` is the number of
    draws with replacement that leaves ``L`` distinct ones on average.  A
    user's ``w_j`` is ``(1 − in_group) p_j``, plus ``in_group`` times the
    popularity of ``j``'s block where ``j`` is the user's group's item
    there.  Groups are drawn evenly, so the counts expected over all users
    follow from the users' lengths; the weights are scaled item by item
    towards the aim, ``rounds`` times."""
    n, groups, share = spec["n_items"], spec["groups"], spec["in_group"]
    f64 = dict(dtype=torch.float64, device=device)
    aim = torch.as_tensor(item_degrees(spec) - 1.0, **f64).clamp_min(1e-3)
    uniq, count = np.unique(lengths, return_counts=True)
    L, C = torch.as_tensor(uniq, **f64), torch.as_tensor(count, **f64)
    block = torch.arange(n, device=device) // groups
    # the share of users whose group's item in its block is j (the last,
    # short block's missing places fall on its last item)
    owner = torch.clamp(block[::groups, None] * groups + torch.arange(groups, device=device)[None, :], max=n - 1)
    gshare = torch.bincount(owner.reshape(-1), minlength=n).to(torch.float64) / groups
    p = aim / aim.sum()
    T = L.clone()
    step = max(1, int(2**24 // n))  # lengths at a time
    for _ in range(rounds):
        mass = torch.zeros(int(block[-1]) + 1, **f64).index_add_(0, block, p)[block]
        w_out, w_in = (1 - share) * p, (1 - share) * p + share * mass
        deg = torch.zeros(n, **f64)
        for lo in range(0, L.shape[0], step):
            t = T[lo : lo + step, None]
            for _ in range(4):  # Newton: the distinct count is concave in T
                e_out, e_in = torch.exp(-w_out * t), torch.exp(-w_in * t)
                f = ((1 - gshare) * (1 - e_out) + gshare * (1 - e_in)).sum(1, keepdim=True) - L[lo : lo + step, None]
                fp = ((1 - gshare) * w_out * e_out + gshare * w_in * e_in).sum(1, keepdim=True)
                t = torch.maximum(t - f / fp, L[lo : lo + step, None])
            e_out, e_in = torch.exp(-w_out * t), torch.exp(-w_in * t)
            T[lo : lo + step] = t[:, 0]
            deg += C[lo : lo + step] @ ((1 - gshare) * (1 - e_out) + gshare * (1 - e_in))
        p = p * aim / deg.clamp_min(1e-12)
        p /= p.sum()
    return p


def make_interactions(spec: dict, seed: int, device: torch.device) -> Interactions:
    """The set of ``spec`` (a configuration's ``data``) drawn from ``seed``."""
    n_users, n_items = spec["n_users"], spec["n_items"]
    groups, share = spec["groups"], spec["in_group"]
    slots = np.random.default_rng(seed).permutation(n_users)
    lengths = history_lengths(spec, np.random.default_rng(spec["length_seed"]))[slots]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    need = torch.as_tensor(lengths, device=device)
    p = item_weights(spec, lengths, device)
    block = torch.arange(n_items, device=device) // groups
    n_blocks = int(block[-1]) + 1
    base = ((1 - share) * p).float()
    bonus = (share * torch.zeros(n_blocks, dtype=torch.float64, device=device).index_add_(0, block, p)).float()
    # the item of group g in block b (the last, short block's missing places fall on its last item)
    owner = torch.clamp(torch.arange(n_blocks, device=device)[:, None] * groups + torch.arange(groups, device=device)[None, :], max=n_items - 1)
    user_group = torch.randint(0, groups, (n_users,), generator=gen, device=device)
    # every item's first pair: a place among all users' places, none twice,
    # so no user gets more first pairs than its length
    places = torch.randperm(spec["n_pairs"], generator=gen, device=device)[:n_items]
    first_users = torch.searchsorted(torch.cumsum(need, 0), places, right=True)
    all_items = torch.arange(n_items, device=device)

    # each user's items: its first pairs, then the rest of its length drawn by
    # weight without replacement (the smallest of Exp(1) / weight)
    keys = []
    width = max(1, (1 << 25) // n_items)
    for lo in range(0, n_users, width):
        hi = min(n_users, lo + width)
        rows = torch.arange(hi - lo, device=device)
        w = base.repeat(hi - lo, 1)
        w[rows[:, None], owner[:, user_group[lo:hi]].T] += bonus
        key = torch.rand((hi - lo, n_items), generator=gen, device=device).log_().neg_().div_(w)
        mine = (first_users >= lo) & (first_users < hi)
        key[first_users[mine] - lo, all_items[mine]] = -1.0
        order = torch.argsort(key, dim=1, stable=True)
        take = all_items[None, :] < need[lo:hi, None]
        keys.append(((lo + rows)[:, None] * n_items + order)[take])
    keys = torch.sort(torch.cat(keys)).values
    users, items = keys // n_items, keys % n_items
    return Interactions(users, items, n_users, n_items, lengths, slots)


def summary(inter: Interactions) -> dict:
    """Quantiles (0, 10, 25, 50, 75, 90, 99, 100 %) of the pairs a user and
    an item, and their means, for the line before the result."""
    qs = [0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0]
    out = {}
    for name, ids, n in (("user", inter.users, inter.n_users), ("item", inter.items, inter.n_items)):
        c = torch.bincount(ids, minlength=n).double().cpu().numpy()
        out[name] = {"quantiles": [float(v) for v in np.quantile(c, qs)], "mean": float(c.mean())}
    return out

