"""The generator: exact counts, the floor of 20 a user, no repeated pair,
every item rated, the items' counts at their aim, the same set from the
same seed."""

import numpy as np
import pytest
import torch

from portbench.core.data import history_lengths, item_degrees, make_interactions

SPEC = {
    "n_users": 400, "n_items": 900, "n_pairs": 30011, "min_per_user": 20, "max_per_user": 500,
    "length_mu": 3.871, "length_sigma": 1.378, "length_seed": 0, "item_max": 300, "item_median": 12, "groups": 50, "in_group": 0.75,
}


@pytest.mark.parametrize("seed", [0, 2147483713, 2**40 + 3])
def test_counts_floor_and_uniqueness(seed):
    d = make_interactions(SPEC, seed, torch.device("cpu"))
    u, i = d.users.numpy(), d.items.numpy()
    assert d.nnz == SPEC["n_pairs"]
    counts = np.bincount(u, minlength=SPEC["n_users"])
    assert (counts == d.lengths).all() and counts.min() >= 20 and counts.max() <= 500
    keys = u * SPEC["n_items"] + i
    assert (np.diff(keys) > 0).all()
    assert len(np.unique(i)) == SPEC["n_items"]


def test_same_seed_same_set_and_every_seed_the_same_lengths():
    a = make_interactions(SPEC, 5, torch.device("cpu"))
    b = make_interactions(SPEC, 5, torch.device("cpu"))
    c = make_interactions(SPEC, 6, torch.device("cpu"))
    assert torch.equal(a.users, b.users) and torch.equal(a.items, b.items)
    assert not torch.equal(a.items, c.items) and not np.array_equal(a.lengths, c.lengths)
    assert np.array_equal(np.sort(a.lengths), np.sort(c.lengths))


def test_lengths_at_full_scale_are_heavy_tailed():
    spec = dict(SPEC, n_users=138493, n_items=26744, n_pairs=20000263, max_per_user=9254)
    L = history_lengths(spec, np.random.default_rng(1))
    assert L.sum() == 20000263 and L.min() >= 20 and L.max() <= 9254
    assert 55 <= np.median(L) <= 80 and L.max() > 3000


@pytest.mark.parametrize("seed", [11, 2**40 + 7])
def test_item_counts_meet_their_aim(seed):
    d = make_interactions(SPEC, seed, torch.device("cpu"))
    got = np.bincount(d.items.numpy(), minlength=SPEC["n_items"])
    aim = item_degrees(SPEC)
    assert aim.sum() == pytest.approx(SPEC["n_pairs"]) and aim[0] == pytest.approx(SPEC["item_max"])
    for q in (0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        assert np.quantile(got, q) == pytest.approx(np.quantile(aim, q), rel=0.1), q

