"""Parity of the port's splitting (``lkpy_tpu_torch.splitting``) with the JAX
package's on the CPU: the same interactions, with ratings and timestamps,
made with numpy from a seed, and the same split seed through both packages
give the same test lists (keys, ids and fields) and equal training
interaction tables."""

import datetime

import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu.splitting as jax_splitting
import lkpy_tpu_torch.splitting as splitting
from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import ItemListCollection as JaxILC
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu_torch.data import ItemList, ItemListCollection, from_interactions_df

torch.set_num_threads(1)


def _frame(seed=0, n_users=120, n_items=90):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.7, size=n_users) + 2, n_items // 2)
    users = np.repeat(np.arange(n_users), lens)
    items = np.concatenate([rng.choice(n_items, size=n, replace=False) for n in lens])
    return pd.DataFrame(
        {
            "user_id": users * 3 + 10,
            "item_id": items * 7 + 5,
            "rating": (rng.integers(1, 11, size=len(users)) / 2.0).astype(np.float32),
            "timestamp": rng.integers(0, 10**6, size=len(users)),
        }
    )


@pytest.fixture(scope="module")
def data():
    df = _frame()
    return jax_from_df(df.copy()), from_interactions_df(df.copy()), df


def _assert_lists_equal(got, want):
    np.testing.assert_array_equal(got.ids(), want.ids())
    assert got.field_names == want.field_names
    for name in want.field_names:
        np.testing.assert_array_equal(got.field(name), want.field(name))


def _assert_splits_equal(got, want):
    assert got.name == want.name
    assert got.test.key_fields == want.test.key_fields
    assert list(got.test.keys()) == list(want.test.keys())
    for (_, g), (_, w) in zip(got.test.items(), want.test.items()):
        _assert_lists_equal(g, w)
    assert got.test_size == want.test_size
    pd.testing.assert_frame_equal(got.train.interaction_table(ids=True), want.train.interaction_table(ids=True))
    pd.testing.assert_frame_equal(got.train_df, want.train_df)
    pd.testing.assert_frame_equal(got.test_df, want.test_df)
    np.testing.assert_array_equal(got.train.users.ids, want.train.users.ids)
    np.testing.assert_array_equal(got.train.items.ids, want.train.items.ids)


HOLDOUTS = [
    ("SampleN", (5,), True),
    ("SampleN", (1000,), True),
    ("SampleFrac", (0.2,), True),
    ("SampleFrac", (0.5,), True),
    ("LastN", (3,), False),
    ("LastFrac", (0.25,), False),
]


def _methods(name, args, seeded, seed):
    kw = {"rng": seed} if seeded else {}
    return getattr(jax_splitting, name)(*args, **kw), getattr(splitting, name)(*args, **kw)


@pytest.mark.parametrize("name,args,seeded", HOLDOUTS)
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_users_matches_jax(data, name, args, seeded, seed):
    jds, tds, _ = data
    jm, tm = _methods(name, args, seeded, seed)
    want = jax_splitting.sample_users(jds, 40, jm, rng=seed)
    got = splitting.sample_users(tds, 40, tm, rng=seed)
    _assert_splits_equal(got, want)


@pytest.mark.parametrize("name,args,seeded", HOLDOUTS[::2])
def test_crossfold_users_matches_jax(data, name, args, seeded):
    jds, tds, _ = data
    jm, tm = _methods(name, args, seeded, 3)
    want = list(jax_splitting.crossfold_users(jds, 3, jm, rng=3))
    got = list(splitting.crossfold_users(tds, 3, tm, rng=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_splits_equal(g, w)


def test_holdout_on_a_user_list_matches_jax(data):
    jds, tds, _ = data
    jrow, trow = jds.user_row(jds.users.ids[4]), tds.user_row(tds.users.ids[4])
    for name, args, seeded in HOLDOUTS:
        jm, tm = _methods(name, args, seeded, 11)
        _assert_lists_equal(tm(trow), jm(jrow))
    with pytest.raises(ValueError):
        splitting.LastN(2, field="no_such_field")(trow)


@pytest.mark.parametrize("size", [1, 500, 10**6])
def test_sample_records_matches_jax(data, size):
    jds, tds, _ = data
    _assert_splits_equal(splitting.sample_records(tds, size, rng=5), jax_splitting.sample_records(jds, size, rng=5))


def test_crossfold_records_matches_jax(data):
    jds, tds, _ = data
    want = list(jax_splitting.crossfold_records(jds, 4, rng=9))
    got = list(splitting.crossfold_records(tds, 4, rng=9))
    assert len(got) == 4
    for g, w in zip(got, want):
        _assert_splits_equal(g, w)
    assert sum(s.test_size for s in got) == tds.interaction_count


@pytest.mark.parametrize("kwargs", [dict(n_users=30, n_rates=4), dict(n_users=25, f_rates=0.3), dict(n_users=500)])
def test_simple_test_pair_matches_jax(data, kwargs):
    jds, tds, _ = data
    _assert_splits_equal(
        splitting.simple_test_pair(tds, rng=13, **kwargs), jax_splitting.simple_test_pair(jds, rng=13, **kwargs)
    )


def test_temporal_splits_match_jax(data):
    jds, tds, df = data
    t1, t2 = np.quantile(df["timestamp"], [0.6, 0.85])
    _assert_splits_equal(splitting.split_global_time(tds, t1), jax_splitting.split_global_time(jds, t1))
    _assert_splits_equal(splitting.split_global_time(tds, t1, t2), jax_splitting.split_global_time(jds, t1, t2))
    got = splitting.split_global_time(tds, [t1, t2])
    want = jax_splitting.split_global_time(jds, [t1, t2])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_splits_equal(g, w)
    at = datetime.datetime.fromtimestamp(float(t1), tz=datetime.timezone.utc)
    _assert_splits_equal(splitting.split_global_time(tds, at), jax_splitting.split_global_time(jds, at))
    for frac in (0.1, 0.3):
        _assert_splits_equal(splitting.split_temporal_fraction(tds, frac), jax_splitting.split_temporal_fraction(jds, frac))
    untimed = from_interactions_df(df[["user_id", "item_id"]].copy())
    with pytest.raises(ValueError):
        splitting.split_global_time(untimed, t1)


def test_split_from_src_and_test_matches_jax(data):
    jds, tds, df = data
    pick = df.iloc[np.random.default_rng(2).choice(len(df), 60, replace=False)]
    want = jax_splitting.TTSplit.from_src_and_test(jds, JaxILC.from_df(pick[["user_id", "item_id", "rating"]]), "held")
    got = splitting.TTSplit.from_src_and_test(tds, ItemListCollection.from_df(pick[["user_id", "item_id", "rating"]]), "held")
    _assert_splits_equal(got, want)
    assert got.train.interaction_count == tds.interaction_count - 60


def test_split_dataset_by_mask_matches_jax(data):
    from lkpy_tpu.splitting.split import split_dataset_by_mask as jax_split_by_mask
    from lkpy_tpu_torch.splitting.split import split_dataset_by_mask

    jds, tds, _ = data
    mask = np.random.default_rng(4).random(tds.interaction_count) < 0.1
    _assert_splits_equal(split_dataset_by_mask(tds, mask, name="m"), jax_split_by_mask(jds, mask, name="m"))
    empty = split_dataset_by_mask(tds, np.zeros(tds.interaction_count, bool))
    assert len(empty.test) == 0 and empty.train.interaction_count == tds.interaction_count


def test_holdouts_keep_the_list_type():
    il = ItemList(item_ids=np.arange(10), timestamp=np.arange(10)[::-1])
    jl = JaxItemList(item_ids=np.arange(10), timestamp=np.arange(10)[::-1])
    np.testing.assert_array_equal(splitting.LastN(3)(il).ids(), jax_splitting.LastN(3)(jl).ids())
    np.testing.assert_array_equal(splitting.LastN(3)(il).ids(), [2, 1, 0])
