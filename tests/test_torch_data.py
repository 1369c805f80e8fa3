"""Parity tests for the port's data layer and serving plan against the JAX
package: the same frames give the same vocabularies, CSR and plans."""

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.batch.serving import plan_groups as jax_plan_groups
from lkpy_tpu.data import from_interactions_df as jax_from_df
from lkpy_tpu.data.collection import ArrayTopNILC as JaxArrayTopNILC
from lkpy_tpu_torch.batch.serving import plan_groups
from lkpy_tpu_torch.data import ArrayTopNILC, ItemList, Vocabulary, from_interactions_df

torch.set_num_threads(1)


def _frame(rng, kind: str) -> pd.DataFrame:
    n = 3000
    users = rng.integers(0, 150, size=n) * 7 + 3
    items = rng.integers(0, 400, size=n) * 3 + 1
    if kind == "str":
        return pd.DataFrame({"user": [f"u{u}" for u in users], "movieId": [f"i{i}" for i in items]})
    df = pd.DataFrame({"user_id": users, "item_id": items})
    if kind == "rating":
        df["rating"] = rng.uniform(0.5, 5.0, size=n).round(1)
        df["timestamp"] = rng.integers(0, 10**6, size=n)
    return df


@pytest.mark.parametrize("kind", ["int", "rating", "str"])
def test_from_interactions_df_matches(kind):
    df = _frame(np.random.default_rng(len(kind)), kind)
    ref = jax_from_df(df.copy())
    got = from_interactions_df(df.copy())
    for attr in ("users", "items"):
        np.testing.assert_array_equal(getattr(got, attr).ids, getattr(ref, attr).ids)
    rm, gm = ref.interaction_matrix(), got.interaction_matrix()
    rc, gc = rm.csr("rating"), gm.csr("rating")
    np.testing.assert_array_equal(gc.rowptr, rc.rowptr)
    np.testing.assert_array_equal(gc.colind, rc.colind)
    if rc.values is None:
        assert gc.values is None
    else:
        np.testing.assert_array_equal(gc.values, rc.values)
    assert sorted(gc.fields) == sorted(rc.fields)
    for name in rc.fields:
        np.testing.assert_array_equal(gc.fields[name], rc.fields[name])
    np.testing.assert_array_equal(gm.row_vocabulary.ids, rm.row_vocabulary.ids)
    np.testing.assert_array_equal(gm.col_vocabulary.ids, rm.col_vocabulary.ids)
    uid = ref.users.ids[5]
    np.testing.assert_array_equal(got.user_row(uid).ids(), ref.user_row(uid).ids())
    np.testing.assert_array_equal(gm.row_items(number=5).numbers(), rm.row_items(number=5).numbers())
    assert got.user_row("no-such-user" if kind == "str" else -1) is None


@pytest.mark.parametrize("seed,block", [(0, 1), (1, 4), (2, 16), (3, 64), (4, 7)])
def test_plan_groups_matches(seed, block):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 600, size=80)
    nums = rng.integers(-1, 80, size=rng.integers(1, 300))
    ref = jax_plan_groups(nums, lens, block)
    got = plan_groups(nums, lens, block)
    np.testing.assert_array_equal(got.order, ref.order)
    np.testing.assert_array_equal(got.nums_padded, ref.nums_padded)
    assert [tuple(g) for g in got.groups] == [tuple(g) for g in ref.groups]
    assert got.block == ref.block


def test_array_topn_ilc_matches():
    rng = np.random.default_rng(4)
    N, n = 12, 6
    ids = np.arange(100, 140)
    nums = rng.integers(0, 40, size=(N, n)).astype(np.int32)
    scores = np.sort(rng.standard_normal((N, n)).astype(np.float32), axis=1)[:, ::-1].copy()
    lengths = rng.integers(0, n + 1, size=N)
    keys = list(range(1000, 1000 + N))
    from lkpy_tpu.data import Vocabulary as JaxVocabulary

    ref = JaxArrayTopNILC(["user_id"], keys, nums, scores, lengths, JaxVocabulary(ids, "item"))
    got = ArrayTopNILC(["user_id"], keys, nums, scores, lengths, Vocabulary(ids, "item"))
    assert len(got) == len(ref) and got.total_items() == ref.total_items()
    for key in keys + [5]:
        a, b = got.lookup(key), ref.lookup(key)
        if b is None:
            assert a is None
            continue
        np.testing.assert_array_equal(a.ids(), b.ids())
        np.testing.assert_array_equal(a.numbers(), b.numbers())
        np.testing.assert_array_equal(a.scores(), b.scores())
        np.testing.assert_array_equal(a.ranks(), b.ranks())
    for (ka, la), (kb, lb) in zip(got.items(), ref.items()):
        assert tuple(ka) == tuple(kb) and len(la) == len(lb)
    pd.testing.assert_frame_equal(got.to_df(), ref.to_df(), check_dtype=False)


def test_item_list_accessors():
    vocab = Vocabulary(np.array([10, 20, 30, 40]), "item")
    il = ItemList(item_nums=[2, 0], vocabulary=vocab, scores=[0.5, 0.25], rating=[4.0, 3.0])
    assert len(il) == 2
    np.testing.assert_array_equal(il.ids(), [30, 10])
    np.testing.assert_array_equal(il.numbers(), [2, 0])
    np.testing.assert_array_equal(il.scores("torch").numpy(), np.float32([0.5, 0.25]))
    np.testing.assert_array_equal(il.field("rating"), [4.0, 3.0])
    assert il.ranks() is None and sorted(il.field_names) == ["rating", "score"]
    by_id = ItemList(item_ids=[40, 99], vocabulary=vocab)
    np.testing.assert_array_equal(by_id.numbers(missing="negative"), [3, -1])
    with pytest.raises(KeyError):
        by_id.numbers()
    with pytest.raises(ValueError):
        ItemList(item_ids=[1, 2], scores=[0.1])
