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


@pytest.mark.parametrize("kind", ["int", "rating", "str"])
def test_tables_counts_and_stats_match(kind):
    df = _frame(np.random.default_rng(10 + len(kind)), kind)
    ref = jax_from_df(df.copy())
    got = from_interactions_df(df.copy())
    assert got.interaction_count == ref.interaction_count == got.interactions().count()
    for ids in (False, True):
        pd.testing.assert_frame_equal(got.interaction_table(ids=ids), ref.interaction_table(ids=ids))
        pd.testing.assert_frame_equal(got.interactions().pandas(ids=ids), ref.interactions().pandas(ids=ids))
    attrs = ["rating"] if kind == "rating" else []
    pd.testing.assert_frame_equal(
        got.interactions().pandas(attributes=attrs), ref.interactions().pandas(attributes=attrs)
    )
    pd.testing.assert_frame_equal(got.user_stats(), ref.user_stats())
    pd.testing.assert_frame_equal(got.item_stats(), ref.item_stats())
    pd.testing.assert_frame_equal(got.interaction_matrix().row_stats(), ref.interaction_matrix().row_stats())
    if kind == "rating":
        assert {"mean_rating", "first_time", "last_time"} <= set(got.user_stats().columns)


def test_vocabulary_id_matches():
    from lkpy_tpu.data import Vocabulary as JaxVocabulary

    for ids in (np.array([30, 10, 20]), np.array(["b", "a", "c"])):
        for reorder in (True, False):
            got, ref = Vocabulary(ids, "item", reorder=reorder), JaxVocabulary(ids, "item", reorder=reorder)
            assert [got.id(n) for n in range(3)] == [ref.id(n) for n in range(3)]
            assert got.id(np.int64(1)) == ref.id(1)
            for bad in (-1, 3):
                with pytest.raises(IndexError):
                    got.id(bad)


def test_item_list_from_df_matches():
    from lkpy_tpu.data import ItemList as JaxItemList
    from lkpy_tpu.data import Vocabulary as JaxVocabulary

    frames = [
        pd.DataFrame({"item_id": [5, 3, 9], "score": [0.9, 0.5, 0.1], "rank": [1, 2, 3], "rating": [4.0, 2.5, 1.0]}),
        pd.DataFrame({"item_id": [5, 3], "rank": [np.nan, np.nan], "user_id": [1, 1], "user_x": [7, 8]}),
        pd.DataFrame({"item_num": [2, 0, 1], "timestamp": [30, 10, 20]}),
        pd.DataFrame({"item_id": ["a", "c"], "score": [np.nan, 1.0]}),
        pd.DataFrame({"item_id": np.array([], dtype=np.int64)}),
    ]
    ids = np.array([3, 5, 9])
    for df in frames:
        vocab = (Vocabulary(ids, "item"), JaxVocabulary(ids, "item")) if "item_num" in df else (None, None)
        got = ItemList.from_df(df, vocabulary=vocab[0])
        ref = JaxItemList.from_df(df, vocabulary=vocab[1])
        assert len(got) == len(ref) and got.ordered == ref.ordered
        assert got.field_names == ref.field_names
        np.testing.assert_array_equal(got.ids(), ref.ids())
        for name in ref.field_names:
            np.testing.assert_array_equal(got.field(name), ref.field(name))
        pd.testing.assert_frame_equal(got.to_df(), ref.to_df())


def test_collection_from_df_and_projection_match():
    from lkpy_tpu.data import ItemListCollection as JaxILC
    from lkpy_tpu.data.keys import create_key_type as jax_key_type
    from lkpy_tpu.data.keys import project_key as jax_project_key
    from lkpy_tpu_torch.data import ItemListCollection
    from lkpy_tpu_torch.data.keys import create_key_type, project_key

    rng = np.random.default_rng(6)
    df = pd.DataFrame(
        {
            "user_id": rng.integers(0, 9, 60),
            "seq": rng.integers(0, 2, 60),
            "item_id": rng.integers(0, 40, 60),
            "rating": rng.uniform(1, 5, 60),
        }
    )
    for key in (None, "user_id", ["user_id", "seq"]):
        got, ref = ItemListCollection.from_df(df, key), JaxILC.from_df(df, key)
        assert got.key_fields == ref.key_fields
        assert [tuple(k) for k in got.keys()] == [tuple(k) for k in ref.keys()]
        pd.testing.assert_frame_equal(got.to_df(), ref.to_df())
    with pytest.raises(ValueError):
        ItemListCollection.from_df(df.drop(columns="user_id"))
    by_user = ItemListCollection.from_df(df)
    ref_user = JaxILC.from_df(df)
    run_key, jax_run_key = create_key_type("user_id", "seq"), jax_key_type("user_id", "seq")
    query_key = create_key_type("query_id")
    for u in list(range(10)):
        k, jk = run_key(u, 1), jax_run_key(u, 1)
        a, b = by_user.lookup_projected(k), ref_user.lookup_projected(jk)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a.ids(), b.ids())
        assert tuple(project_key(k, by_user.key_type)) == tuple(jax_project_key(jk, ref_user.key_type)) == (u,)
        assert by_user.lookup_projected((u,)) is by_user.lookup(u)
        assert by_user.lookup_projected(query_key(u)) is None
    with pytest.raises(TypeError):
        project_key(query_key(1), by_user.key_type)
    assert project_key(by_user.key_type(3), by_user.key_type) == (3,)
