"""The port's item lists and collections (``lkpy_tpu_torch.data.items``,
``.collection``) against the JAX package's on the CPU: collections saved to
Parquet by one package and loaded by the other (empty lists, several key
fields, ranks and extra fields, the array-backed top-N form), Arrow export,
keys as a NamedTuple class, keyword lookup, unindexed collections,
``add_from``, and ``ItemList``'s Arrow round trip, ``clone`` and
``concat``."""

from typing import NamedTuple

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.data import ItemList as JaxItemList
from lkpy_tpu.data import ItemListCollection as JaxILC
from lkpy_tpu.data import Vocabulary as JaxVocabulary
from lkpy_tpu.data.collection import ArrayTopNILC as JaxArrayTopNILC
from lkpy_tpu_torch.data import ArrayTopNILC, ItemList, ItemListCollection, ListILC, MutableItemListCollection, Vocabulary

torch.set_num_threads(1)


def _fill(cls_ilc, cls_il, seed=0):
    """Lists keyed by (part, user_id) from a seed: scored and ranked ones,
    unordered ones with a rating field, and empty ones."""
    rng = np.random.default_rng(seed)
    ilc = cls_ilc(["part", "user_id"])
    for u in range(12):
        n = int(rng.integers(0, 6))
        ids = rng.choice(100, n, replace=False)
        if u % 3 == 0:
            il = cls_il(item_ids=ids, scores=np.sort(rng.random(n))[::-1].astype(np.float32), ordered=True)
        elif u % 3 == 1:
            il = cls_il(item_ids=ids, rating=rng.integers(1, 6, n).astype(np.float64))
        else:
            il = cls_il()
        ilc.add(il, "train" if u < 6 else "test", u)
    return ilc


def _assert_same(got, want):
    """Equal keys and lists, in any order (a loaded file lists its empty
    lists last, in both packages)."""
    assert got.key_fields == want.key_fields
    assert sorted(tuple(k) for k in got.keys()) == sorted(tuple(k) for k in want.keys())
    for k, w in want.items():
        g = got.lookup(*k)
        assert len(g) == len(w)
        if len(w):
            np.testing.assert_array_equal(g.ids(), w.ids())
            assert sorted(g.field_names) == sorted(w.field_names)
            for name in w.field_names:
                np.testing.assert_array_equal(g.field(name), w.field(name))


@pytest.fixture(scope="module")
def pair():
    return _fill(JaxILC, JaxItemList), _fill(ItemListCollection, ItemList)


def test_to_df_and_arrow_equal(pair):
    jilc, ilc = pair
    pd.testing.assert_frame_equal(ilc.to_df(), jilc.to_df())
    assert ilc.to_arrow().equals(jilc.to_arrow())
    assert [tuple(k) for k in ilc._empty_keys()] == [tuple(k) for k in jilc._empty_keys()]


def _assert_same_ids(got, want):
    """The same keys and item ids; a loaded list carries every column of
    the long file, so fields are compared between two loads instead."""
    assert sorted(tuple(k) for k in got.keys()) == sorted(tuple(k) for k in want.keys())
    for k, w in want.items():
        np.testing.assert_array_equal(got.lookup(*k).ids(), w.ids())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("key", [None, ["part", "user_id"]])
def test_parquet_across_packages(pair, tmp_path, writer, key):
    jilc, ilc = pair
    p = tmp_path / "ilc.parquet"
    (jilc if writer == "jax" else ilc).save_parquet(p)
    got, want = ItemListCollection.load_parquet(p, key), JaxILC.load_parquet(p, key)
    _assert_same(got, want)
    _assert_same_ids(got, ilc)
    assert len(got.lookup("test", 8)) == 0


def test_array_topn_parquet_and_empty_keys(tmp_path):
    rng = np.random.default_rng(2)
    ids = rng.choice(1000, 40, replace=False)
    nums = rng.integers(0, 40, (6, 5)).astype(np.int32)
    scores = np.sort(rng.random((6, 5)).astype(np.float32), axis=1)[:, ::-1].copy()
    lengths = np.array([5, 0, 3, 5, 0, 1])
    keys = [10, 11, 12, 13, 14, 15]
    a = ArrayTopNILC(["user_id"], keys, nums, scores, lengths, Vocabulary(ids, "item"))
    ja = JaxArrayTopNILC(["user_id"], keys, nums, scores, lengths, JaxVocabulary(ids, "item"))
    assert [tuple(k) for k in a._empty_keys()] == [tuple(k) for k in ja._empty_keys()] == [(11,), (14,)]
    a.save_parquet(tmp_path / "port.parquet")
    ja.save_parquet(tmp_path / "jax.parquet")
    got = JaxILC.load_parquet(tmp_path / "port.parquet")
    _assert_same(got, JaxILC.load_parquet(tmp_path / "jax.parquet"))
    _assert_same(ItemListCollection.load_parquet(tmp_path / "jax.parquet"), got)
    with pytest.raises(TypeError):
        a.add(ItemList(), 99)


class _Key(NamedTuple):
    user_id: int
    fold: int


def test_namedtuple_key_keyword_lookup_and_index():
    ilc, jilc = ItemListCollection(_Key), JaxILC(_Key)
    for c, cls in ((ilc, ItemList), (jilc, JaxItemList)):
        c.add(cls(item_ids=[1, 2]), 5, 0)
        c.add(cls(item_ids=[3]), user_id=5, fold=1)
    assert ilc.key_fields == jilc.key_fields == ("user_id", "fold")
    assert list(ilc.lookup(user_id=5, fold=1).ids()) == list(jilc.lookup(user_id=5, fold=1).ids()) == [3]
    assert list(ilc.lookup((5, 0)).ids()) == [1, 2]
    assert ilc.lookup(6, 0) is None
    bare = ItemListCollection(["user_id"], index=False)
    bare.add(ItemList(item_ids=[4]), 1)
    assert len(bare) == 1 and list(bare.lists())[0].ids().tolist() == [4]
    with pytest.raises(RuntimeError):
        bare.lookup(1)


def test_add_from(pair):
    jilc, ilc = pair
    merged, jmerged = ItemListCollection(["run", "part", "user_id"]), JaxILC(["run", "part", "user_id"])
    merged.add_from(ilc, run="a")
    merged.add_from(ilc, run="b")
    jmerged.add_from(jilc, run="a")
    jmerged.add_from(jilc, run="b")
    _assert_same(merged, jmerged)
    assert len(merged) == 2 * len(ilc)


def test_aliases():
    assert MutableItemListCollection is ItemListCollection and ListILC is ItemListCollection


def test_item_list_arrow_clone_concat():
    rng = np.random.default_rng(4)
    vocab_ids = np.arange(50) * 3
    args = dict(item_ids=rng.choice(vocab_ids, 6, replace=False), scores=rng.random(6).astype(np.float32), rating=rng.random(6))
    il = ItemList(vocabulary=Vocabulary(vocab_ids, "item"), **args)
    jil = JaxItemList(vocabulary=JaxVocabulary(vocab_ids, "item"), **args)
    for ids, numbers in ((True, False), (True, True)):
        assert il.to_arrow(ids=ids, numbers=numbers).equals(jil.to_arrow(ids=ids, numbers=numbers))
    back, jback = ItemList.from_arrow(il.to_arrow()), JaxItemList.from_arrow(jil.to_arrow())
    np.testing.assert_array_equal(back.ids(), jback.ids())
    np.testing.assert_array_equal(back.scores(), jback.scores())
    c = il.clone()
    assert c is not il and len(c) == len(il) and np.array_equal(c.ids(), il.ids())
    other = ItemList(item_ids=vocab_ids[:3], scores=np.ones(3, np.float32))
    jother = JaxItemList(item_ids=vocab_ids[:3], scores=np.ones(3, np.float32))
    cat, jcat = il.concat(other), jil.concat(jother)
    np.testing.assert_array_equal(cat.ids(), jcat.ids())
    assert sorted(cat.field_names) == sorted(jcat.field_names)
    for name in jcat.field_names:
        np.testing.assert_array_equal(cat.field(name), jcat.field(name))
    assert il.field("rating", "arrow").equals(jil.field("rating", "arrow"))
    pd.testing.assert_series_equal(il.field("rating", "pandas"), jil.field("rating", "pandas"))
