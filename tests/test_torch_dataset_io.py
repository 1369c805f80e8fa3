"""The port's datasets (``lkpy_tpu_torch.data.dataset``) against the JAX
package's on the CPU: the same interactions and item attributes, made with
numpy from a seed, through both packages' builders; datasets saved by one
package and loaded by the other; the lazy dataset; the matrix views,
co-occurrences and host negative sampling; vocabularies, CSR rows and
``MTArray``."""

import pickle
import threading

import numpy as np
import pandas as pd
import pytest
import torch

import lkpy_tpu._native
from lkpy_tpu.data import DataContainer as JaxDataContainer
from lkpy_tpu.data import Dataset as JaxDataset
from lkpy_tpu.data import DatasetBuilder as JaxBuilder
from lkpy_tpu.data import QueryItemSource as JaxQueryItemSource
from lkpy_tpu.data import Vocabulary as JaxVocabulary
from lkpy_tpu.data.mtarray import MTArray as JaxMTArray
from lkpy_tpu.splitting.split import split_dataset_by_mask as jax_split_by_mask
from lkpy_tpu_torch.data import (
    CSR,
    DataContainer,
    Dataset,
    DatasetBuilder,
    EntityAttribute,
    QueryItemSource,
    Vocabulary,
)
from lkpy_tpu_torch.data.mtarray import MTArray
from lkpy_tpu_torch.splitting.split import split_dataset_by_mask

torch.set_num_threads(1)


def _frame(seed=0, n_users=60, n_items=40, nnz=700):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame(
        {
            "user_id": rng.integers(0, n_users, nnz) * 3 + 1,
            "item_id": rng.integers(0, n_items, nnz) * 5 + 2,
            "rating": rng.integers(1, 11, nnz) / 2.0,
            "timestamp": rng.integers(0, 10**6, nnz),
        }
    )
    return df.drop_duplicates(["user_id", "item_id"]).reset_index(drop=True)


def _build(builder_cls, df, seed=1):
    """Interactions plus a scalar, a list and a vector item attribute, from the seed."""
    rng = np.random.default_rng(seed)
    b = builder_cls("parity")
    b.add_interactions("rating", df, entities=["user", "item"], missing="insert", default=True)
    items = np.unique(df["item_id"])
    b.add_scalar_attribute("item", "category", items, rng.integers(0, 5, len(items)).astype(np.int64))
    tagged = items[::3]
    b.add_list_attribute("item", "tags", tagged, [list(rng.integers(0, 9, rng.integers(1, 4))) for _ in tagged])
    b.add_vector_attribute("item", "embedding", items, rng.standard_normal((len(items), 4)).astype(np.float32))
    b.add_scalar_attribute("user", "age", pd.Series(rng.integers(18, 70, 10), index=np.unique(df["user_id"])[:10]))
    return b.build()


@pytest.fixture(scope="module")
def pair():
    df = _frame()
    return _build(JaxBuilder, df.copy()), _build(DatasetBuilder, df.copy())


def _same_attr(got, want):
    assert got.name == want.name
    g, w = got.to_numpy(), want.to_numpy()
    assert len(g) == len(w)
    if w.dtype != object:
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        return
    for a, b in zip(g, w):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_same_dataset(got, want):
    assert got.name == want.name
    assert got.schema.model_dump() == want.schema.model_dump()
    pd.testing.assert_frame_equal(got.interaction_table(ids=True), want.interaction_table(ids=True))
    for name in ("user", "item"):
        ge, we = got.entities(name), want.entities(name)
        np.testing.assert_array_equal(ge.ids(), we.ids())
        assert ge.attribute_names == we.attribute_names
        for attr in we.attribute_names:
            _same_attr(ge.attribute(attr), we.attribute(attr))


def test_built_datasets_equal(pair):
    jds, ds = pair
    _assert_same_dataset(ds, jds)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_saved_dataset_loads_across_packages(pair, tmp_path, direction):
    jds, ds = pair
    if direction == "jax_to_port":
        jds.save(tmp_path)
        got, want = Dataset.load(tmp_path), jds
        again = DataContainer.load(tmp_path).dataset()
    else:
        ds.save(tmp_path)
        got, want = JaxDataset.load(tmp_path), ds
        again = JaxDataContainer.load(tmp_path).dataset()
    _assert_same_dataset(got, want)
    _assert_same_dataset(again, want)
    assert got.items.checksum() == want.items.checksum() and got.users.checksum() == want.users.checksum()


def test_container_roundtrip(pair, tmp_path):
    jds, ds = pair
    DataContainer.from_dataset(ds).save(tmp_path)
    _assert_same_dataset(DataContainer.load(tmp_path).dataset(), jds)
    c = DataContainer.from_dataset(ds)
    assert sorted(c.tables) == ["item", "rating", "user"]


@pytest.mark.parametrize("fmt", ["pandas", "numpy", "arrow"])
def test_interaction_table_formats(pair, fmt):
    jds, ds = pair
    got, want = ds.interaction_table(format=fmt, ids=True), jds.interaction_table(format=fmt, ids=True)
    if fmt == "pandas":
        pd.testing.assert_frame_equal(got, want)
    elif fmt == "arrow":
        assert got.equals(want)
    else:
        assert list(got) == list(want)
        for c in want:
            np.testing.assert_array_equal(got[c], want[c])


def test_entity_set_accessors(pair):
    jds, ds = pair
    je, e = jds.entities("item"), ds.entities("item")
    assert e.count == je.count == len(e)
    np.testing.assert_array_equal(e.numbers(), je.numbers())
    pd.testing.assert_frame_equal(e.pandas(), je.pandas())
    a, ja = e.attribute_set("category"), je.attribute_set("category")
    assert isinstance(a, EntityAttribute) and a.entity_class == ja.entity_class == "item" and len(a) == len(ja)
    np.testing.assert_array_equal(a.ids(), ja.ids())
    np.testing.assert_array_equal(a.numbers(), ja.numbers())
    np.testing.assert_array_equal(a.numpy(), ja.numpy())
    pick = ds.items.ids[[3, 0, 7]]
    sub, jsub = e.select(ids=pick), je.select(ids=pick)
    np.testing.assert_array_equal(sub.ids(), jsub.ids())
    pd.testing.assert_frame_equal(sub.pandas(), jsub.pandas())
    pd.testing.assert_frame_equal(e.select(numbers=[5, 1]).pandas(), je.select(numbers=[5, 1]).pandas())
    with pytest.raises(KeyError):
        e.attribute("missing")


def test_relationship_accessors(pair):
    jds, ds = pair
    rel, jrel = ds.interactions(), jds.interactions()
    assert rel.is_interaction and jrel.is_interaction
    assert rel.attribute_names == jrel.attribute_names
    assert rel.arrow(ids=True).equals(jrel.arrow(ids=True))
    m, jm = ds.interaction_matrix(), jds.interaction_matrix()
    assert (m.n_rows, m.n_cols) == (jm.n_rows, jm.n_cols)
    for got, want in ((m.csr_structure(), jm.csr_structure()), (m.transpose(), jm.transpose())):
        np.testing.assert_array_equal(got.rowptr, want.rowptr)
        np.testing.assert_array_equal(got.colind, want.colind)
    np.testing.assert_array_equal(m.coo_structure().row, jm.coo_structure().row)
    np.testing.assert_array_equal(m.coo_structure().col, jm.coo_structure().col)
    t, jt = m.torch(), jm.torch()
    assert t.layout == torch.sparse_csr and t.device.type == "cpu"
    torch.testing.assert_close(t.to_dense(), jt.to_dense(), rtol=0, atol=0)
    ilc, jilc = m.to_ilc(), jrel.item_lists()
    assert list(ilc.keys()) == list(jilc.keys()) and ilc.key_fields == jilc.key_fields
    for (_, g), (_, w) in zip(ilc.items(), jilc.items()):
        np.testing.assert_array_equal(g.ids(), w.ids())
        np.testing.assert_array_equal(g.field("rating"), w.field("rating"))


@pytest.mark.parametrize("entity", ["item", "user"])
@pytest.mark.parametrize("include_self", [False, True])
def test_co_occurrences_equal(pair, entity, include_self):
    jds, ds = pair
    got = ds.interactions().co_occurrences(entity, include_self=include_self)
    want = jds.interactions().co_occurrences(entity, include_self=include_self)
    assert got.shape == want.shape
    for a in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    np.testing.assert_array_equal(
        ds.interactions().co_occurrences(entity, include_self=include_self, dense=True),
        jds.interactions().co_occurrences(entity, include_self=include_self, dense=True),
    )


@pytest.mark.parametrize("weighting", ["uniform", "popularity"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("verify", [True, False])
def test_sample_negatives_equal_to_jax(pair, monkeypatch, weighting, n, verify):
    # the JAX package's NumPy path (its optional C++ path off)
    monkeypatch.setattr(lkpy_tpu._native, "available", lambda: False)
    jds, ds = pair
    m, jm = ds.interaction_matrix(), jds.interaction_matrix()
    rows = np.random.default_rng(3).integers(0, m.n_rows, 200)
    got = m.sample_negatives(rows, n=n, weighting=weighting, verify=verify, rng=np.random.default_rng(9))
    want = jm.sample_negatives(rows, n=n, weighting=weighting, verify=verify, rng=np.random.default_rng(9))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if verify:
        csr = m.csr_structure()
        for r, cols in zip(rows, got.reshape(len(rows), -1)):
            assert not np.isin(cols, csr.row_cols(r)).any()


def test_lazy_thunk_runs_once_under_threads(pair):
    _, ds = pair
    calls = []
    barrier = threading.Barrier(8)

    def thunk():
        calls.append(1)
        return ds

    lazy = Dataset(thunk)
    assert not hasattr(lazy, "_repr_html_") and calls == []
    counts = []

    def read():
        barrier.wait()
        counts.append(lazy.interaction_count)

    threads = [threading.Thread(target=read) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [1] and counts == [ds.interaction_count] * 8
    assert "_lazy_thunk" not in lazy.__dict__


def test_lazy_pickles_materialized(pair):
    _, ds = pair
    calls = []
    lazy = Dataset(lambda: calls.append(1) or ds)
    back = pickle.loads(pickle.dumps(lazy))
    assert calls == [1]
    _assert_same_dataset(back, ds)
    assert "_lazy_thunk" not in back.__dict__


def test_lazy_bad_thunk_and_bad_arguments():
    with pytest.raises(TypeError, match="expected Dataset"):
        Dataset(lambda: "not a dataset").item_count
    with pytest.raises(TypeError):
        Dataset(None, {})


def test_split_keeps_entity_attributes(pair):
    jds, ds = pair
    mask = np.random.default_rng(4).random(ds.interaction_count) < 0.2
    got, want = split_dataset_by_mask(ds, mask), jax_split_by_mask(jds, mask)
    _assert_same_dataset(got.train, want.train)
    assert got.train.entities("item").attribute_names == ["category", "tags", "embedding"]


def test_vocabulary_accessors():
    rng = np.random.default_rng(2)
    ids = rng.choice(1000, 50, replace=False)
    for reorder in (True, False):
        v, jv = Vocabulary(ids, "item", reorder=reorder), JaxVocabulary(ids, "item", reorder=reorder)
        pd.testing.assert_index_equal(v.index, jv.index)
        assert (int(ids[3]) in v, 5000 in v) == (int(ids[3]) in jv, 5000 in jv) == (True, False)
        np.testing.assert_array_equal(v.terms(), jv.terms())
        np.testing.assert_array_equal(v.terms([4, 1]), jv.terms([4, 1]))
        more = [int(ids[0]), 2000, 1500, 2000]
        np.testing.assert_array_equal(v.add_terms(more).ids, jv.add_terms(more).ids)
        assert v.add_terms([int(ids[1])]) is v


def test_csr_row_values_and_fields(pair):
    jds, ds = pair
    csr, jcsr = ds.interaction_matrix().csr("rating"), jds.interaction_matrix().csr("rating")
    for r in (0, 5, csr.nrows - 1):
        np.testing.assert_array_equal(csr.row_values(r), jcsr.row_values(r))
        np.testing.assert_array_equal(csr.row_field(r, "timestamp"), jcsr.row_field(r, "timestamp"))
    assert csr.row_field(0, "missing") is None
    assert CSR(csr.rowptr, csr.colind, None, csr.shape).row_values(0) is None


def test_mtarray_conversions():
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    for src in (data, torch.from_numpy(data.copy())):
        a, ja = MTArray(src), JaxMTArray(src)
        assert a.shape == ja.shape and len(a) == len(ja) == 3
        np.testing.assert_array_equal(a.numpy(), ja.numpy())
        t = a.torch()
        assert t.device.type == "cpu" and torch.equal(t, ja.torch())
        assert a.to("numpy") is a.numpy()
    flat = MTArray(np.arange(5))
    assert flat.arrow().equals(JaxMTArray(np.arange(5)).arrow())
    np.testing.assert_array_equal(MTArray(flat.arrow()).numpy(), np.arange(5))
    with pytest.raises(NotImplementedError, match="imports no JAX"):
        flat.jax()


def test_query_item_source_exported():
    assert QueryItemSource == JaxQueryItemSource
