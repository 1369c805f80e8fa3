"""The port's ``DatasetBuilder`` (``lkpy_tpu_torch.data.builder``) against
the JAX package's on the CPU: the same ratings, made with numpy from a seed,
and the same calls through both builders give equal interaction tables,
vocabularies and entity attributes; scalar, list and vector attributes;
``filter_interactions`` and ``binarize_ratings``; ``save``."""

import numpy as np
import pandas as pd
import pytest
import torch

from lkpy_tpu.data import Dataset as JaxDataset
from lkpy_tpu.data import DatasetBuilder as JaxBuilder
from lkpy_tpu_torch.data import Dataset, DatasetBuilder

torch.set_num_threads(1)


def _ratings(seed=0, n_users=50, n_items=30, nnz=500):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame(
        {
            "user_id": rng.integers(0, n_users, nnz) + 100,
            "item_id": rng.integers(0, n_items, nnz) * 2 + 1,
            "rating": rng.integers(1, 11, nnz) / 2.0,
            "timestamp": rng.integers(0, 1000, nnz),
        }
    )
    return df.drop_duplicates(["user_id", "item_id"]).reset_index(drop=True)


def _both(df=None):
    """The same entities (items in a shuffled order) and ratings in both builders."""
    df = _ratings() if df is None else df
    items = np.random.default_rng(5).permutation(np.unique(df["item_id"]))
    out = []
    for cls in (JaxBuilder, DatasetBuilder):
        b = cls()
        b.add_entities("user", np.unique(df["user_id"]))
        b.add_entities("item", items)
        b.add_interactions("rating", df.copy(), entities=("user", "item"))
        out.append(b)
    return out


def _assert_same(got, want):
    assert got.schema.model_dump() == want.schema.model_dump()
    pd.testing.assert_frame_equal(got.interaction_table(ids=True), want.interaction_table(ids=True))
    for name in want.schema.entities:
        ge, we = got.entities(name), want.entities(name)
        np.testing.assert_array_equal(ge.ids(), we.ids())
        pd.testing.assert_frame_equal(ge.pandas(), we.pandas())


def test_entity_classes():
    jb, b = _both()
    assert b.entity_classes().keys() == jb.entity_classes().keys() == {"user", "item"}
    assert {k: v.model_dump() for k, v in b.entity_classes().items()} == {k: v.model_dump() for k, v in jb.entity_classes().items()}


@pytest.mark.parametrize("kind", ["scalar", "series", "list", "vector", "all"])
def test_attributes_equal(kind):
    rng = np.random.default_rng(3)
    jb, b = _both()
    items = np.unique(_ratings()["item_id"])
    calls = []
    if kind in ("scalar", "all"):
        calls.append(("add_scalar_attribute", ("item", "year", items, rng.integers(1990, 2020, len(items)))))
    if kind in ("series", "all"):
        calls.append(("add_scalar_attribute", ("user", "score", pd.Series(rng.random(7), index=np.arange(100, 107)))))
    if kind in ("list", "all"):
        tagged = items[::2]
        calls.append(("add_list_attribute", ("item", "genres", tagged, [list("abcde"[: rng.integers(1, 5)]) for _ in tagged])))
    if kind in ("vector", "all"):
        calls.append(("add_vector_attribute", ("item", "embed", items[3:], rng.standard_normal((len(items) - 3, 3)).astype(np.float32))))
    for name, args in calls:
        getattr(jb, name)(*args)
        getattr(b, name)(*args)
    jds, ds = jb.build(), b.build()
    _assert_same(ds, jds)
    for name in ("user", "item"):
        je, e = jds.entities(name), ds.entities(name)
        for attr in je.attribute_names:
            g, w = e.attribute(attr).to_numpy(), je.attribute(attr).to_numpy()
            for a, c in zip(g, w):
                if isinstance(c, (list, np.ndarray)):
                    np.testing.assert_array_equal(a, c)
                else:
                    assert (pd.isna(a) and pd.isna(c)) or a == c


@pytest.mark.parametrize(
    "kw",
    [
        dict(min_time=200),
        dict(max_time=700),
        dict(min_time=150, max_time=600),
        dict(remove="pairs"),
    ],
    ids=["min", "max", "window", "remove"],
)
def test_filter_interactions_equal(kw):
    jb, b = _both()
    if kw.get("remove") == "pairs":
        df = _ratings()
        kw = dict(remove=df.iloc[::7][["user_id", "item_id"]].reset_index(drop=True))
    jb.filter_interactions(**kw)
    b.filter_interactions(**kw)
    jds, ds = jb.build(), b.build()
    assert ds.interaction_count < len(_ratings())
    _assert_same(ds, jds)


@pytest.mark.parametrize("method", ["remove", "zero"])
@pytest.mark.parametrize("min_rating", [0.5, 3.0])
def test_binarize_ratings_equal(method, min_rating):
    jb, b = _both()
    jb.binarize_ratings(min_rating=min_rating, method=method)
    b.binarize_ratings(min_rating=min_rating, method=method)
    jds, ds = jb.build(), b.build()
    _assert_same(ds, jds)
    if method == "remove":
        assert "rating" not in ds.interaction_table().columns
    else:
        assert set(np.unique(ds.interaction_table()["rating"])) <= {0.0, 1.0}


def test_builder_save_loads_in_both(tmp_path):
    jb, b = _both()
    for x in (jb, b):
        x.add_scalar_attribute("item", "year", [1, 3, 5], [1999, 2005, 2010])
    b.save(tmp_path / "port")
    jb.save(tmp_path / "jax")
    _assert_same(JaxDataset.load(tmp_path / "port"), jb.build())
    _assert_same(Dataset.load(tmp_path / "jax"), b.build())
    years = Dataset.load(tmp_path / "port").entities("item").attribute("year")
    assert years.iloc[b.build().items.number(3)] == 2005


def test_build_remaps_attributes_to_sorted_numbers():
    _, b = _both()
    b.add_scalar_attribute("item", "code", [5, 1], [50, 10])
    ds = b.build()
    codes = ds.entities("item").attribute("code")
    assert codes.iloc[ds.items.number(5)] == 50 and codes.iloc[ds.items.number(1)] == 10
    assert pd.isna(codes.iloc[ds.items.number(3)])
