"""The port's MovieLens loaders and dict flattening against the JAX package.

No MovieLens data ships with the repository, so :func:`write_movielens`
writes a small set in each layout that ``load_movielens_df`` reads (the
ml-latest CSVs, ML-1M's ``::`` files, ML-100K's ``u.data``/``u.item``),
from a numpy seed, into a directory or a zip with one top-level folder.
Both packages load the same files; the datasets must be equal: interaction
tables, vocabularies and the ``title`` and ``genres`` item attributes.
"""

import zipfile
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from lkpy_tpu.data import flatten_dict as jax_flatten
from lkpy_tpu.data import load_movielens as jax_load
from lkpy_tpu.data import load_movielens_df as jax_load_df
from lkpy_tpu.data import unflatten_dict as jax_unflatten
from lkpy_tpu_torch.data import flatten_dict, load_movielens, load_movielens_df, unflatten_dict

LAYOUTS = ("latest", "1m", "100k")
GENRES = ["Action", "Comedy", "Drama", "Horror", "Romance", "Sci-Fi"]


def write_movielens(root: Path, layout: str = "latest", *, seed: int = 0, n_users: int = 40, n_items: int = 60, nnz: int = 500) -> Path:
    """A small MovieLens set of ``layout`` under ``root``; movies that no one
    rated are listed too, so the item vocabulary is the movie list."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    item_ids = np.sort(rng.choice(np.arange(1, 10 * n_items), size=n_items, replace=False))
    keys = rng.choice(n_users * (n_items - 5), size=nnz, replace=False)
    users = keys // (n_items - 5) + 1
    items = item_ids[keys % (n_items - 5)]
    ratings = rng.integers(1, 11, nnz) / 2.0 if layout == "latest" else rng.integers(1, 6, nnz).astype(float)
    stamps = rng.integers(9e8, 1.6e9, nnz)
    titles = [f"Movie {i} ({1950 + i % 70})" for i in item_ids]
    genres = ["|".join(sorted(rng.choice(GENRES, size=rng.integers(1, 4), replace=False))) for _ in item_ids]
    if layout == "latest":
        pd.DataFrame({"userId": users, "movieId": items, "rating": ratings, "timestamp": stamps}).to_csv(root / "ratings.csv", index=False)
        pd.DataFrame({"movieId": item_ids, "title": titles, "genres": genres}).to_csv(root / "movies.csv", index=False)
    elif layout == "1m":
        lines = [f"{u}::{i}::{int(r)}::{t}" for u, i, r, t in zip(users, items, ratings, stamps)]
        (root / "ratings.dat").write_text("\n".join(lines) + "\n")
        movies = [f"{i}::{t}::{g}" for i, t, g in zip(item_ids, titles, genres)]
        (root / "movies.dat").write_text("\n".join(movies) + "\n", encoding="latin1")
    elif layout == "100k":
        lines = [f"{u}\t{i}\t{int(r)}\t{t}" for u, i, r, t in zip(users, items, ratings, stamps)]
        (root / "u.data").write_text("\n".join(lines) + "\n")
        movies = [f"{i}|{t}|01-Jan-1995||http://x|0|1|0" for i, t in zip(item_ids, titles)]
        (root / "u.item").write_text("\n".join(movies) + "\n", encoding="latin1")
    else:
        raise ValueError(layout)
    return root


def zipped(src: Path, dst: Path) -> Path:
    """``src``'s files in a zip under one top-level folder, as GroupLens ships them."""
    with zipfile.ZipFile(dst, "w") as zf:
        zf.writestr(f"{src.name}/", "")
        for f in sorted(src.iterdir()):
            zf.write(f, f"{src.name}/{f.name}")
    return dst


def _same_attr(got, want):
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


@pytest.mark.parametrize("container", ["dir", "zip"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_movielens_equals_jax(tmp_path, layout, container):
    path = write_movielens(tmp_path / f"ml-{layout}", layout, seed=len(layout))
    if container == "zip":
        path = zipped(path, tmp_path / f"ml-{layout}.zip")
    got, want = load_movielens(path), jax_load(path)
    _assert_same_dataset(got, want)
    items = got.entities("item")
    assert "title" in items.attribute_names
    assert ("genres" in items.attribute_names) == (layout != "100k")
    # every listed movie is an entity, rated or not
    assert got.item_count == 60 and got.interaction_count == 500
    pd.testing.assert_frame_equal(load_movielens_df(path), jax_load_df(path))


def test_load_movielens_genres_are_lists(tmp_path):
    path = write_movielens(tmp_path / "ml", "latest", seed=3)
    ds = load_movielens(path)
    movies = pd.read_csv(path / "movies.csv").set_index("movieId")
    genres = ds.entities("item").attribute("genres").to_numpy()
    for iid, g in zip(ds.entities("item").ids(), genres):
        assert list(g) == movies.loc[iid, "genres"].split("|")


def test_load_movielens_unknown_layout(tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "README.txt").write_text("nothing here")
    with pytest.raises(FileNotFoundError):
        load_movielens_df(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_movielens_df(tmp_path / "ratings.tsv")


@pytest.mark.parametrize(
    "nested",
    [
        {},
        {"a": 1},
        {"regularization": {"user": 0.1, "item": 0.2}, "embedding_size": 64},
        {"a": {"b": {"c": [1, 2]}, "d": "x"}, "e": None},
    ],
)
def test_flatten_round_trip(nested):
    flat = flatten_dict(nested)
    assert flat == jax_flatten(nested)
    assert unflatten_dict(flat) == nested == jax_unflatten(flat)
    assert all(not isinstance(v, dict) for v in flat.values())


def test_unflatten_dotted_keys_and_separator():
    flat = {"regularization.user": 0.5, "regularization.item": 0.25, "weight": 40}
    assert unflatten_dict(flat) == jax_unflatten(flat) == {"regularization": {"user": 0.5, "item": 0.25}, "weight": 40}
    assert unflatten_dict({"a/b": 1}, sep="/") == jax_unflatten({"a/b": 1}, sep="/") == {"a": {"b": 1}}
