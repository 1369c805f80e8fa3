"""
MovieLens dataset loaders (port of ``lkpy_tpu/data/movielens.py``).

Capability parity with the reference's movielens source
(reference: src/lenskit/data/sources/movielens.py:34-455): version sniffing
across ML-100K / ML-1M / ML-10M / ML-20M+ / ml-latest layouts, loading
ratings plus movie metadata (title/genres), from a directory or zip file.
"""

from __future__ import annotations

import zipfile
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pandas as pd

from lkpy_tpu_torch.data.builder import DatasetBuilder
from lkpy_tpu_torch.data.dataset import Dataset

__all__ = ["load_movielens", "load_movielens_df"]


@contextmanager
def _open_source(path: Path):
    """(open_fn, names) for a directory or a zip, the zip closed on exit."""
    if path.is_dir():
        names = [p.name for p in path.iterdir()]
        yield (lambda n: open(path / n, "rb")), names
    elif path.suffix == ".zip":
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            # many ML zips have a single top-level dir
            prefix = ""
            tops = {n.split("/")[0] for n in names if "/" in n}
            if len(tops) == 1 and not any("/" not in n for n in names):
                prefix = tops.pop() + "/"
            inner = [n[len(prefix):] for n in names if n.startswith(prefix) and n != prefix]
            yield (lambda n: zf.open(prefix + n)), inner
    else:
        raise FileNotFoundError(f"no MovieLens data at {path}")


def load_movielens_df(path: str | Path) -> pd.DataFrame:
    """Load MovieLens ratings as a DataFrame with canonical columns
    (reference: movielens.py:455)."""
    with _open_source(Path(path)) as (openf, names):
        return _load_ratings(openf, names, path)


def _load_ratings(openf, names, path) -> pd.DataFrame:
    if "u.data" in names:  # ML-100K (reference: movielens.py:97)
        with openf("u.data") as f:
            df = pd.read_csv(
                f, sep="\t", names=["user_id", "item_id", "rating", "timestamp"], dtype={"rating": np.float32}
            )
    elif "ratings.dat" in names:  # ML-1M / ML-10M (reference: movielens.py:186)
        with openf("ratings.dat") as f:
            df = pd.read_csv(
                f,
                sep=":",
                names=["user_id", "_1", "item_id", "_2", "rating", "_3", "timestamp"],
                usecols=[0, 2, 4, 6],
                header=None,
                dtype={"rating": np.float32},
                engine="c",
            )
            df.columns = ["user_id", "item_id", "rating", "timestamp"]
    elif "ratings.csv" in names:  # ML-20M+/ml-latest
        with openf("ratings.csv") as f:
            df = pd.read_csv(f, dtype={"rating": np.float32})
            df = df.rename(columns={"userId": "user_id", "movieId": "item_id"})
    else:
        raise FileNotFoundError(f"unrecognized MovieLens layout at {path}")
    return df


def _load_movies(openf, names) -> pd.DataFrame | None:
    if "movies.csv" in names:
        with openf("movies.csv") as f:
            df = pd.read_csv(f).rename(columns={"movieId": "item_id"})
        return df
    if "movies.dat" in names:
        with openf("movies.dat") as f:
            df = pd.read_csv(
                f, sep=":", names=["item_id", "_1", "title", "_2", "genres"], usecols=[0, 2, 4],
                header=None, encoding="latin1",
            )
            df.columns = ["item_id", "title", "genres"]
        return df
    if "u.item" in names:
        with openf("u.item") as f:
            df = pd.read_csv(f, sep="|", header=None, encoding="latin1", usecols=[0, 1])
            df.columns = ["item_id", "title"]
        return df
    return None


def load_movielens(path: str | Path) -> Dataset:
    """Load a MovieLens dataset (reference: movielens.py:435)."""
    path = Path(path)
    with _open_source(path) as (openf, names):
        ratings = _load_ratings(openf, names, path)
        movies = _load_movies(openf, names)

    dsb = DatasetBuilder(name=path.stem)
    if movies is not None:
        dsb.add_entities("item", movies["item_id"].to_numpy())
    dsb.add_interactions(
        "rating", ratings, entities=["user", "item"], missing="insert", allow_repeats=False, default=True
    )
    if movies is not None:
        if "title" in movies.columns:
            dsb.add_scalar_attribute("item", "title", movies["item_id"].to_numpy(), movies["title"].to_numpy())
        if "genres" in movies.columns:
            dsb.add_list_attribute(
                "item", "genres", movies["item_id"].to_numpy(), [g.split("|") for g in movies["genres"]]
            )
    return dsb.build()
