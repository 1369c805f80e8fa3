"""The port's extra dataset loaders (``lkpy_tpu_torch.data.sources``) against
the JAX package's on files the tests write: Amazon ratings in the 2014,
2018 and 2023 CSV layouts (plain and gzip, one file and two), Steam's
``australian_users_items.json`` in loose Python-literal lines (plain and
gzip), and the MS Web DST file as a dataset and as a collection.  Nothing
is downloaded.  Each dataset must equal the JAX package's: name, schema,
interaction table and entity attributes.
"""

import gzip
from pathlib import Path

import numpy as np
import pytest

from lkpy_tpu.data.sources import load_amazon_ratings as jax_amazon
from lkpy_tpu.data.sources import load_ms_web as jax_ms_web
from lkpy_tpu.data.sources import load_steam as jax_steam
from lkpy_tpu_torch.data import load_amazon_ratings, load_ms_web, load_steam
from tests.test_torch_loaders import _assert_same_dataset


def _write(path: Path, text: str) -> Path:
    if path.suffix == ".gz":
        with gzip.open(path, "wt") as fp:
            fp.write(text)
    else:
        path.write_text(text)
    return path


def _asin(rng) -> str:
    return "B" + "".join(rng.choice(list("0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"), 9))


def _amazon_text(layout: str, seed: int, n: int = 120) -> str:
    rng = np.random.default_rng(seed)
    users = [f"A{u:013d}" for u in rng.integers(0, 30, n)]
    items = [_asin(rng) for _ in range(20)]
    picks = [items[i] for i in rng.integers(0, len(items), n)]
    ratings = rng.integers(1, 6, n).astype(float)
    stamps = rng.integers(1_300_000_000, 1_600_000_000, n)
    if layout == "2023":
        rows = [f"{u},{i},{r},{t * 1000}" for u, i, r, t in zip(users, picks, ratings, stamps)]
        return "user_id,parent_asin,rating,timestamp\n" + "\n".join(rows) + "\n"
    first, second = (users, picks) if layout == "2014" else (picks, users)
    return "\n".join(f"{a},{b},{r},{t}" for a, b, r, t in zip(first, second, ratings, stamps)) + "\n"


@pytest.mark.parametrize("layout", ["2014", "2018", "2023"])
@pytest.mark.parametrize("suffix", [".csv", ".csv.gz"])
def test_amazon_ratings_equal_jax(tmp_path, layout, suffix):
    files = [_write(tmp_path / f"part{k}{suffix}", _amazon_text(layout, seed=k)) for k in range(2)]
    got, want = load_amazon_ratings(*files), jax_amazon(*files)
    _assert_same_dataset(got, want)
    assert got.name == "amazon" and got.interaction_count > 100
    # the user and item columns are told apart by the ASIN pattern
    assert all(str(i).startswith("B") for i in got.items.ids)
    one = load_amazon_ratings(str(files[0]))
    _assert_same_dataset(one, jax_amazon(str(files[0])))
    assert one.interaction_count < got.interaction_count


def _steam_text(seed: int) -> str:
    rng = np.random.default_rng(seed)
    lines = []
    for u in range(12):
        items = [
            {"item_id": str(i), "item_name": f"Game {i}", "playtime_forever": int(rng.integers(0, 500)), "playtime_2weeks": 0}
            for i in rng.choice(40, int(rng.integers(0, 8)), replace=False)
        ]
        key = "steam_id" if u % 3 else "user_id"
        lines.append(repr({key: f"7656119{u:010d}", "items_count": len(items), "items": items}))
        if u == 5:
            lines.append("")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("name", ["australian_users_items.json", "australian_users_items.json.gz"])
def test_steam_equals_jax(tmp_path, name):
    path = _write(tmp_path / name, _steam_text(3))
    other = _write(tmp_path / "steam_games.json", "{}\n")
    got, want = load_steam(other, path), jax_steam(other, path)
    _assert_same_dataset(got, want)
    assert "name" in got.entities("item").attribute_names
    for loader in (load_steam, jax_steam):
        with pytest.raises(FileNotFoundError):
            loader(other)


def _ms_web_text(seed: int) -> str:
    rng = np.random.default_rng(seed)
    lines = ['I,4,"www.microsoft.com","created by getlog.pl"', 'T,1,"VRoot",0,0,"VRoot"']
    vroots = np.arange(1000, 1030)
    for v in vroots:
        lines.append(f'A,{v},1,"Area {v}","/area{v}"')
    for case in range(10001, 10041):
        lines.append(f'C,"{case}",{case}')
        for v in rng.choice(vroots, int(rng.integers(1, 6)), replace=False):
            lines.append(f"V,{v},1")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("name", ["anonymous-msweb.data", "anonymous-msweb.data.gz"])
def test_ms_web_equals_jax(tmp_path, name):
    path = _write(tmp_path / name, _ms_web_text(5))
    got, want = load_ms_web(path), jax_ms_web(path)
    _assert_same_dataset(got, want)
    assert got.item_count == 30 and "title" in got.entities("item").attribute_names
    gc, wc = load_ms_web(path, format="collection"), jax_ms_web(path, format="collection")
    assert len(gc) == len(wc) == 40
    for (gk, gl), (wk, wl) in zip(gc.items(), wc.items()):
        assert gk.user_id == wk.user_id
        np.testing.assert_array_equal(gl.ids(), wl.ids())
