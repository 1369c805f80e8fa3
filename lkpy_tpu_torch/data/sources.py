"""
Additional dataset loaders (port of ``lkpy_tpu/data/sources.py``).

Capability parity with reference ``lenskit.data.sources``
(reference: src/lenskit/data/sources/amazon.py, steam.py, msweb.py):
Amazon review ratings (2014/2018/2023 CSV layouts), Steam interactions
(loose-JSON dumps), and the MS Web (Anonymous Microsoft Web Data) DST format.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Literal

import numpy as np
import pandas as pd

from lkpy_tpu_torch.data.builder import DatasetBuilder
from lkpy_tpu_torch.data.collection import ItemListCollection
from lkpy_tpu_torch.data.dataset import Dataset
from lkpy_tpu_torch.data.items import ItemList

__all__ = ["load_amazon_ratings", "load_steam", "load_ms_web"]


def _open_maybe_gz(path: Path, mode="rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load_amazon_ratings(*files: Path | str) -> Dataset:
    """
    Load Amazon ratings CSVs (reference: sources/amazon.py:31).

    Auto-detects the layout: 2014 files are ``user,item,rating,timestamp``,
    2018 are ``item,user,rating,timestamp`` (both headerless), 2023 files
    have a header with ``user_id, parent_asin, rating, timestamp``.
    """
    frames = []
    for f in files:
        f = Path(f)
        with _open_maybe_gz(f) as fp:
            first = fp.readline()
        if "user_id" in first and "parent_asin" in first:  # 2023 layout
            df = pd.read_csv(f, usecols=["user_id", "parent_asin", "rating", "timestamp"])
            df = df.rename(columns={"parent_asin": "item_id"})
            df["timestamp"] = df["timestamp"] / 1000.0  # ms -> s
        else:
            df = pd.read_csv(f, header=None, names=["c0", "c1", "rating", "timestamp"])
            # 2014: user,item; 2018: item,user — detect by ASIN pattern (items
            # are ASINs starting with B or all-digit ISBNs in column 1 for 2014)
            c0_asin = df["c0"].astype(str).str.match(r"^[A-Z0-9]{10}$").mean()
            c1_asin = df["c1"].astype(str).str.match(r"^[A-Z0-9]{10}$").mean()
            if c0_asin > c1_asin:  # 2018 layout: item first
                df = df.rename(columns={"c0": "item_id", "c1": "user_id"})
            else:
                df = df.rename(columns={"c0": "user_id", "c1": "item_id"})
        frames.append(df[["user_id", "item_id", "rating", "timestamp"]])
    all_df = pd.concat(frames, ignore_index=True)
    dsb = DatasetBuilder("amazon")
    dsb.add_interactions("rating", all_df, entities=["user", "item"], missing="insert", default=True)
    return dsb.build()


def load_steam(*files: Path | str, reviews: bool = False) -> Dataset:
    """
    Load Steam data dumps (reference: sources/steam.py:52) — the
    ``australian_users_items.json[.gz]`` loose-JSON format (python-literal
    records, one per line).
    """
    inter_file = None
    for f in files:
        name = Path(f).name
        if name.startswith("australian_users_items.json"):
            inter_file = Path(f)
    if inter_file is None:
        raise FileNotFoundError("need an australian_users_items.json file")

    import ast

    users, items, playtimes, names = [], [], [], {}
    with _open_maybe_gz(inter_file) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            rec = ast.literal_eval(line)
            uid = rec.get("steam_id") or rec.get("user_id")
            for it in rec.get("items", []):
                users.append(uid)
                items.append(it["item_id"])
                playtimes.append(float(it.get("playtime_forever", 0)))
                names.setdefault(it["item_id"], it.get("item_name"))
    df = pd.DataFrame({"user_id": users, "item_id": items, "playtime": playtimes})
    dsb = DatasetBuilder("steam")
    dsb.add_interactions("ownership", df, entities=["user", "item"], missing="insert", default=True)
    item_ids = list(names.keys())
    dsb.add_scalar_attribute("item", "name", np.asarray(item_ids), np.asarray([names[i] for i in item_ids]))
    return dsb.build()


def load_ms_web(path: Path | str, format: Literal["dataset", "collection"] = "dataset"):
    """
    Load the Anonymous Microsoft Web Data DST file
    (reference: sources/msweb.py:35): ``A`` lines define items (vroots),
    ``C`` lines start user cases, ``V`` lines record visits.
    """
    path = Path(path)
    item_titles: dict[int, str] = {}
    item_urls: dict[int, str] = {}
    users: list[int] = []
    items: list[int] = []
    current_case: int | None = None
    with _open_maybe_gz(path) as fp:
        for line in fp:
            parts = [p.strip().strip('"') for p in line.strip().split(",")]
            if not parts or not parts[0]:
                continue
            match parts[0]:
                case "A":
                    iid = int(parts[1])
                    item_titles[iid] = parts[3] if len(parts) > 3 else ""
                    item_urls[iid] = parts[4] if len(parts) > 4 else ""
                case "C":
                    current_case = int(parts[2])
                case "V":
                    if current_case is not None:
                        users.append(current_case)
                        items.append(int(parts[1]))
    df = pd.DataFrame({"user_id": users, "item_id": items})
    if format == "collection":
        ilc = ItemListCollection(["user_id"])
        for uid, grp in df.groupby("user_id", sort=True):
            ilc.add(ItemList(item_ids=grp["item_id"].to_numpy()), uid)
        return ilc
    dsb = DatasetBuilder("ms-web")
    ids = np.asarray(sorted(item_titles.keys()))
    dsb.add_entities("item", ids)
    dsb.add_scalar_attribute("item", "title", ids, np.asarray([item_titles[i] for i in ids]))
    dsb.add_interactions("visit", df, entities=["user", "item"], missing="insert", default=True)
    return dsb.build()
