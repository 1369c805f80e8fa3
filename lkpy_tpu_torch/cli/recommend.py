"""``lkpy-tpu-torch recommend`` (port of ``lkpy_tpu/cli/recommend.py``;
reference: src/lenskit/cli/recommend.py:21).  The pipeline is served where
its unpickled tables lie, as :func:`lkpy_tpu_torch.batch.recommend` does."""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path

import click

from lkpy_tpu_torch import batch as batch_mod
from lkpy_tpu_torch.cli.common import load_dataset
from lkpy_tpu_torch.logging import get_logger

_log = get_logger(__name__)


@click.command("recommend")
@click.option("-m", "--model", "model_file", type=click.Path(exists=True), required=True)
@click.option("-n", "--list-length", type=int, default=10)
@click.option("-o", "--output", type=click.Path(), default=None, help="write recs to Parquet")
@click.option("--data", "data_path", type=click.Path(exists=True), default=None, help="dataset for item titles")
@click.argument("users", nargs=-1)
def recommend(model_file, list_length, output, data_path, users):
    """Recommend for USERS with a trained model (reference: cli/recommend.py)."""
    opener = gzip.open if model_file.endswith(".gz") else open
    with opener(model_file, "rb") as f:
        pipe = pickle.load(f)

    parsed = []
    for u in users:
        try:
            parsed.append(int(u))
        except ValueError:
            parsed.append(u)

    recs = batch_mod.recommend(pipe, parsed, n=list_length)
    titles = None
    if data_path:
        ds = load_dataset(data_path)
        ents = ds.entities("item")
        if "title" in ents.attribute_names:
            titles = dict(zip(ents.vocabulary.ids.tolist(), ents.attribute("title").tolist()))

    for key, il in recs.items():
        click.echo(f"recommendations for user {key.user_id}:")
        df = il.to_df()
        for _, row in df.iterrows():
            label = titles.get(row["item_id"]) if titles else row["item_id"]
            click.echo(f"  {int(row['rank']):3d}. {label} ({row['score']:.3f})")

    if output:
        recs.save_parquet(output)
        click.echo(f"saved recommendations to {output}")
