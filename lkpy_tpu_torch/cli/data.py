"""``lkpy-tpu-torch data`` subcommands (port of ``lkpy_tpu/cli/data.py``;
reference: src/lenskit/cli/data/)."""

from __future__ import annotations

from pathlib import Path

import click

from lkpy_tpu_torch.cli.common import load_dataset
from lkpy_tpu_torch.logging import get_logger

_log = get_logger(__name__)


@click.group("data")
def data():
    """Dataset management commands."""


@data.command("convert")
@click.option("--movielens", "fmt", flag_value="movielens", default=True)
@click.argument("src", type=click.Path(exists=True))
@click.argument("dst", type=click.Path())
def convert(fmt, src, dst):
    """Convert a source dataset to native format (reference: cli/data/convert.py)."""
    from lkpy_tpu_torch.data import load_movielens

    ds = load_movielens(src)
    ds.save(dst)
    click.echo(f"converted {src} -> {dst} ({ds.interaction_count} interactions)")


@data.command("describe")
@click.argument("path", type=click.Path(exists=True))
def describe(path):
    """Describe a dataset (reference: cli/data/describe.py)."""
    ds = load_dataset(path)
    click.echo(f"dataset: {ds.name or path}")
    click.echo(f"  users: {ds.user_count}")
    click.echo(f"  items: {ds.item_count}")
    click.echo(f"  interactions: {ds.interaction_count}")
    stats = ds.item_stats()["count"]
    click.echo(f"  density: {ds.interaction_count / (ds.user_count * ds.item_count):.4%}")
    click.echo(f"  max item count: {int(stats.max())}, median: {int(stats.median())}")


@data.command("split")
@click.option("--test-frac", type=float, default=0.2, help="per-user holdout fraction")
@click.option("--users", "n_users", type=int, default=None, help="number of test users (default all)")
@click.option("--seed", type=int, default=42)
@click.argument("src", type=click.Path(exists=True))
@click.argument("dst", type=click.Path())
def split(test_frac, n_users, seed, src, dst):
    """Create a train/test split (reference: cli/data/split.py)."""
    from lkpy_tpu_torch.splitting import SampleFrac, sample_users

    ds = load_dataset(src)
    n = n_users or ds.user_count
    tts = sample_users(ds, n, SampleFrac(test_frac, rng=seed), rng=seed)
    out = Path(dst)
    out.mkdir(parents=True, exist_ok=True)
    tts.train.save(out / "train")
    tts.test.save_parquet(out / "test.parquet")
    click.echo(f"split {src}: train={tts.train.interaction_count}, test={tts.test_size}")


@data.command("fetch")
@click.option(
    "--source-dir",
    envvar="LK_DATA_DIR",
    default=None,
    help="local dataset mirror (env LK_DATA_DIR); network fetch is not available in air-gapped deployments",
)
@click.option("--convert/--no-convert", default=False, help="also convert to native format")
@click.argument("name")
@click.argument("dst", type=click.Path(), required=False)
def fetch(source_dir, convert, name, dst):
    """Fetch a named dataset (reference: cli/data/fetch.py).

    The reference downloads from grouplens.org; deployments without egress
    resolve ``NAME`` from a local mirror directory instead (``--source-dir``
    or ``LK_DATA_DIR``).  With ``--convert`` the result is saved in native
    format at DST."""
    import shutil

    candidates = [source_dir] if source_dir else []
    candidates += ["."]
    src = None
    for base in candidates:
        if base and (Path(base) / name).exists():
            src = Path(base) / name
            break
    if src is None:
        raise click.ClickException(
            f"dataset {name!r} not found in local mirrors {candidates}; "
            "network fetch is unavailable (no egress) — place the dataset in "
            "$LK_DATA_DIR and re-run"
        )
    dst = Path(dst or name)
    if convert:
        from lkpy_tpu_torch.data import load_movielens

        ds = load_movielens(src)
        ds.save(dst)
        click.echo(f"fetched {name} -> {dst} (native, {ds.interaction_count} interactions)")
    else:
        if dst.resolve() != src.resolve():
            shutil.copytree(src, dst, dirs_exist_ok=True)
        click.echo(f"fetched {name} -> {dst}")


@data.command("subset")
@click.option("--min-item-count", type=int, default=0)
@click.option("--min-user-count", type=int, default=0)
@click.argument("src", type=click.Path(exists=True))
@click.argument("dst", type=click.Path())
def subset(min_item_count, min_user_count, src, dst):
    """Filter a dataset to denser items/users (reference: cli/data/subset.py)."""
    from lkpy_tpu_torch.data import from_interactions_df

    ds = load_dataset(src)
    df = ds.interaction_table(ids=True)
    if min_item_count:
        counts = df.groupby("item_id")["item_id"].transform("size")
        df = df[counts >= min_item_count]
    if min_user_count:
        counts = df.groupby("user_id")["user_id"].transform("size")
        df = df[counts >= min_user_count]
    sub = from_interactions_df(df.reset_index(drop=True))
    sub.save(dst)
    click.echo(f"subset saved: {sub.user_count} users, {sub.item_count} items, {sub.interaction_count} interactions")
