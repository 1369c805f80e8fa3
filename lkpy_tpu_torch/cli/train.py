"""``lkpy-tpu-torch train`` (port of ``lkpy_tpu/cli/train.py``; reference:
src/lenskit/cli/train.py:23).  It trains on the group's ``--device``, the
card unless ``cpu``."""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path

import click

from lkpy_tpu_torch._device import resolve_device
from lkpy_tpu_torch.cli.common import load_dataset, parse_params, resolve_model
from lkpy_tpu_torch.logging import Task, get_logger
from lkpy_tpu_torch.pipeline import Pipeline, topn_pipeline
from lkpy_tpu_torch.training import TrainingOptions

_log = get_logger(__name__)


@click.command("train")
@click.option("-m", "--model", "model_spec", help="model name or module:Class path")
@click.option("-c", "--config", "config_file", type=click.Path(exists=True), help="pipeline config (JSON/TOML/YAML)")
@click.option("-p", "--param", "params", multiple=True, help="model config parameter NAME=VALUE")
@click.option("-o", "--output", type=click.Path(), required=True, help="output model file (.pkl[.gz])")
@click.option("-n", "--list-length", type=int, default=None, help="default recommendation list length")
@click.option("--rng-seed", type=int, default=None)
@click.option("--ratings", "predicts_ratings", is_flag=True, help="include a rating predictor")
@click.argument("data", type=click.Path(exists=True))
@click.pass_obj
def train(obj, model_spec, config_file, params, output, list_length, rng_seed, predicts_ratings, data):
    """Train a pipeline on DATA and pickle it (reference: cli/train.py)."""
    device = resolve_device(obj.get("device"))
    ds = load_dataset(data)
    if config_file:
        from lkpy_tpu_torch.pipeline.config import PipelineConfig
        from lkpy_tpu_torch.schemas import load_model_data

        pipe = Pipeline.from_config(load_model_data(config_file, PipelineConfig))
    elif model_spec:
        scorer = resolve_model(model_spec, parse_params(params))
        pipe = topn_pipeline(scorer, n=list_length, predicts_ratings=predicts_ratings, name=model_spec)
    else:
        raise click.UsageError("either --model or --config is required")

    with Task(f"train {pipe.name or 'pipeline'}") as task:
        pipe.train(ds, TrainingOptions(rng=rng_seed, device=device))
    _log.info("training finished", time=task.duration)

    out = Path(output)
    # gzip's fastest level: the pipeline holds its training data (about 27
    # bytes an interaction), which the default level 9 compresses 12x slower
    # for a file 9 % smaller
    with gzip.open(out, "wb", compresslevel=1) if out.suffix == ".gz" else open(out, "wb") as f:
        pickle.dump(pipe, f)
    click.echo(f"trained pipeline saved to {out}")
